"""Example run loop: random agent on a config, batched on the card.

Counterpart of `example_run_loop.py` on the PyTorch port, with argparse and
logging in place of absl. `--num_envs` lanes step in lockstep; per-lane
episode success and nan-mean reward are kept as masked numpy vectors, read
from the device once a step, and one line is logged per finished episode.
`--num_envs 1` reproduces the reference's single-env logging.

Usage:
  python example_run_loop_torch.py \\
      --config spriteworld_torch.configs.cobra.clustering \\
      --mode train --num_episodes 2 --num_envs 64 [--device cpu]
"""

import argparse
import importlib
import logging

import numpy as np

from spriteworld_torch.core import environment
from spriteworld_torch.core import renderers
from spriteworld_torch.utils import device as device_lib

logger = logging.getLogger("example_run_loop_torch")


def run(config="spriteworld_torch.configs.cobra.goal_finding_new_shape",
        mode="train", num_episodes=2, num_envs=16, render_images=False,
        device="cuda"):
    """Step `num_envs` lanes of a random agent until `num_episodes` *
    `num_envs` episodes have ended; log one line per finished episode and
    return them as (lane, success, nan-mean reward) tuples."""
    cfg = importlib.import_module(config).get_config(mode)
    if not render_images:
        cfg["renderers"] = {"success": renderers.Success()}
    else:
        cfg["renderers"]["success"] = renderers.Success()

    env = environment.Environment(**cfg, device=device)
    benv = environment.BatchedEnvironment(env, num_envs)

    state, _ = benv.reset()
    # Per-lane episode accumulators: nan-mean over an episode's rewards is
    # sum-of-finite / count-of-finite, tracked as two [num_envs] vectors.
    ep_reward_sum = np.zeros(num_envs, np.float64)
    ep_reward_cnt = np.zeros(num_envs, np.int64)
    episodes = []
    target = num_episodes * num_envs

    while len(episodes) < target:
        state, ts = benv.step(state, benv.sample_actions())
        host = device_lib.to_host({
            "reward": ts.reward, "step_type": ts.step_type,
            "success": ts.observation["success"]})
        rewards, step_types = host["reward"], host["step_type"]
        # FIRST lanes (after an auto-reset) contribute nothing, like the
        # reference's reset steps.
        counted = (step_types != 0) & ~np.isnan(rewards)
        ep_reward_sum += np.where(counted, rewards, 0.0)
        ep_reward_cnt += counted
        done_lanes = np.nonzero(step_types == 2)[0]  # LAST
        for lane in done_lanes:  # iterates finished episodes only
            mean_r = (ep_reward_sum[lane] / ep_reward_cnt[lane]
                      if ep_reward_cnt[lane] else float("nan"))
            episodes.append((int(lane), bool(host["success"][lane]),
                             float(mean_r)))
            logger.info("Episode done (lane %d). Success = %s, Reward = %s",
                        *episodes[-1])
        ep_reward_sum[done_lanes] = 0.0
        ep_reward_cnt[done_lanes] = 0
    return episodes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config",
                   default="spriteworld_torch.configs.cobra."
                           "goal_finding_new_shape",
                   help="Module name of task config to use.")
    p.add_argument("--mode", default="train", help="'train' or 'test' mode.")
    p.add_argument("--num_episodes", type=int, default=2,
                   help="Number of episodes to run.")
    p.add_argument("--num_envs", type=int, default=16,
                   help="Parallel environment lanes.")
    p.add_argument("--render_images", action="store_true",
                   help="Keep the image renderer.")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cpu' runs the kernels' plain "
                        "versions).")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run(args.config, args.mode, args.num_episodes, args.num_envs,
        args.render_images, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
