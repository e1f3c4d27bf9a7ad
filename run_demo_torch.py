"""Interactive demo CLI on the PyTorch port (counterpart of run_demo.py).

Usage:
  python run_demo_torch.py --config spriteworld_torch.configs.cobra.clustering \\
      --mode train --render_size 256 [--device cpu]

Needs matplotlib and dm_env.
"""

import argparse
import importlib

from spriteworld_torch import demo_ui


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="spriteworld_torch.configs.cobra."
                                       "clustering",
                   help="Module name of task config to use.")
    p.add_argument("--mode", default="train",
                   help="Task mode, 'train' or 'test'.")
    p.add_argument("--task_hsv_colors", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="Whether the config's colors are in HSV space.")
    p.add_argument("--render_size", type=int, default=256,
                   help="Height and width of the output image.")
    # The reference demo's default: the interactive UI renders one frame
    # per user action, so the image matches the reference's.
    p.add_argument("--anti_aliasing", type=int, default=10,
                   help="Renderer anti-aliasing factor.")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cpu' runs the kernels' plain "
                        "versions).")
    args = p.parse_args(argv)
    config = importlib.import_module(args.config).get_config(args.mode)
    demo_ui.setup_run_ui(config, args.render_size, args.task_hsv_colors,
                         args.anti_aliasing, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
