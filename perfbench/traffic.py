"""The one traffic generator: it reads a mix's data file
(`perfbench/traffic/<mix>.json`) and drives the program with the loop that
the mix names, found by name in `perfbench/loops/<loop>.py`.

A loop's file exposes `check(rec, reference, observation, control=False)
-> check.Tally`, which compares the loop's records with a configuration's
reference module, and `Loop(mix, env_kwargs, observation, device, seed,
tracer)`, whose `check` is that function. A `Loop`:

- `setup(seconds)` builds the program and warms up every shape the window
  uses; it returns what it timed of its stages, {name: seconds};
- `window(seconds, trace)` drives the program for `seconds` (with a trace,
  a profiled slice follows the window, so that no timed call runs under
  the profiler) and returns {"attempted", "elapsed", "metrics", "info"};
- `records()` hands what the comparison reads to the host, once the
  window has closed; `free()` frees the program's device memory;
- `trace_context()` gives the profiled slice's {"calls", "steps",
  "lanes"} and, where it has them, "host_step_ms".

A loop records the configuration's `observation`, the key of the program's
observations that the configuration's file names, whatever it holds (an
image, or a dict of arrays). The benchmark's own host code runs in spans of
the `Tracer`. This module also holds what loops share.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from perfbench.devtrace import Tracer

# The EnvState fields that the comparison reads, by the reference's names.
STATE_FIELDS = {"factors": "factors", "num": "num_sprites",
                "step_count": "step_count", "reset_next": "reset_next",
                "key": "key"}


def build(layout, mix: dict, env_kwargs: dict, observation: str, device,
          seed: int, tracer: Optional[Tracer] = None):
    """The mix's loop, built (not set up)."""
    mod = layout.loop(mix["loop"])
    return mod.Loop(mix, env_kwargs, observation, device, int(seed),
                    tracer or Tracer())


def host(tree):
    """Numpy copies of the tensors of a nested dict or list."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def gather(tree, dim: int, index: torch.Tensor):
    """`index_select(dim, index)` of each tensor of a tensor or dict."""
    if isinstance(tree, dict):
        return {k: gather(v, dim, index) for k, v in tree.items()}
    return tree.index_select(dim, index)


def lanes_of(state, index: torch.Tensor) -> dict:
    """The lanes `index` of an EnvState, by the reference's field names."""
    return {k: getattr(state, f).index_select(0, index)
            for k, f in STATE_FIELDS.items()}


def seeded(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator of one stream of the run's seed (any integer)."""
    return np.random.default_rng([seed % 2**64, stream])


def percentile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of `values` by linear interpolation."""
    return float(np.quantile(np.asarray(values, np.float64), q))
