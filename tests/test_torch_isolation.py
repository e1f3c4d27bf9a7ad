"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its CUDA entry points refuse to run without a card."""

import pathlib
import re
import subprocess
import sys

import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_SCRIPTS = ("chip_smoke", "bench_torch", "ablate_kernels",
            "example_run_loop_torch", "run_demo_torch", "make_gifs_torch")
_PORT_FILES = sorted(
    [*(_ROOT / "spriteworld_torch").rglob("*.py"),
     *(_ROOT / f"{name}.py" for name in _SCRIPTS)])

_IMPORT_ALL = """
import importlib, pkgutil, sys
import spriteworld_torch
names = [m.name for m in pkgutil.walk_packages(
    spriteworld_torch.__path__, "spriteworld_torch.")]
for name in names:
    importlib.import_module(name)
import ablate_kernels, bench_torch, chip_smoke
import example_run_loop_torch, make_gifs_torch, run_demo_torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "spriteworld_tpu")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=_ROOT, capture_output=True,
        text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 15, out
    assert out[1:] == ["[]"], out


@pytest.mark.parametrize("path", _PORT_FILES, ids=lambda p: p.name)
def test_port_source_names_no_jax_module(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", text,
                         re.M), path
    assert not re.search(r"^\s*(import|from)\s+spriteworld_tpu\b", text,
                         re.M), path
    assert not re.search(r"^\s*(import|from)\s+absl\b", text, re.M), path


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import bench_torch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.build_env(anti_aliasing=5)
    env = bench_torch.build_env(anti_aliasing=5, device="cpu")
    assert env.device.type == "cpu"

    import example_run_loop_torch
    from spriteworld_torch.adapters import dm_env_adapter

    cfg = bench_torch.config_of("cobra.goal_finding_new_shape")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm_env_adapter.Environment(**cfg)
    assert dm_env_adapter.Environment(**cfg, device="cpu")._env.device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example_run_loop_torch.run(num_envs=2)
    assert len(example_run_loop_torch.run(
        num_episodes=1, num_envs=2, device="cpu")) >= 2


_IMPORT_ALL_BUT_DM_ENV_ADAPTER = """
import importlib, pkgutil, sys
import spriteworld_torch
adapter = "spriteworld_torch.adapters.dm_env_adapter"
for m in pkgutil.walk_packages(spriteworld_torch.__path__,
                               "spriteworld_torch."):
    if m.name != adapter:
        importlib.import_module(m.name)
import ablate_kernels, bench_torch, chip_smoke
import example_run_loop_torch, make_gifs_torch, run_demo_torch
print(sorted(m for m in sys.modules if m == adapter or m.split(".")[0] in
             ("dm_env", "gym", "matplotlib", "PIL")))
"""


def test_optional_packages_are_imported_where_they_are_used():
    """dm_env, gym, matplotlib and Pillow load only where the JAX package
    loads them, or later: importing every port module and script but the
    dm_env adapter loads none of them, so the scripts run where dm_env
    and matplotlib are not installed."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL_BUT_DM_ENV_ADAPTER], cwd=_ROOT,
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.split() == ["[]"], out


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
