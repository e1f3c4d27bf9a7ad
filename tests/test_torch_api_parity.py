"""Every public symbol of the JAX package has its counterpart in the port.

Walks both packages' sources (ASTs, nothing is imported): each module of
`spriteworld_tpu/` has a module of the same path in `spriteworld_torch/`
(`ops/rasterize_pallas.py`: `ops/rasterize_cuda.py`), and each public
top-level function and class, each public method (and `__init__`) and each
of their argument names has its counterpart there. `ALLOWED` lists the
differences that are by design, each with its reason; an entry that no
longer names a difference fails too, so the list stays true.
"""

import ast
import pathlib

import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_JAX = _ROOT / "spriteworld_tpu"
_PORT = _ROOT / "spriteworld_torch"

# JAX module -> the port's module of the same role.
MODULE_MAP = {"ops/rasterize_pallas.py": "ops/rasterize_cuda.py"}

# (module, symbol, argument or None for the symbol) -> why it differs.
# A JAX PRNG key argument is a key of the same name in the port (JAX's
# threefry key contract, `ops.lane_random`), which may also be given as an
# int seed; where the port keys otherwise, its entry says how.
ALLOWED = {
    ("core/environment.py", "Environment.initial_state", "key"):
        "the port's initial_state is batched: it takes the lanes' keys, "
        "`keys` int32[B, 2] (or a lane count B), as reset_batch does",
    ("parallel/runner.py", "ShardedRunner.rollout", "key"):
        "the runner carries its action key (`ShardedRunner.action_key`, "
        "which reset(key) starts at fold_in(key, 1), as JAX's evaluate "
        "keys its rollouts) instead of taking and returning it",
    ("core/environment.py", "BatchedEnvironment.__init__", "sharding"):
        "a jax.sharding.Sharding; the port takes mesh= (parallel.mesh) "
        "plus use_graph=",
    ("parallel/mesh.py", "env_mesh", "devices"):
        "a rank drives one card: env_mesh(device)",
    ("utils/profiling.py", "trace", "create_perfetto_link"):
        "a jax.profiler feature with no torch.profiler counterpart",
    ("ops/rasterize_pallas.py", "render_rgb_batch", "interpret"):
        "Pallas interpret mode; the port's CPU tensors take the kernels' "
        "plain version",
    ("ops/rasterize_pallas.py", "render_rgb_batch", "strip_limit"):
        "a TPU VMEM tuning knob, not part of the output contract",
    ("ops/rasterize_pallas.py", "render_rgb_batch", "unroll_multi"):
        "a TPU tuning knob, not part of the output contract",
    ("ops/rasterize_pallas.py", "render_rgb_batch", "scene_cspan"):
        "a TPU tuning knob (cspan), not part of the output contract",
    ("ops/rasterize_pallas.py", "render_rgb_batch", "scene_group"):
        "a TPU tuning knob (group), not part of the output contract",
    ("core/renderers.py", "ImageRenderer.__init__", "use_pallas"):
        "the port's kernels are its only rasterizer on the card: no flag "
        "sends card tensors to the plain version (a failing kernel raises)",
    ("core/renderers.py", "ImageRenderer._pallas_call", None):
        "the kernel-mode auto-fallback, decided against: a failing kernel "
        "raises (ROADMAP.md Queue 3, 'No fallback on kernel failure')",
}


def _args(fn):
    """Argument names, and "**" where the function forwards any keyword
    (the JAX package's own `rasterize_pallas.render_rgb` does)."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")] + (
        ["**"] if a.kwarg else [])


def _symbols(path: pathlib.Path):
    """{name or Class.method: argument names, or None for a class or a
    class attribute} of a module's top level and its classes."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = _args(sub)
                elif isinstance(sub, ast.Assign):  # e.g. render_batch = render
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            out[f"{node.name}.{t.id}"] = None
        elif isinstance(node, ast.Assign):  # aliases such as PILRenderer
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = None
    return out


def _public(name: str) -> bool:
    return all(not part.startswith("_") or part == "__init__"
               for part in name.split("."))


def _modules():
    return sorted(str(p.relative_to(_JAX)) for p in _JAX.rglob("*.py"))


def _port_module(rel: str) -> pathlib.Path:
    return _PORT / MODULE_MAP.get(rel, rel)


def differences():
    """Every (module, symbol, argument or None) of the JAX package that the
    port lacks, by-design ones included."""
    out = []
    for rel in _modules():
        port = _port_module(rel)
        if not port.exists():
            out.append((rel, None, None))
            continue
        jax_syms, port_syms = _symbols(_JAX / rel), _symbols(port)
        for name, args in jax_syms.items():
            if name not in port_syms:
                out.append((rel, name, None))
            elif (args is not None and port_syms[name] is not None
                  and "**" not in port_syms[name]):
                out += [(rel, name, a) for a in args
                        if a != "**" and a not in port_syms[name]]
    return out


def _by_design(diff) -> bool:
    return diff in ALLOWED


def test_every_public_symbol_has_a_counterpart():
    missing = [d for d in differences()
               if (d[1] is None or _public(d[1])) and not _by_design(d)]
    assert not missing, (
        "symbols or arguments of spriteworld_tpu with no counterpart in "
        f"spriteworld_torch: {missing}")


@pytest.mark.parametrize("entry", sorted(ALLOWED, key=str),
                         ids=lambda e: ":".join(str(x) for x in e))
def test_allowlist_names_a_real_difference(entry):
    """Each allowlisted entry names a symbol of the JAX package that the
    port still lacks, and gives a reason."""
    assert ALLOWED[entry].strip()
    rel, name, arg = entry
    jax_syms = _symbols(_JAX / rel)
    assert name in jax_syms, entry
    if arg is not None:
        assert arg in jax_syms[name], entry
    assert entry in differences(), f"{entry} is no longer a difference"


def test_the_walk_sees_the_packages():
    """The walk finds the modules and symbols it compares, and maps the
    kernel module."""
    mods = _modules()
    assert "ops/rasterize_pallas.py" in mods and "core/renderers.py" in mods
    assert _port_module("ops/rasterize_pallas.py").name == "rasterize_cuda.py"
    syms = _symbols(_JAX / "core/renderers.py")
    assert {"AbstractRenderer.render_batch", "ImageRenderer.render_batch",
            "PILRenderer"} <= set(syms)
    assert "use_pallas" in syms["ImageRenderer.__init__"]
    assert "force" in _symbols(_JAX / "parallel/checkpoint.py")["save_state"]
