"""Nothing under perfbench/ imports JAX or the JAX package; nothing under
perfbench/reference/ imports the program. Import names are compared by
their top-level name (the part before the first dot), whole."""

import ast
import pathlib

from perfbench import harness

PB = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "spriteworld_tpu"}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_under_perfbench():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = set(_imports(f)) & JAX
        assert not found, f"{f} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((PB / "reference").glob("*.py")):
        names = set(_imports(f))
        assert "spriteworld_torch" not in names, f
        assert names <= {"__future__", "dataclasses", "typing", "numpy",
                         "PIL", "itertools", "perfbench"}, (f, names)


def test_top_level_names_compared_whole(monkeypatch):
    import sys
    import types

    # The port's name begins with the JAX package's; neither it nor a
    # module that merely starts with "jax" counts.
    monkeypatch.setitem(sys.modules, "jaxlike_tool", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spriteworld_tpu.ops",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == ["spriteworld_tpu.ops"]
