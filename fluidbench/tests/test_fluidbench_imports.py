"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import types

import pytest

from fluidbench import common

SOURCES = sorted(common.HERE.rglob("*.py"))


def imported(path):
    """The top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(common.HERE)))
def test_no_jax(path):
    assert not imported(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((common.HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not imported(path) & {"tpufluids_torch", "tpufluids"}


def test_whole_top_level_names():
    assert common.forbidden_modules(
        ["tpufluids_torch", "tpufluids_torch.grid.stam", "jaxtyping",
         "numpy"]) == []
    assert common.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "tpufluids.grid"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "tpufluids.grid"]


def test_run_refuses_a_loaded_jax(small_cells, monkeypatch):
    from fluidbench import run
    monkeypatch.setitem(__import__("sys").modules, "jax",
                        types.ModuleType("jax"))
    args = run.parse(["--workload", "stam3d-256.dct", "--seed", "1",
                      "--seconds", "0.01"])
    with pytest.raises(SystemExit) as e:
        run.run(args, "cpu", require=False)
    assert e.value.code not in (0, None)
