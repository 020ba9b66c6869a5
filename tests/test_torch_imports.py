"""The PyTorch port imports torch and never JAX, flax or the JAX
package (whose __init__ pulls in jax and flax)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpufluids"}
PORT_FILES = sorted((REPO / "tpufluids_torch").rglob("*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"tpufluids_torch/grid/stam.py", "tpufluids_torch/grid/kernels.py",
            "tpufluids_torch/grid/convert.py", "tpufluids_torch/step.py",
            "tpufluids_torch/sph_kernels.py",
            "tpufluids_torch/adapt.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_source_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import tpufluids_torch.grid.stam, tpufluids_torch.grid.kernels\n"
        "import tpufluids_torch.grid.convert, tpufluids_torch.grid.mac\n"
        "import tpufluids_torch.config, tpufluids_torch.kernels\n"
        "import tpufluids_torch.state, tpufluids_torch.convert\n"
        "import tpufluids_torch.binning, tpufluids_torch.forces\n"
        "import tpufluids_torch.integrate, tpufluids_torch.sph_kernels\n"
        "import tpufluids_torch.step, tpufluids_torch.scenes\n"
        "import tpufluids_torch.adapt\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
