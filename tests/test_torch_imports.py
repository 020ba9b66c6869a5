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
            "tpufluids_torch/adapt.py", "tpufluids_torch/shard/__init__.py",
            "tpufluids_torch/shard/mesh.py",
            "tpufluids_torch/shard/grid_sharded.py",
            "tpufluids_torch/shard/particles.py",
            "tpufluids_torch/cli.py", "tpufluids_torch/diagnostics.py",
            "tpufluids_torch/io/__init__.py",
            "tpufluids_torch/io/checkpoint.py", "tpufluids_torch/io/vtk.py",
            "tpufluids_torch/io/snapshots.py",
            "tpufluids_torch/io/native/__init__.py"} <= names
    assert (REPO / "tpufluids_torch" / "io" / "native" /
            "vtkwriter.cc").is_file()
    csrc = {p.name for p in (REPO / "tpufluids_torch" / "csrc").iterdir()}
    assert {"grid_common.cuh", "advect.cuh", "advect.cu", "forcing.cuh",
            "forcing.cu", "divgrad.cuh", "divgrad.cu", "jacobi.cuh",
            "jacobi.cu", "jacobi_shard.cu", "step.cu", "grid2d.cu",
            "step2d.cu", "step2d_blocked.cuh", "step_blocked.cuh",
            "stencil_march.cuh",
            "sph_common.cuh", "sph_forces.cu", "sph_unidyn.cu"} <= csrc


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_source_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_chip_smoke_imports_no_jax():
    """The card's smoke run imports the port alone: it runs where JAX is
    not installed."""
    assert not _imported_roots(REPO / "chip_smoke.py") & FORBIDDEN


def test_ab_solves_imports_no_jax():
    """The solves' A/B timing script runs on the card's machine too."""
    assert not _imported_roots(REPO / "ab_solves.py") & FORBIDDEN


def test_ab_sph_imports_no_jax():
    """The SPH kernels' A/B script runs on the card's machine too."""
    assert not _imported_roots(REPO / "ab_sph.py") & FORBIDDEN


GPU_TEST_FILES = sorted(
    [*(REPO / "tests").glob("test_torch_*gpu.py"),
     *(REPO / "tests").glob("torch_*_inputs.py"),
     REPO / "tests" / "torch_shard_workers.py"])


@pytest.mark.parametrize("path", GPU_TEST_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_gpu_test_files_import_no_jax(path):
    """The GPU tests and the helpers they import run on the card's
    machine, where JAX is not installed."""
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
        "import tpufluids_torch.adapt, tpufluids_torch.shard\n"
        "import tpufluids_torch.shard.particles\n"
        "import tpufluids_torch.cli, tpufluids_torch.diagnostics\n"
        "import tpufluids_torch.io.checkpoint, tpufluids_torch.io.vtk\n"
        "import tpufluids_torch.io.native, tpufluids_torch.io.snapshots\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_surface_builds_nothing_on_import():
    """``import tpufluids_torch`` exports the JAX package's names and
    imports no triton and builds no kernel library (lazy builds)."""
    code = (
        "import sys\n"
        "import tpufluids_torch as t\n"
        "import tpufluids_torch.cli, tpufluids_torch.io.native\n"
        "from tpufluids_torch import _build\n"
        "from tpufluids_torch.io import native\n"
        "assert t.__version__ == '0.1.0'\n"
        "assert t.SPHConfig and t.BASE_CONFIG and t.UNIDYN_CONFIG\n"
        "assert t.ParticleState.__name__ == 'ParticleState'\n"
        "assert 'triton' not in sys.modules\n"
        "assert _build.build.cache_info().currsize == 0\n"
        "assert native._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
