"""The port's SPH force kernel against its plain PyTorch version on the
card, at the base_dam scene and at a 262144-particle uniform fill, and
its run-to-run determinism.  Marked ``gpu`` and skipped without a CUDA
device; on the card (tests/conftest.py sets up JAX, which these tests
do not use):

    python -m pytest --noconftest -m gpu tests/test_torch_sph_gpu.py

Tolerance: 1e-5 * max|plain| for sum_w and each dpress component.  The
kernel is built with -fmad=false and follows the plain version's
operations per pair, but sums its candidates one by one where torch
reduces them in another order."""

import numpy as np
import pytest
import torch

from tpufluids_torch import binning, scenes, sph_kernels, state, step
from tpufluids_torch.config import BASE_CONFIG

pytestmark = pytest.mark.gpu

TOL = 1e-5
FILL = 262144


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randomised(st, seed):
    """dens, press and vel drawn from ``seed``: at a scene's first step
    press = 0 and dpress would be 0."""
    n = st.capacity
    rng = np.random.default_rng(seed)
    dev = st.pos.device

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return st.replace(dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))))


def _scene(name, dev):
    if name == "base_dam":
        return scenes.base_dam(BASE_CONFIG, device=dev)
    pos = np.random.default_rng(0).uniform(-0.9, 0.9, (FILL, 3))
    return state.make_state(pos.astype(np.float32), cfg=BASE_CONFIG,
                            device=dev)


@pytest.mark.parametrize("name", ["base_dam", "fill"])
def test_kernel_matches_plain_and_is_deterministic(cuda, name):
    st = _randomised(_scene(name, cuda), 1)
    order, bt = binning.sort_tables(st, BASE_CONFIG)
    before = sph_kernels.base_forces_rowblock.launches
    got = sph_kernels.base_forces_rowblock(st, bt, BASE_CONFIG, order)
    again = sph_kernels.base_forces_rowblock(st, bt, BASE_CONFIG, order)
    want = sph_kernels.base_forces_rowblock_plain(st, bt, BASE_CONFIG, order)
    torch.cuda.synchronize()
    assert sph_kernels.base_forces_rowblock.launches == before + 2
    for g, a, w in zip(got[:2], again[:2], want[:2]):
        assert g.shape == w.shape and g.device == w.device
        assert torch.equal(g, a)
        cols = w.reshape(w.shape[0], -1).T
        for gc, wc in zip(g.reshape(g.shape[0], -1).T, cols):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= TOL * scale
    assert int(got[2]) == 0


def test_fill_steps_are_bitwise_repeatable(cuda):
    runs = []
    for _ in range(2):
        sph_kernels.reset_launches()
        st, m = step.run_python(_scene("fill", cuda), BASE_CONFIG, 3)
        runs.append(st)
        assert sph_kernels.launch_counts("base_forces_rowblock") == {
            "base_forces_rowblock": 3}
        assert int(m.n_alive) == FILL and int(m.bin_overflow) == 0
    for f in ("pos", "vel", "acc", "dens", "press", "delpress"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert bool(torch.isfinite(getattr(runs[0], f)).all()), f
