"""The port's CUDA kernels against their plain PyTorch versions on the
card, at 64^3 and at the main path's 256^3 (the 2D kernels at 15^2 to
4096^2 fields, the bfloat16 solves at 15^3 to 130^3 and the whole solve
at 15^3 to 128^3), and the
steps' launch counts and final residual.  Marked ``gpu`` and skipped without a CUDA device;
on the card (tests/conftest.py sets up JAX, which these tests do not
use):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernels are built with -fmad=false, so they round like their plain
versions: advection and forcing (the x-march kernels, also at 63^3 and
100^3) equal theirs bit for bit; the other tolerances (relative to
max|plain output|) are those of the JAX package's Pallas tests: 1e-6
for divergence and gradient subtraction, 1e-5 for whole steps.  The
whole tier (one cooperative launch) must equal the streamed kernels bit
for bit, and the dense solves, the multi-field diffusion, the fused
projection, the 2D kernels, the bfloat16 solves and the whole solve
their plain versions."""

import numpy as np
import pytest
import torch

from tpufluids_torch.grid import kernels, stam

pytestmark = pytest.mark.gpu

SIZES = [64, 256]
# the x-march kernels also at sizes that no tile or segment divides
STENCIL_SIZES = [63, 64, 100, 256]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(dev, n, seed, bnds, lo, hi):
    rng = np.random.default_rng(seed)
    return [stam.set_bnd3d(b, torch.from_numpy(
        rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)).to(dev))
        for b in bnds]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device == w.device
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * scale


def _equal(got, want):
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def _bench(n, **kw):
    return stam.StamConfig(**{**dict(
        n=n, dt=0.5 / n, vorticity_eps=2.0, buoyancy_beta=0.5,
        buoyancy_alpha=0.05, advect_mode="stencil", projection="dct",
        dct_precision_first="default"), **kw})


def _seeded(cfg, dev):
    s = stam.make_grid3d(cfg, dev)
    k = cfg.n // 8
    s.dens[3 * k:5 * k, 3 * k:5 * k, 1:k] = 1.0
    s.temp[3 * k:5 * k, 3 * k:5 * k, 1:k] = 3.0
    return s


@pytest.mark.parametrize("n", STENCIL_SIZES)
def test_advect_kernel_matches_plain(cuda, n):
    """Bit for bit: the self-advection (the velocity read from the ring),
    the scalars, one field, and three fields that are not the velocity;
    at sizes the march's tiles and segments divide and do not."""
    dt0 = 0.5
    u, v, w = _fields(cuda, n, 1, (1, 2, 3), -1.2 / dt0, 1.2 / dt0)
    d, t = _fields(cuda, n, 2, (0, 0), 0.0, 1.0)
    before = kernels.advect3d_multi.launches
    cases = (((u, v, w), (1, 2, 3)), ((d, t), (0, 0)), ((d,), (3,)),
             ((d, t, u), (0, 2, 1)))
    for fields, bnds in cases:
        got = kernels.advect3d_multi(fields, bnds, u, v, w, dt0)
        want = kernels.advect3d_multi_plain(fields, bnds, u, v, w, dt0)
        assert _equal(got, want), bnds
    assert kernels.advect3d_multi.launches == before + len(cases)


@pytest.mark.parametrize("coeffs", [
    dict(vorticity_eps=2.0, buoyancy_alpha=0.05, buoyancy_beta=0.5),
    dict(buoyancy_alpha=0.05, buoyancy_beta=0.5, ambient_temp=0.2),
    dict(vorticity_eps=2.0),
], ids=["both", "buoyancy", "vorticity"])
@pytest.mark.parametrize("n", STENCIL_SIZES)
def test_forcing_kernel_matches_plain(cuda, n, coeffs):
    """Bit for bit, one launch a call, in each of the three modes."""
    cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
    u, v, w = _fields(cuda, n, 3, (1, 2, 3), -1.0, 1.0)
    d, t = _fields(cuda, n, 4, (0, 0), 0.0, 1.0)
    before = kernels.launch_counts()
    got = kernels.forcing3d(u, v, w, d, t, cfg)
    after = kernels.launch_counts()
    assert _equal(got, kernels.forcing3d_plain(u, v, w, d, t, cfg))
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"forcing3d": 1}


@pytest.mark.parametrize("kernel", ["advect_march_kernel",
                                    "forcing_march_kernel"])
def test_march_kernels_have_no_stack_frame(cuda, kernel):
    """ptxas's lines for every instance of the two x-march kernels (K 1,
    2, 3 and the self-advection; with and without buoyancy): no stack
    frame, no spill."""
    from tpufluids_torch import _build
    lines = _build.build().log.splitlines()
    at = [i for i, line in enumerate(lines)
          if "Function properties for" in line and kernel in line]
    assert len(at) == {"advect_march_kernel": 4,
                       "forcing_march_kernel": 2}[kernel]
    for i in at:
        assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
            "loads" in lines[i + 1], lines[i:i + 3]


def test_march_shapes_are_the_compiled_ones(cuda):
    """kernels.ADVECT_TILE and FORCING_TILE, which the CPU emulations
    march with, are the shapes the sources compile."""
    shapes = kernels.march_shapes()
    assert shapes["advect3d_multi"][0] == kernels.ADVECT_TILE
    assert shapes["forcing3d"][0] == kernels.FORCING_TILE


@pytest.mark.parametrize("n", SIZES)
def test_div_and_gradsub_kernels_match_plain(cuda, n):
    u, v, w, p = _fields(cuda, n, 5, (1, 2, 3, 0), -1.0, 1.0)
    _close((kernels.div3d(u, v, w),), (kernels.div3d_plain(u, v, w),), 1e-6)
    _close(kernels.gradsub3d(p, u, v, w),
           kernels.gradsub3d_plain(p, u, v, w), 1e-6)


def test_step_launches_residual_and_plain_agreement(cuda, monkeypatch):
    cfg = _bench(64)
    state = _seeded(cfg, cuda)
    kernels.reset_launches()
    out, res = stam.run3d_python(state, cfg, 2)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "advect3d_multi": 4, "forcing3d": 2, "div3d": 4, "gradsub3d": 4,
        "lin_solve3d": 0, "lin_solve3d_rb": 0, "lin_solve3d_rb_shard": 0,
        "lin_solve3d_bf16": 0, "lin_solve3d_rb_bf16": 0,
        "lin_solve3d_whole": 0, "diffuse3d_multi": 0, "project3d_whole": 0,
        "step3d_whole": 0,
        "lin_solve2d": 0, "step2d_whole": 0}
    # the final solve runs TF32-free: the residual stays at float32 level
    assert float(res[0]) <= 1e-8
    for name in ("advect3d_multi", "forcing3d", "div3d", "gradsub3d"):
        monkeypatch.setattr(kernels, name, getattr(kernels, name + "_plain"))
    ref, ref_res = stam.run3d_python(state, cfg, 2)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(out, f),), (getattr(ref, f),), 1e-5)
        assert bool(torch.isfinite(getattr(out, f)).all())


def test_card_matches_cpu_over_four_steps(cuda):
    # first solve at "highest": its TF32 tier is the one intended
    # difference between the card and the CPU
    cfg = _bench(16, dct_precision_first="highest")
    gpu, _ = stam.run3d_python(_seeded(cfg, cuda), cfg, 4)
    cpu, _ = stam.run3d_python(_seeded(cfg, "cpu"), cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)


def _raw(dev, n, seed, count):
    """Random fields whose ghosts are not set_bnd-consistent: the solves
    read the stored ghosts on their first sweep."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)).to(dev) for _ in range(count)]


# (n, red_black): the Jacobi solve at 15^3-131^3 (n + 2 odd and even;
# at 131 a tile other than the first ends in the last slot before the
# face); the red-black solve from n = 4 (multigrid's coarsest) up, odd
# n, n below the kernel's tile and n not a multiple of it, the main
# path's 256, and the last tile ending inside a slot (two cells of a
# colour, four z cells; 77: its last slot holds one cell of the tile) or
# at its end (100); red-black on both sides of kernels.RB_SMALL_N (64,
# 65), where the float32 shape changes, and 33 (the small shape's last
# tile one cell wide)
SOLVE_CASES = ([(n, False) for n in (15, 16, 64, 131)]
               + [(n, True) for n in (4, 7, 8, 15, 16, 33, 64, 65, 77, 100,
                                      130, 256)])


@pytest.mark.parametrize("n,red_black", SOLVE_CASES,
                         ids=[f"{'rb' if rb else 'jacobi'}-{n}"
                              for n, rb in SOLVE_CASES])
def test_solve_kernels_match_plain(cuda, n, red_black):
    """Every b, pressure and diffusion coefficients, zero, consistent
    and raw initial guesses; odd n puts both parities on each face.  Bit
    for bit at 1, 2, 3, 5 and 20 iterations: passes of every length the
    blocked kernels run (the Jacobi solve's last pass of one sweep at an
    odd count)."""
    kern = kernels.lin_solve3d_rb if red_black else kernels.lin_solve3d
    plain = (kernels.lin_solve3d_rb_plain if red_black
             else kernels.lin_solve3d_plain)
    x, x0 = _raw(cuda, n, 6, 2)
    a = 0.05 * 1e-5 * n * n
    for iters in (1, 2, 3, 5, 20):
        for b in range(4):
            for guess in (None, stam.set_bnd3d(b, x), x):
                for coeffs in ((1.0, 6.0), (a, 1 + 6 * a)):
                    got = kern(b, guess, x0, *coeffs, iters)
                    want = plain(b, guess, x0, *coeffs, iters)
                    assert torch.equal(got, want), (iters, b, coeffs)


@pytest.mark.parametrize("n", [15, 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rb_passes_of_every_length_are_bitwise_plain(cuda, n, dtype):
    """Each half-sweep count the blocked red-black kernel is compiled for
    (1 to k), in passes that add up to two iterations, then the ghost
    pass: bit for bit against the plain solve, every b, a raw guess."""
    from tpufluids_torch import _build
    x, x0 = _raw(cuda, n, 47, 2)
    k = kernels.rb_tile(dtype, n).k
    splits = [(1, 3), (3, 1), (2, 2), (4,), (1, 1, 1, 1), (1, 2, 1)]
    assert {h for s in splits for h in s} == set(range(1, k + 1))
    for b in range(4):
        if dtype == torch.bfloat16:
            xs, x0s, a, c_inv = kernels._bf16_operands(x, x0, 1.0, 6.0)
            want = kernels.lin_solve3d_rb_bf16_plain(b, x, x0, 1.0, 6.0, 2)
        else:
            xs, x0s, a, c_inv = x, x0, 1.0, 1.0 / 6.0
            want = kernels.lin_solve3d_rb_plain(b, x, x0, 1.0, 6.0, 2)
        chunks = kernels._rb_chunks_on(x0s, 0)
        for split in splits:
            src, done = xs, 0
            for h in split:
                dst = torch.empty_like(x0s)
                kernels._rb_pass(src, x0s, dst, 0, chunks,
                                 kernels.RbPass(h, done % 2, done == 0), b,
                                 a, c_inv)
                src, done = dst, done + h
            _build.launch("tf_rb_ghosts", src, n, b,
                          int(dtype == torch.bfloat16))
            assert torch.equal(src.float(), want), (b, split)


@pytest.mark.parametrize("n", [15, 16, 131])
def test_jacobi_probe_shapes_are_bitwise_plain(cuda, n):
    """Every float32 shape of the blocked Jacobi kernel's probe (sweeps a
    pass 1 to 4, tiles, threads) against the plain solve, bit for bit, at
    1, 3 and 7 sweeps, every b, raw and zero guesses; at n 15, 16 (n + 2
    odd and even) and 131 (a middle tile of 64 ending in the last slot
    before the face); the shipped one is kernels.JACOBI_TILE."""
    shapes = kernels.jacobi_probe_shapes(torch.cuda.current_device())
    assert [s.tile for s in shapes if s.shipped] == [kernels.JACOBI_TILE]
    assert sorted({s.tile.k for s in shapes}) == [1, 2, 3, 4]
    x, x0 = _raw(cuda, n, 46, 2)
    for shape in shapes:
        for iters in (1, 3, 7):
            for b in range(4):
                for guess in (None, x):
                    got = kernels.lin_solve3d_probe(shape, b, guess, x0,
                                                    0.3, 2.8, iters)
                    want = kernels.lin_solve3d_plain(b, guess, x0, 0.3, 2.8,
                                                     iters)
                    assert torch.equal(got, want), (shape, iters, b)


@pytest.mark.parametrize("n", [16, 64, 93, 99])
def test_whole_tier_matches_plain_and_streamed(cuda, n):
    """The diffusion and the fused projection in both modes, bit for bit
    against their plain versions and the streamed kernels; at 93^3 and
    99^3 (the gate's edge) the fused projection's Jacobi plan takes 2
    sweeps a pass."""
    u, v, w = _fields(cuda, n, 7, (1, 2, 3), -1.0, 1.0)
    a = 0.05 * 1e-5 * n * n
    params = ((1, a, 1 + 6 * a), (2, 2 * a, 1 + 12 * a), (0, a, 1 + 6 * a))
    got = kernels.diffuse3d_multi((u, v, w), params, 20)
    assert _equal(got, kernels.diffuse3d_multi_plain((u, v, w), params, 20))
    for g, q, (b, a_, c) in zip(got, (u, v, w), params):
        assert torch.equal(g, kernels.lin_solve3d(b, q, q, a_, c, 20))
    for red_black in (False, True):
        got = kernels.project3d_whole(u, v, w, 20, red_black)
        assert _equal(got, kernels.project3d_whole_plain(u, v, w, 20,
                                                         red_black))
        solve = kernels.lin_solve3d_rb if red_black else kernels.lin_solve3d
        div = kernels.div3d(u, v, w)
        streamed = kernels.gradsub3d(solve(0, None, div, 1.0, 6.0, 20), u,
                                     v, w)
        for g, r in zip(got, streamed):
            assert torch.equal(g, r)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [15, 48])
def test_diffusion_is_bitwise_plain(cuda, n, k):
    """The multi-field diffusion of 1 to 3 fields, whose ghosts set_bnd
    would change, bit for bit against its plain version at 1, 7 and 20
    sweeps, on the card's plan and on one of few blocks (several (field,
    tile) pairs a block, x0 reloaded every pass); one launch a call."""
    xs = _raw(cuda, n, 47 + k, k)
    params = ((1, 0.3, 2.8), (2, 0.2, 2.3), (0, 0.4, 3.5))[:k]
    blocks, smem = kernels.solve_info(torch.cuda.current_device())
    plan = kernels.diffuse_plan(n, k, blocks, smem)
    tile = kernels.StepTile(-(-n // 3), -(-n // 3), -(-n // 2), plan.levels)
    few = kernels.SolvePlan(3, plan.threads, 12 * tile.box_cells(n),
                            plan.levels, tile)
    assert k * tile.count(n) > few.blocks and few.smem <= smem
    for iters in (1, 7, 20):
        want = kernels.diffuse3d_multi_plain(xs, params, iters)
        before = kernels.diffuse3d_multi.launches
        assert _equal(kernels.diffuse3d_multi(xs, params, iters), want)
        assert kernels.diffuse3d_multi.launches == before + 1
        assert _equal(kernels._diffuse_launch(xs, params, iters, few), want)


def test_float32_jacobi_solve_launches(cuda, monkeypatch):
    """Device launches a float32 Jacobi solve: ceil(iters / k) blocked
    passes of csrc/jacobi_blocked.cu, nothing else."""
    from tpufluids_torch import _build
    entries = []
    launch = _build.launch
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: (entries.append(name),
                                          launch(name, *a))[1])
    x0 = _raw(cuda, 48, 48, 1)[0]
    k = kernels.JACOBI_TILE.k
    for iters in (1, 20, 21):
        entries.clear()
        kernels.lin_solve3d(0, None, x0, 1.0, 6.0, iters)
        assert entries == ["tf_jacobi_blocked_pass"] * -(-iters // k)


@pytest.mark.parametrize("n", [15, 48])
def test_reciprocal_h_kernels_are_bitwise_plain(cuda, n):
    """The kernels that difference by h take 1/h from Python, as PyTorch
    on the card divides by h (test_scalar_division_rounds_as_the_2d_kernel_
    takes_it): bit for bit against their plain versions where n is not a
    power of two (48^3 is inside the whole tier's gate)."""
    u, v, w, p = _fields(cuda, n, 30, (1, 2, 3, 0), -1.0, 1.0)
    d, t = _fields(cuda, n, 31, (0, 0), 0.0, 1.0)
    for coeffs in (dict(vorticity_eps=2.0, buoyancy_alpha=0.05,
                        buoyancy_beta=0.5),
                   dict(vorticity_eps=2.0)):
        cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
        for g, r in zip(kernels.forcing3d(u, v, w, d, t, cfg),
                        kernels.forcing3d_plain(u, v, w, d, t, cfg)):
            assert torch.equal(g, r), coeffs
    for g, r in zip(kernels.gradsub3d(p, u, v, w),
                    kernels.gradsub3d_plain(p, u, v, w)):
        assert torch.equal(g, r)
    for red_black in (False, True):
        for g, r in zip(kernels.project3d_whole(u, v, w, 20, red_black),
                        kernels.project3d_whole_plain(u, v, w, 20,
                                                      red_black)):
            assert torch.equal(g, r), red_black
    for cfg in (_config(n, True), _config(n, True).replace(red_black=False),
                _config(n, False)):
        got = kernels.step3d_whole(u, v, w, d, t, cfg)
        want = kernels.step3d_whole_plain(u, v, w, d, t, cfg)
        for g, r, f in zip(got, want, FIELDS):
            assert torch.equal(g, r), (cfg.red_black, f)


FIELDS = ("u", "v", "w", "dens", "temp")


def _config(n, plume):
    """BASELINE config 2, or config 4 with ``plume`` (bench.py:323-329)."""
    kw = (dict(buoyancy_alpha=0.05, buoyancy_beta=1.0, vorticity_eps=2.0)
          if plume else {})
    return stam.StamConfig(n=n, dt=0.05, diff=1e-5, visc=1e-5,
                           jacobi_iters=20, red_black=True,
                           advect_mode="stencil", **kw)


def _seeded_plume(cfg, dev):
    """bench.py:330-333 at 64^3, scaled to n."""
    s = stam.make_grid3d(cfg, dev)
    lo, hi, top = 3 * cfg.n // 8, 5 * cfg.n // 8, max(cfg.n // 8, 2) + 1
    s.dens[lo:hi, lo:hi, 1:top] = 1.0
    s.temp[lo:hi, lo:hi, 1:top] = 3.0
    return s


@pytest.mark.parametrize("plume", [False, True], ids=["config2", "config4"])
def test_jacobi_configs_card_match_cpu(cuda, plume):
    cfg = _config(16, plume)
    gpu, gres = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 4)
    cpu, cres = stam.run3d_python(_seeded_plume(cfg, "cpu"), cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)
    assert abs(float(gres[0]) - float(cres[0])) <= 1e-3 * float(cres[0])


@pytest.mark.parametrize("case", [
    dict(plume=False),
    dict(plume=True),
    dict(plume=True, red_black=False),
    dict(plume=True, vorticity_eps=0.0, temp_diff=2e-5),
    dict(plume=True, buoyancy_alpha=0.0, buoyancy_beta=0.0, diff=0.0),
    dict(plume=False, visc=0.0, temp_diff=2e-5),
    # diffusion a neighbour moves by more than an ulp (a = dt visc n^2
    # about 1e-4 above does not), an odd iteration count that neither 4
    # half-sweeps nor 2 sweeps a pass divide
    dict(plume=True, visc=0.03, diff=0.03, temp_diff=0.02, jacobi_iters=7),
    dict(plume=True, red_black=False, visc=0.03, diff=0.03, jacobi_iters=5),
], ids=["config2", "config4", "config4_jacobi", "buoyancy", "vorticity",
        "no_visc", "strong_diffusion", "strong_diffusion_jacobi"])
@pytest.mark.parametrize("n", [15, 16, 17, 63, 64, 78])
def test_whole_step_matches_plain_and_separate_calls(cuda, n, case):
    """The whole step (one cooperative launch, and no other) against its
    plain version, and bit for bit against the separate kernels of
    stam.step3d_multi, on a moving state: at sizes the tiles divide and
    do not, up to the gate's edge (n = 78)."""
    case = dict(case)
    cfg = _config(n, case.pop("plume")).replace(**case)
    u, v, w = _fields(cuda, n, 8, (1, 2, 3), -1.0, 1.0)
    d, t = _fields(cuda, n, 9, (0, 0), 0.0, 1.0)
    before = kernels.launch_counts()
    got = kernels.step3d_whole(u, v, w, d, t, cfg)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"step3d_whole": 1}
    _close(got, kernels.step3d_whole_plain(u, v, w, d, t, cfg), 1e-5)
    multi = stam.step3d_multi(stam.GridState3D(u, v, w, d, t), cfg)
    for g, f in zip(got, ("u", "v", "w", "dens", "temp")):
        assert torch.equal(g, getattr(multi, f)), f


def test_whole_step_kernel_has_no_stack_frame(cuda):
    """ptxas's lines for the whole step's kernel: no stack frame, no
    spill (its 640 threads a block leave 96 registers a thread)."""
    from tpufluids_torch import _build
    lines = _build.build().log.splitlines()
    at = [i for i, line in enumerate(lines)
          if "Function properties for" in line and "step_whole_kernel" in line]
    assert len(at) == 1
    assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" \
        in lines[at[0] + 1]


def test_whole_step_plan_on_the_card(cuda):
    """One persistent block of 640 threads a multiprocessor, and at 64^3
    config 4 runs 30 grid barriers a step."""
    blocks, threads, smem = kernels.step_info(torch.cuda.current_device())
    props = torch.cuda.get_device_properties(0)
    assert blocks == props.multi_processor_count and threads == 640
    cfg = _config(64, True)
    plan = kernels.step_plan(64, cfg, blocks, smem)
    assert plan.smem <= smem
    assert kernels.step_barriers(cfg, plan) == 30


def test_jacobi_step_launches(cuda):
    """Config 4 at 64^3: one whole-step launch a step; the last step
    reports the residual, so it runs the separate kernels: a forcing, two
    whole-tier diffusions, a fused projection, two advections, and the
    streamed final projection (div, red-black solve, gradsub)."""
    cfg = _config(64, True)
    kernels.reset_launches()
    out, res = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "advect3d_multi": 2, "forcing3d": 1, "div3d": 1, "gradsub3d": 1,
        "lin_solve3d": 0, "lin_solve3d_rb": 1, "lin_solve3d_rb_shard": 0,
        "lin_solve3d_bf16": 0, "lin_solve3d_rb_bf16": 0,
        "lin_solve3d_whole": 0, "diffuse3d_multi": 2, "project3d_whole": 1,
        "step3d_whole": 2,
        "lin_solve2d": 0, "step2d_whole": 0}
    assert bool(torch.isfinite(out.w).all()) and 0.0 < float(res[0]) < 1e-2


def test_gather_step_takes_no_whole_step(cuda):
    """A 3D gather config inside the whole step's gate runs the separate
    kernels: no step3d_whole launch, no stencil advection."""
    cfg = _config(16, True).replace(advect_mode="gather")
    kernels.reset_launches()
    gpu, gres = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 3)
    cpu, cres = stam.run3d_python(_seeded_plume(cfg, "cpu"), cfg, 3)
    counts = kernels.launch_counts()
    assert counts["step3d_whole"] == 0 and counts["advect3d_multi"] == 0
    assert counts["forcing3d"] == 3 and counts["diffuse3d_multi"] == 6
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)
    assert abs(float(gres[0]) - float(cres[0])) <= 1e-3 * float(cres[0])


# ---------------------------------------------------------------------------
# the bfloat16 solves and the whole solve: bit for bit against their plain
# versions

BF16 = torch.bfloat16


@pytest.mark.parametrize("n", [15, 48, 130])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_bf16_solve_kernels_are_bitwise_plain(cuda, n, red_black):
    """Every b, zero, set_bnd-consistent and raw guesses, the pressure
    and config 2's diffusion coefficients, 1, 2, 3, 5 and 20 iterations
    (every pass length of both blocked kernels); odd n puts both parities
    on each face, and n + 2 odd and even rows that start on odd and even
    cells; 130 spans several tiles and x-chunks."""
    kern = (kernels.lin_solve3d_rb_bf16 if red_black
            else kernels.lin_solve3d_bf16)
    plain = (kernels.lin_solve3d_rb_bf16_plain if red_black
             else kernels.lin_solve3d_bf16_plain)
    x, x0 = _raw(cuda, n, 40, 2)
    a = 0.05 * 1e-5 * 64 * 64
    before, calls = kern.launches, 0
    for iters in (1, 2, 3, 5, 20):
        for b in range(4):
            for guess in (None, stam.set_bnd3d(b, x), x):
                for coeffs in ((1.0, 6.0), (a, 1 + 6 * a)):
                    got = kern(b, guess, x0, *coeffs, iters)
                    assert got.dtype == torch.float32
                    want = plain(b, guess, x0, *coeffs, iters)
                    assert torch.equal(got, want), (iters, b, coeffs)
                    calls += 1
    assert kern.launches == before + calls


@pytest.mark.parametrize("n", [257])
def test_bf16_jacobi_middle_tile_ending_before_the_face(cuda, n):
    """At n = 257 the bfloat16 Jacobi kernel's middle z-tile (cells 129
    to 256) ends one cell before the face, so its last pair holds a face
    cell: the cell before it must still be written.  1, 2 and 3 sweeps,
    every b, zero and raw guesses, bit for bit."""
    x, x0 = _raw(cuda, n, 49, 2)
    for iters in (1, 2, 3):
        for b in range(4):
            for guess in (None, x):
                got = kernels.lin_solve3d_bf16(b, guess, x0, 1.0, 6.0, iters)
                want = kernels.lin_solve3d_bf16_plain(b, guess, x0, 1.0,
                                                      6.0, iters)
                assert torch.equal(got, want), (iters, b)


@pytest.mark.parametrize("n", [15, 48])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_bf16_solves_keep_negative_zero_and_tiny_values(cuda, n, red_black):
    """x0 with -0, bfloat16 subnormals and tiny normal values, from a zero
    guess and from a guess of the same: the bf16x2 operations round and
    sign as the float32 operation rounded to bfloat16 does."""
    kern = (kernels.lin_solve3d_rb_bf16 if red_black
            else kernels.lin_solve3d_bf16)
    plain = (kernels.lin_solve3d_rb_bf16_plain if red_black
             else kernels.lin_solve3d_bf16_plain)
    rng = np.random.default_rng(44)
    scale = rng.choice(np.float32([0.0, 1e-39, 3e-39, 2.0 ** -126, 1e-37,
                                   1e-30]), (n + 2,) * 3)
    sign = rng.choice(np.float32([-1.0, 1.0]), (n + 2,) * 3)
    x0 = torch.from_numpy(sign * scale).to(cuda)   # -0 where sign < 0
    assert bool(torch.signbit(x0[x0 == 0]).any())
    for iters in (1, 2, 3):
        for b in range(4):
            for guess in (None, x0):
                for coeffs in ((1.0, 6.0), (0.5, 4.0)):
                    got = kern(b, guess, x0, *coeffs, iters)
                    want = plain(b, guess, x0, *coeffs, iters)
                    assert torch.equal(got, want), (iters, b, coeffs)
                    assert torch.equal(torch.signbit(got),
                                       torch.signbit(want))


@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_bf16_solve_launches(cuda, monkeypatch, red_black):
    """Device launches a solve of 20 iterations: ten blocked passes (k 4
    red-black half-sweeps or 2 Jacobi sweeps a pass) and, for red-black,
    the ghost pass; 21 iterations one pass more."""
    from tpufluids_torch import _build
    kern = (kernels.lin_solve3d_rb_bf16 if red_black
            else kernels.lin_solve3d_bf16)
    entries = []
    launch = _build.launch
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: (entries.append(name),
                                          launch(name, *a))[1])
    x0 = _raw(cuda, 48, 45, 1)[0]
    for iters, passes in ((20, 10), (21, 11)):
        entries.clear()
        kern(0, None, x0, 1.0, 6.0, iters)
        pass_entry = ("tf_rb_blocked_pass" if red_black
                      else "tf_jacobi_blocked_pass")
        assert entries == [pass_entry] * passes + (
            ["tf_rb_ghosts"] if red_black else [])


@pytest.mark.parametrize("n", [15, 48])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_whole_solve_is_bitwise_plain_and_streamed(cuda, n, dtype,
                                                   red_black):
    """The whole solve (one cooperative launch) against its plain version
    and against the streamed kernel of its type, bit for bit."""
    streamed = {(torch.float32, False): kernels.lin_solve3d,
                (torch.float32, True): kernels.lin_solve3d_rb,
                (BF16, False): kernels.lin_solve3d_bf16,
                (BF16, True): kernels.lin_solve3d_rb_bf16}[dtype, red_black]
    x, x0 = _raw(cuda, n, 41, 2)
    a = 0.05 * 1e-5 * 64 * 64
    before = kernels.lin_solve3d_whole.launches
    for b in range(4):
        for guess in (None, stam.set_bnd3d(b, x), x):
            for coeffs, iters in (((1.0, 6.0), 20), ((a, 1 + 6 * a), 7)):
                got = kernels.lin_solve3d_whole(b, guess, x0, *coeffs, iters,
                                                red_black, dtype)
                want = kernels.lin_solve3d_whole_plain(
                    b, guess, x0, *coeffs, iters, red_black, dtype)
                assert torch.equal(got, want), (b, coeffs)
                assert torch.equal(got, streamed(b, guess, x0, *coeffs,
                                                 iters)), (b, coeffs)
    assert kernels.lin_solve3d_whole.launches == before + 24


@pytest.mark.parametrize("n,dtype", [(99, torch.float32), (126, BF16)],
                         ids=["f32_99", "bf16_126"])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_whole_solve_at_the_gates_edge(cuda, n, dtype, red_black):
    """The largest n solve_whole_ok admits in each storage type, where the
    boxes take the most shared memory: bit for bit against the plain
    version from a raw guess."""
    field = torch.empty((n + 2,) * 3, device="meta")
    assert kernels.solve_whole_ok(field, dtype)
    x, x0 = _raw(cuda, n, 45, 2)
    for b in (0, 3):
        got = kernels.lin_solve3d_whole(b, x, x0, 1.0, 6.0, 20, red_black,
                                        dtype)
        want = kernels.lin_solve3d_whole_plain(b, x, x0, 1.0, 6.0, 20,
                                               red_black, dtype)
        assert torch.equal(got, want), b


# (n, dtype, red_black, blocks, shared memory bytes): few blocks with
# little shared memory, so that each block takes several tiles a pass and
# reloads its x0 with each
SEVERAL_TILES = [(15, torch.float32, False, 5, 40000),
                 (15, torch.float32, True, 3, 30000),
                 (18, BF16, False, 7, 24000),
                 (18, BF16, True, 4, 16000)]


@pytest.mark.parametrize("n,dtype,red_black,blocks,smem", SEVERAL_TILES,
                         ids=[f"n{c[0]}_{str(c[1])[6:]}_"
                              f"{'rb' if c[2] else 'jacobi'}"
                              for c in SEVERAL_TILES])
def test_whole_solve_with_several_tiles_a_block(cuda, n, dtype, red_black,
                                                blocks, smem):
    """The whole solve's kernel on a plan of fewer blocks than tiles,
    every b, zero, consistent and raw guesses, bit for bit against its
    plain version."""
    x, x0 = _raw(cuda, n, 44, 2)
    card_blocks, card_smem = kernels.solve_info(cuda.index or 0)
    assert blocks < card_blocks and smem <= card_smem
    plan = kernels.solve_plan(n, red_black, dtype, 4 * blocks, smem)
    plan = kernels.SolvePlan(blocks, plan.threads, plan.smem, plan.levels,
                             plan.tile)
    assert plan.tile.count(n) > blocks
    for b in range(4):
        for guess in (None, stam.set_bnd3d(b, x), x):
            for coeffs, iters in (((1.0, 6.0), 9), ((0.3, 2.8), 4)):
                got = kernels._solve_whole_launch(b, guess, x0, *coeffs,
                                                  iters, red_black, dtype,
                                                  plan)
                want = kernels.lin_solve3d_whole_plain(
                    b, guess, x0, *coeffs, iters, red_black, dtype)
                assert torch.equal(got, want), (b, coeffs)


def test_bf16_solve_differs_from_float32_and_rejects_bf16_fields(cuda):
    x, x0 = _raw(cuda, 48, 42, 2)
    f32 = kernels.lin_solve3d_rb(0, None, x0, 1.0, 6.0, 20)
    bf16 = kernels.lin_solve3d_rb_bf16(0, None, x0, 1.0, 6.0, 20)
    assert float((bf16 - f32).abs().max()) > 1e-4 * float(f32.abs().max())
    # the kernels take float32 fields: a bfloat16 one raises
    xb = x.to(BF16)
    for solve in (kernels.lin_solve3d, kernels.lin_solve3d_rb,
                  kernels.lin_solve3d_bf16, kernels.lin_solve3d_rb_bf16):
        with pytest.raises(TypeError):
            solve(0, xb, x0, 1.0, 6.0, 2)
    with pytest.raises(TypeError):
        kernels.div3d(xb, xb, xb)
    with pytest.raises(TypeError):
        kernels.lin_solve3d_whole(0, None, xb, 1.0, 6.0, 2, True, BF16)
    # outside the gate the whole solve raises instead of streaming
    with pytest.raises(ValueError):
        kernels.lin_solve3d_whole(0, None, _raw(cuda, 128, 43, 1)[0], 1.0,
                                  6.0, 2, False, torch.float32)


@pytest.mark.parametrize("case", ["config4_bf16", "config3_multigrid",
                                  "mac_jacobi", "mac_multigrid"])
def test_new_paths_card_match_cpu_over_four_steps(cuda, case):
    """The bfloat16 step, the multigrid projection and the MAC grid at
    16^3, on the card (kernels) against the CPU (plain versions); the
    routes' launches on the card."""
    from tpufluids_torch.grid import mac
    if case.startswith("mac"):
        cfg = stam.StamConfig(n=16, dt=0.05, diff=1e-5, visc=1e-5,
                              buoyancy_alpha=0.05, buoyancy_beta=1.0,
                              projection=case[4:])

        def seeded(dev):
            s = mac.make_mac3d(cfg, dev)
            s.dens[4:8, 4:8, 0:2] = 1.0
            s.temp[4:8, 4:8, 0:2] = 3.0
            return s
        run, fields = mac.run3d_python, ("u", "v", "w", "dens", "temp")
    else:
        if case == "config4_bf16":
            cfg = _config(16, True).replace(solver_dtype="bfloat16")
        else:
            cfg = _bench(16, projection="multigrid", red_black=True)

        def seeded(dev):
            return _seeded_plume(cfg, dev)
        run, fields = stam.run3d_python, FIELDS
    kernels.reset_launches()
    gpu, gres = run(seeded(cuda), cfg, 4)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu, cres = run(seeded("cpu"), cfg, 4)
    for f in fields:
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)
    assert abs(float(gres[0]) - float(cres[0])) <= 1e-3 * float(cres[0])
    # config 4 in bf16: per step two projections and four diffusions, each
    # one whole bf16 solve; multigrid at 16^3: levels 16 and 8, three
    # red-black solves a cycle, two cycles a projection
    want = {"config4_bf16": dict(lin_solve3d_whole=24),
            "config3_multigrid": dict(lin_solve3d_rb=48),
            "mac_jacobi": dict(lin_solve3d_whole=8),
            "mac_multigrid": dict(lin_solve3d_rb=48)}[case]
    for name, c in want.items():
        assert counts[name] == c, counts
    assert counts["step3d_whole"] == counts["project3d_whole"] == 0


# ---------------------------------------------------------------------------
# the 2D kernels: bit for bit against their plain versions


def _fields2d(dev, n, seed, bnds, lo, hi, raw=False):
    rng = np.random.default_rng(seed)
    out = []
    for b in bnds:
        a = torch.from_numpy(rng.uniform(lo, hi, (n + 2,) * 2).astype(
            np.float32)).to(dev)
        out.append(a if raw else stam.set_bnd2d(b, a))
    return out


def test_scalar_division_rounds_as_the_2d_kernel_takes_it(cuda):
    """The plain 2D stages divide by the Python scalar h; PyTorch on the
    card computes that as a product with fl(1 / h), the reciprocal taken
    in double, which is what csrc/grid2d.cu multiplies by.  (On the CPU
    it divides by fl(h); the two meet when n is a power of two.)"""
    x = torch.from_numpy(np.random.default_rng(23).normal(
        0, 1, 1 << 16).astype(np.float32)).to(cuda)
    for n in (13, 14, 128):
        h = 1.0 / n
        assert torch.equal(x / h, x * (1.0 / h))


@pytest.mark.parametrize("n", [13, 14, 128, 198, 1024, 4094])
def test_lin_solve2d_kernel_is_bitwise_plain(cuda, n):
    """Fields of 15^2, 16^2, 130^2, 200^2, 1026^2 and 4096^2 cells (the
    last with more tiles than blocks); every b, zero, consistent and raw
    guesses, pressure and diffusion coefficients, odd and even sweep
    counts."""
    x, x0 = _fields2d(cuda, n, 20, (0, 0), -1.0, 1.0, raw=True)
    a = 0.1 * 1e-5 * n * n
    before = kernels.lin_solve2d.launches
    calls = 0
    for b in range(3):
        for guess in (None, stam.set_bnd2d(b, x), x):
            for coeffs, iters in (((1.0, 4.0), 20), ((a, 1 + 4 * a), 7)):
                got = kernels.lin_solve2d(b, guess, x0, *coeffs, iters)
                want = kernels.lin_solve2d_plain(b, guess, x0, *coeffs,
                                                 iters)
                assert torch.equal(got, want), (b, coeffs, iters)
                calls += 1
    assert kernels.lin_solve2d.launches == before + calls


@pytest.mark.parametrize("n,blocks,smem", [(20, 3, 6000), (41, 7, 20000)])
def test_lin_solve2d_with_several_tiles_a_block(cuda, n, blocks, smem):
    """The 2D solve's kernel on a plan of fewer blocks than tiles (each
    block reloading its x0 with each tile), every b, zero, consistent and
    raw guesses, bit for bit against its plain version."""
    x, x0 = _fields2d(cuda, n, 21, (0, 0), -1.0, 1.0, raw=True)
    plan = kernels.solve2d_plan(n, 4 * blocks, smem)
    plan = kernels.SolvePlan(blocks, plan.threads, plan.smem, plan.levels,
                             plan.tile)
    assert plan.tile.count(n) > blocks
    for b in range(3):
        for guess in (None, stam.set_bnd2d(b, x), x):
            for coeffs, iters in (((1.0, 4.0), 23), ((0.3, 2.2), 7)):
                got = kernels._solve2d_launch(b, guess, x0, *coeffs, iters,
                                              plan)
                want = kernels.lin_solve2d_plain(b, guess, x0, *coeffs,
                                                 iters)
                assert torch.equal(got, want), (b, coeffs, iters)


def _config1(n, **kw):
    """BASELINE config 1 (bench.py:305-306) at size n."""
    return stam.StamConfig(**{**dict(n=n, dt=0.1, diff=1e-5, visc=1e-5,
                                     jacobi_iters=20, advect_mode="stencil"),
                              **kw})


FORCING = dict(buoyancy_alpha=0.04, buoyancy_beta=0.9, vorticity_eps=1.5,
               temp_diff=2e-5, ambient_temp=0.1)


@pytest.mark.parametrize("case", [
    {}, FORCING, dict(FORCING, visc=0.0, diff=0.0),
    dict(buoyancy_beta=0.9, diff=0.0), dict(vorticity_eps=1.5)],
    ids=["config1", "forcing", "no_diffusion", "buoyancy", "vorticity"])
@pytest.mark.parametrize("n", [13, 14, 63, 127, 128, 168, 250, 800, 1119])
def test_step2d_whole_is_bitwise_plain_and_multi(cuda, n, case):
    """One whole-step launch, a cooperative launch of more than one block,
    against its plain version and against the multi-call step through the
    solve kernel, on a moving state; n below, at and past the tiles'
    sizes, past the one-block design's gate (168), and up to the gate's
    edge (1119), where three or four diffusing fields have more (field,
    tile) pairs than the card has blocks (each block reloading x0 with
    each pair)."""
    cfg = _config1(n, **case)
    blocks, _, smem = kernels.step2d_info(torch.cuda.current_device())
    assert blocks > 1
    plan = kernels.step2d_plan(n, cfg, blocks, smem)
    fields = kernels.step2d_fields(cfg)
    if n >= 800 and fields >= 3:
        assert fields * plan.diffuse.count(n) > blocks
    u, v = _fields2d(cuda, n, 21, (1, 2), -1.0 / (cfg.dt * n),
                     1.0 / (cfg.dt * n))
    d, t = _fields2d(cuda, n, 22, (0, 0), 0.0, 1.0)
    before = kernels.step2d_whole.launches
    got = kernels.step2d_whole(u, v, d, t, cfg)
    assert kernels.step2d_whole.launches == before + 1
    want = kernels.step2d_whole_plain(u, v, d, t, cfg)
    multi = stam.step2d_multi(stam.GridState2D(u, v, d, t), cfg)
    for g, w, f in zip(got, want, ("u", "v", "dens", "temp")):
        assert torch.equal(g, w), f
        assert torch.equal(g, getattr(multi, f)), f
    assert float(got[0].abs().max()) > 0.0


def _raw_step2d_is_bitwise_plain(cuda, n, case):
    """A state whose ghosts set_bnd2d would change (as once sources are
    added there), at diffusion coefficients scaled up so that the first
    sweep's stored taps and the halos show: the whole step bit for bit
    against the plain step."""
    cfg = _config1(n, **case)
    cfg = cfg.replace(visc=3000 * cfg.visc, diff=3000 * cfg.diff,
                      temp_diff=3000 * cfg.temp_diff)
    u, v = _fields2d(cuda, n, 23, (1, 2), -1.0 / (cfg.dt * n),
                     1.0 / (cfg.dt * n), raw=True)
    d, t = _fields2d(cuda, n, 24, (0, 0), 0.0, 1.0, raw=True)
    before = kernels.step2d_whole.launches
    got = kernels.step2d_whole(u, v, d, t, cfg)
    assert kernels.step2d_whole.launches == before + 1
    want = kernels.step2d_whole_plain(u, v, d, t, cfg)
    for g, w, f in zip(got, want, ("u", "v", "dens", "temp")):
        assert torch.equal(g, w), f


@pytest.mark.parametrize("case", [{}, FORCING], ids=["config1", "forcing"])
@pytest.mark.parametrize("n", [13, 128, 250, 1119])
def test_step2d_whole_takes_raw_ghosts(cuda, n, case):
    """Raw ghosts and strong diffusion (_raw_step2d_is_bitwise_plain); at
    1119^2 the diffusion has more (field, tile) pairs than blocks."""
    _raw_step2d_is_bitwise_plain(cuda, n, case)


@pytest.mark.parametrize("case", [{}, FORCING], ids=["config1", "forcing"])
@pytest.mark.parametrize("blocks,smem", [(5, 12000), (7, 19200),
                                         (33, 40000)])
def test_step2d_whole_on_fewer_blocks(cuda, monkeypatch, blocks, smem, case):
    """The whole step at 128^2 on fewer blocks with less shared memory
    than the card offers (step2d_info replaced), so that a block takes
    several pressure tiles (recomputing x0 each pass) and several (field,
    tile) pairs (reloading x0 with each), a branch the card's own shape
    reaches for the diffusion only past about 780^2 and for the pressure
    at no size the gate admits; (33, 40000) keeps the pressure's tiles
    resident and not the diffusion's."""
    _, threads, _ = kernels.step2d_info(torch.cuda.current_device())
    monkeypatch.setattr(kernels, "step2d_info",
                        lambda _: (blocks, threads, smem))
    cfg = _config1(128, **case)
    plan = kernels.step2d_plan(128, cfg, blocks, smem)
    assert plan.smem <= smem
    assert (plan.project.count(128) > blocks) == (blocks < 33)
    assert kernels.step2d_fields(cfg) * plan.diffuse.count(128) > blocks
    _raw_step2d_is_bitwise_plain(cuda, 128, case)


def _sources2d(n, dev):
    """bench.py:308-311's sources at size n (cli.py:202-205)."""
    src = torch.zeros((n + 2, n + 2), device=dev)
    fv = torch.zeros_like(src)
    src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
    fv[n // 2 - 4:n // 2 + 4, 4:8] = 2.0
    return {"dens": src, "fv": fv}


@pytest.mark.parametrize("mode", ["stencil", "gather"])
def test_2d_card_matches_cpu_over_four_steps(cuda, mode):
    cfg = _config1(32, advect_mode=mode)
    gpu = stam.run2d_python(stam.make_grid2d(cfg, cuda), cfg, 4,
                            sources=_sources2d(32, cuda))
    cpu = stam.run2d_python(stam.make_grid2d(cfg, "cpu"), cfg, 4,
                            sources=_sources2d(32, "cpu"))
    for f in ("u", "v", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)


def test_2d_launch_counts(cuda):
    """Config 1 at 128^2: one step2d_whole launch a step; the smoke2d
    default (gather) five lin_solve2d launches a step (two velocity
    diffusions, two projections, the dens diffusion); run2d reports the
    residual every step, so it takes the multi-call step too."""
    cfg = _config1(128)
    expect = dict.fromkeys(kernels.launch_counts(), 0)
    for c, steps, want in ((cfg, 3, dict(step2d_whole=3)),
                           (cfg.replace(advect_mode="gather"), 3,
                            dict(lin_solve2d=15))):
        kernels.reset_launches()
        s = stam.run2d_python(stam.make_grid2d(c, cuda), c, steps,
                              sources=_sources2d(128, cuda))
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {**expect, **want}
        assert bool(torch.isfinite(s.dens).all()) and float(s.dens.sum()) > 0
    kernels.reset_launches()
    s, res = stam.run2d(s, cfg, 2)
    assert kernels.launch_counts() == {**expect, "lin_solve2d": 10}
    assert res.shape == (2,) and 0.0 < float(res.max()) < 1e-2
