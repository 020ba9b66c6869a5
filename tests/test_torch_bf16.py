"""The port's bfloat16 solver against the JAX package on the CPU: the
plain bfloat16 solves against the interpret-mode Pallas solve
``lin_solve3d_pallas(dtype=bfloat16)``, and four steps of BASELINE
config 4 with ``solver_dtype="bfloat16"`` against JAX's Pallas step.

The JAX dense path ignores ``solver_dtype``, so the reference here is
``solver_backend="pallas"`` under ``pltpu.force_tpu_interpret_mode()``,
on set_bnd-consistent inputs (the Pallas kernels rebuild the z ghosts;
ROADMAP Queue 3, "Ghost-plane seeding").

Tolerances:
- The plain bfloat16 solve equals the Pallas solve bit for bit on the
  interior: both round every operation to bfloat16 in the same order,
  with a and 1 / c rounded to bfloat16 first.  So does the scalar
  rounding itself.
- The whole solve's plain version equals the streamed one bit for bit
  (one function).
- Four steps of config 4 in bfloat16: fields within 1e-4 * max|ref| of
  JAX's bfloat16 step (measured about 5e-6), well below the 3e-3 * max
  by which JAX's float32 step differs at 14^3, and nearer to the
  bfloat16 step than to the float32 one, which shows that the bfloat16
  solve ran and the float32 whole tiers did not; residuals within 1e-3
  relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert, kernels
from tpufluids_torch.grid import stam as tstam

ITERS = 4
STEP_TOL = 1e-4
RESIDUAL_RTOL = 1e-3
BF16 = torch.bfloat16


def T(a):
    return torch.from_numpy(np.array(a))


def _consistent(b, x):
    return np.asarray(jstam.set_bnd3d(b, jnp.asarray(x)))


def _rand(seed, n, count):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (n + 2,) * 3).astype(np.float32)
            for _ in range(count)]


def _diffusion_ac(n, coeff=1e-5, dt=0.05):
    """The (a, c) of configs 2 and 4's diffusion at size n."""
    a = dt * coeff * n * n
    return a, 1 + 6 * a


# the pressure solve and config 2/4's diffusion at 16^3 and 64^3
COEFFS = [(1.0, 6.0), _diffusion_ac(16), _diffusion_ac(64)]


@pytest.mark.parametrize("a,c", COEFFS, ids=["pressure", "diff16", "diff64"])
def test_scalars_round_as_jax_rounds_them(a, c):
    """a and 1 / c as the reference's kernel takes them: weak-typed
    Python floats rounded against a bfloat16 array."""
    one = jnp.ones((), jnp.bfloat16)
    for v in (a, 1.0 / c):
        assert tstam.round_scalar(v, BF16) == float(one * v)
    # the rounding matters: 1 / 6 is not a bfloat16
    assert tstam.round_scalar(1.0 / 6.0, BF16) != np.float32(1.0 / 6.0)


@pytest.mark.parametrize("n", [14, 15])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_plain_bf16_solve_is_bitwise_pallas(b, red_black, n):
    """Every b, odd and even n, Jacobi and red-black; one of the pressure
    and two diffusion (a, c) a case, in turn with b and n, so that each
    (a, c) meets both n and both modes.  The reference's whole-solve
    mode for the diffusions, its windowed mode for the pressure solve."""
    x, x0 = _rand(10 * b + n, n, 2)
    x = _consistent(b, x)
    plain = (kernels.lin_solve3d_rb_bf16_plain if red_black
             else kernels.lin_solve3d_bf16_plain)
    a, c = COEFFS[(b + n) % len(COEFFS)]
    tx, fuse = (4, 1 if red_black else 2) if c == 6.0 else (n + 2, ITERS)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve3d_pallas(
            b, jnp.asarray(x), jnp.asarray(x0), a, c, ITERS,
            red_black=red_black, tx=tx, fuse=fuse, dtype=jnp.bfloat16))
    got = plain(b, T(x), T(x0), a, c, ITERS)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[1:-1, 1:-1, 1:-1],
                                  ref[1:-1, 1:-1, 1:-1], err_msg=(a, c))


@pytest.mark.parametrize("guess", ["zero", "consistent", "raw"])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_whole_plain_equals_streamed_plain(red_black, guess):
    n = 9
    x, x0 = _rand(31, n, 2)
    x = {"zero": None, "consistent": T(_consistent(2, x)),
         "raw": T(x)}[guess]
    x0 = T(x0)
    a, c = _diffusion_ac(64)
    streamed = {(False, torch.float32): kernels.lin_solve3d_plain,
                (True, torch.float32): kernels.lin_solve3d_rb_plain,
                (False, BF16): kernels.lin_solve3d_bf16_plain,
                (True, BF16): kernels.lin_solve3d_rb_bf16_plain}
    for dtype in (torch.float32, BF16):
        for coeffs in ((1.0, 6.0), (a, c)):
            whole = kernels.lin_solve3d_whole_plain(2, x, x0, *coeffs, ITERS,
                                                    red_black, dtype)
            assert torch.equal(whole, streamed[red_black, dtype](
                2, x, x0, *coeffs, ITERS))
            # and the wrapper, on the CPU, is its plain version
            assert torch.equal(whole, kernels.lin_solve3d_whole(
                2, x, x0, *coeffs, ITERS, red_black, dtype))


def test_bf16_solve_differs_from_float32():
    n = 14
    x, x0 = (T(a) for a in _rand(5, n, 2))
    f32 = kernels.lin_solve3d_rb_plain(0, x, x0, 1.0, 6.0, ITERS)
    bf16 = kernels.lin_solve3d_rb_bf16_plain(0, x, x0, 1.0, 6.0, ITERS)
    rel = float((bf16 - f32).abs().max() / f32.abs().max())
    assert 1e-4 < rel < 5e-2
    # every value of the bfloat16 solve is a bfloat16
    assert torch.equal(bf16, bf16.to(BF16).float())


def test_whole_solve_gate_counts_the_storage_bytes():
    def field(n):
        return torch.empty((n + 2,) * 3, device="meta")
    assert kernels.solve_whole_ok(field(64), torch.float32)
    assert kernels.solve_whole_ok(field(99), torch.float32)
    assert not kernels.solve_whole_ok(field(100), torch.float32)
    assert kernels.solve_whole_ok(field(126), BF16)
    assert not kernels.solve_whole_ok(field(127), BF16)
    assert not kernels.solve_whole_ok(field(256), BF16)


@pytest.mark.parametrize("bad", ["dtype", "bf16_input"])
def test_solve_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, x0 = (T(a) for a in _rand(6, 6, 2))
    if bad == "dtype":
        for dtype in (torch.float64, torch.float16):
            with pytest.raises(TypeError):
                kernels.lin_solve3d_whole(0, x, x0, 1.0, 6.0, 2, True, dtype)
        return
    # the solves take float32 fields and cast them themselves
    xb = x.to(BF16)
    for solve in (kernels.lin_solve3d_bf16, kernels.lin_solve3d_rb_bf16,
                  kernels.lin_solve3d, kernels.lin_solve3d_rb):
        with pytest.raises(TypeError):
            solve(0, xb, x0, 1.0, 6.0, 2)
    with pytest.raises(TypeError):
        kernels.lin_solve3d_whole(0, x, xb, 1.0, 6.0, 2, True, BF16)


@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_dispatch_routes_by_dtype_and_gate(monkeypatch, red_black):
    """stam._lin_solve3d sends each solve where the reference's dispatch
    sends it: the whole solve inside solve_whole_ok (float32 red-black
    excepted: lin_solve3d_rb), else the streamed solve of its dtype."""
    calls = []
    for name in ("lin_solve3d", "lin_solve3d_rb", "lin_solve3d_bf16",
                 "lin_solve3d_rb_bf16", "lin_solve3d_whole"):
        plain = getattr(kernels, name + "_plain")
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, _p=plain: (calls.append(_n),
                                                           _p(*a))[1])
    x0 = T(_rand(7, 6, 1)[0])
    cells = x0.numel()
    jacobi, rb = not red_black, red_black
    # (gate in bytes, the solves of a float32 and a bfloat16 call)
    cases = [
        (cells * 4, ["lin_solve3d_rb" if rb else "lin_solve3d_whole",
                     "lin_solve3d_whole"]),
        (cells * 2, ["lin_solve3d" if jacobi else "lin_solve3d_rb",
                     "lin_solve3d_whole"]),
        (cells, ["lin_solve3d" if jacobi else "lin_solve3d_rb",
                 "lin_solve3d_bf16" if jacobi else "lin_solve3d_rb_bf16"]),
    ]
    for limit, want in cases:
        calls.clear()
        monkeypatch.setattr(kernels, "WHOLE_MAX_FIELD_BYTES", limit)
        for dtype in ("float32", "bfloat16"):
            tstam._lin_solve3d(0, None, x0, 1.0, 6.0, 2, red_black, dtype)
        assert calls == want, limit


# ---------------------------------------------------------------------------
# four steps of BASELINE config 4 (bench.py:323-326) with the bf16 solver

N, STEPS = 14, 4
CONFIG4 = dict(n=N, dt=0.05, diff=1e-5, visc=1e-5, jacobi_iters=20,
               red_black=True, advect_mode="stencil", buoyancy_alpha=0.05,
               buoyancy_beta=1.0, vorticity_eps=2.0)


def _config4_seed(jcfg):
    """bench.py:330-333's box scaled to 14^3, set_bnd-consistent."""
    s = jstam.make_grid3d(jcfg)
    box = (slice(5, 9), slice(5, 9), slice(1, 3))
    return {"u": np.asarray(s.u), "v": np.asarray(s.v),
            "w": np.asarray(s.w),
            "dens": _consistent(0, s.dens.at[box].set(1.0)),
            "temp": _consistent(0, s.temp.at[box].set(3.0))}


def test_config4_bf16_steps_match_jax_pallas():
    jcfg = jstam.StamConfig(solver_backend="pallas", solver_dtype="bfloat16",
                            **CONFIG4)
    seed = _config4_seed(jcfg)
    jstate = jstam.GridState3D(**{f: jnp.asarray(a) for f, a in seed.items()})
    with pltpu.force_tpu_interpret_mode():
        ref, ref_res = jstam.run3d(jstate, jcfg, STEPS)
    f32, _ = jstam.run3d(jstate, jstam.StamConfig(solver_backend="xla",
                                                  **CONFIG4), STEPS)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    kernels.reset_launches()
    got, res = tstam.run3d(convert.state_from_numpy(seed, device="cpu"),
                           tcfg, STEPS)
    assert set(kernels.launch_counts().values()) == {0}
    assert res.shape == (STEPS,)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res),
                               rtol=RESIDUAL_RTOL)
    got = convert.state_to_numpy(got)
    for f in convert.FIELDS:
        r, g = np.asarray(getattr(ref, f)), got[f]
        scale = float(np.abs(r).max())
        assert np.isfinite(g).all()
        to_bf16 = float(np.abs(g - r).max())
        to_f32 = float(np.abs(g - np.asarray(getattr(f32, f))).max())
        assert to_bf16 <= STEP_TOL * scale, f
        assert to_bf16 < to_f32, f
    assert float(np.abs(got["w"]).max()) > 1e-3
