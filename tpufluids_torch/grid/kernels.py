"""The hand-written CUDA kernels of the 2D and 3D steps, each beside its
plain PyTorch version.

Counterpart of ``tpufluids/grid/pallas_kernels.py``: every Pallas
kernel on the steps' paths has a CUDA kernel here (sources in
``tpufluids_torch/csrc``, built by ``tpufluids_torch._build``).  A
wrapper runs the plain version when its tensors lie on the CPU, and
launches its kernel when they lie on a CUDA device; anything else
raises.  A launch that fails raises too: no wrapper falls back from its
kernel to the plain version.  Each wrapper counts its launches in its
``launches`` attribute.

Device-memory bytes bound every 3D kernel here.  The four stencil
stages (advection, forcing, divergence, gradient subtraction) are single
passes over a few (n+2)^3 float32 fields, one thread per output cell,
ghosts included; a ghost output is the interior value at its clamped
index times the set_bnd sign (csrc/grid_common.cuh), so no second
boundary pass is needed.  The solvers (csrc/jacobi.cu) stream one pass
per Jacobi sweep or red-black half-sweep; the whole tier (the
multi-field diffusion, the fused projection and the whole step) runs a
whole solve, or a whole step, in one cooperative launch, for grids whose
fields stay in the card's L2 (``whole_ok``).

A 2D field is small (130^2 float32 is 68 KB), so the 2D kernels
(csrc/grid2d.cu) run one thread block that does every sweep, with a
block barrier between sweeps: the 2D solve, and the whole 2D step, whose
solves keep their two buffers in the block's shared memory.
"""

from __future__ import annotations

import torch

from tpufluids_torch import _build
from tpufluids_torch.grid import stam


def _on_cuda(*tensors, ndim: int = 3) -> bool:
    """Validate a kernel's field arguments, cubic (n+2)^3 fields or, with
    ``ndim=2``, square (n+2)^2 ones; True for CUDA tensors, False for CPU
    tensors (the plain version runs)."""
    ref = tensors[0]
    if ref.dim() != ndim or len(set(ref.shape)) != 1 or ref.shape[0] < 3:
        raise ValueError(f"expected a {'square' if ndim == 2 else 'cubic'} "
                         f"(n+2)^{ndim} field with n >= 1, got shape "
                         f"{tuple(ref.shape)}")
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"fields on {t.device} and {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 fields, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"field shapes {tuple(t.shape)} and "
                             f"{tuple(ref.shape)} differ")
        if not t.is_contiguous():
            raise ValueError("fields must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for {ref.device}")
    if ref.device.type == "cuda" and ref.numel() >= 2 ** 31:
        raise ValueError("the kernels index cells with int32: (n+2)^3 "
                         "must stay below 2^31")
    return ref.device.type == "cuda"


# ---------------------------------------------------------------------------
# advection


def advect3d_multi_plain(fields, bnds, u, v, w, dt0: float):
    return tuple(stam._advect_stencil(fields, bnds, (u, v, w), dt0))


def advect3d_multi(fields, bnds, u, v, w, dt0: float):
    """27-tap stencil advection of ``fields`` (1 to 3) by (u, v, w), then
    set_bnd3d(b) per field with b from ``bnds``; as
    stam.advect3d_stencil per field.

    Replaces advect3d_multi_pallas (tpufluids/grid/pallas_kernels.py).
    Bound by bytes: 3 + k fields in, k out.  One thread per output cell
    computes the backtrace weights once and sums the 27 taps of each
    field (csrc/advect.cu)."""
    fields, bnds = tuple(fields), tuple(bnds)
    if not 1 <= len(fields) <= 3 or len(bnds) != len(fields):
        raise ValueError("advect3d_multi takes 1 to 3 fields, one b each")
    if any(b not in (0, 1, 2, 3) for b in bnds):
        raise ValueError(f"set_bnd modes must be 0..3, got {bnds}")
    if not _on_cuda(u, v, w, *fields):
        return advect3d_multi_plain(fields, bnds, u, v, w, dt0)
    k = len(fields)
    outs = tuple(torch.empty_like(u) for _ in fields)
    pad = (None,) * (3 - k)
    _build.launch("tf_advect3d", u, v, w, *fields, *pad, *outs, *pad, k,
                  *bnds, *(0,) * (3 - k), u.shape[0] - 2, dt0)
    advect3d_multi.launches += 1
    return outs


advect3d_multi.launches = 0


# ---------------------------------------------------------------------------
# forcing


def forcing3d_plain(u, v, w, dens, temp, cfg: stam.StamConfig):
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        w = stam.buoyancy3d(w, dens, temp, cfg)
    if cfg.vorticity_eps:
        u, v, w = stam.vorticity_confinement3d(u, v, w, cfg)
    return u, v, w


def forcing3d(u, v, w, dens, temp, cfg: stam.StamConfig):
    """Buoyancy on w (if alpha or beta) then vorticity confinement (if
    eps), each with its set_bnd; as stam.buoyancy3d followed by
    stam.vorticity_confinement3d.

    Replaces forcing3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by bytes.  The TPU kernel's halo of 2 is cut into two launches
    through two scratch fields (csrc/forcing.cu): A writes w' and
    |curl|, B the confined u, v, w.  A half whose coefficients are 0 is
    skipped."""
    if not _on_cuda(u, v, w, dens, temp):
        return forcing3d_plain(u, v, w, dens, temp, cfg)
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    if not (buoy or vort):
        return u, v, w
    n = u.shape[0] - 2
    h = 1.0 / n
    w1 = torch.empty_like(w) if buoy else None
    mag = torch.empty_like(u) if vort else None
    # the plain version's tensor / h runs on the card as tensor * fl(1 / h),
    # the reciprocal taken in double: the kernels multiply by 1 / h
    _build.launch("tf_forcing_a", u, v, w, dens, temp, w1, mag, n, buoy,
                  vort, cfg.dt, cfg.buoyancy_alpha, cfg.buoyancy_beta,
                  cfg.ambient_temp, 1.0 / h)
    if buoy:
        w = w1
    if vort:
        outs = tuple(torch.empty_like(u) for _ in range(3))
        _build.launch("tf_forcing_b", u, v, w, mag, *outs, n, cfg.dt,
                      cfg.vorticity_eps * h, 1.0 / h)
        u, v, w = outs
    forcing3d.launches += 1
    return u, v, w


forcing3d.launches = 0


# ---------------------------------------------------------------------------
# projection: divergence and gradient subtraction


def div3d_plain(u, v, w):
    div = torch.zeros_like(u)
    div[stam._I] = stam.divergence3d(u, v, w)
    return stam._set_bnd3d_(0, div)


def div3d(u, v, w):
    """set_bnd3d(0, divergence3d(u, v, w) on the interior): the
    right-hand side of the pressure solve.

    Replaces div3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound by
    bytes: 3 fields in, 1 out (csrc/divgrad.cu)."""
    if not _on_cuda(u, v, w):
        return div3d_plain(u, v, w)
    n = u.shape[0] - 2
    out = torch.empty_like(u)
    _build.launch("tf_div3d", u, v, w, out, n, -0.5 * (1.0 / n))
    div3d.launches += 1
    return out


div3d.launches = 0


def gradsub3d_plain(p, u, v, w):
    n = u.shape[0] - 2
    h = 1.0 / n
    out = []
    for axis, (b, q) in enumerate(((1, u), (2, v), (3, w))):
        hi, lo = [slice(1, -1)] * 3, [slice(1, -1)] * 3
        hi[axis] = slice(2, None)
        lo[axis] = slice(0, -2)
        q = q.clone()
        q[stam._I] += -0.5 * (p[tuple(hi)] - p[tuple(lo)]) / h
        out.append(stam._set_bnd3d_(b, q))
    return tuple(out)


def gradsub3d(p, u, v, w):
    """Subtract the pressure gradient 0.5 (p[+1] - p[-1]) / h from each
    velocity component, then set_bnd3d(1 / 2 / 3): the tail of
    stam.project3d.

    Replaces gradsub3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by bytes: 4 fields in, 3 out (csrc/divgrad.cu)."""
    if not _on_cuda(p, u, v, w):
        return gradsub3d_plain(p, u, v, w)
    n = u.shape[0] - 2
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(3))
    _build.launch("tf_gradsub3d", p, u, v, w, *outs, n, 1.0 / h)
    gradsub3d.launches += 1
    return outs


gradsub3d.launches = 0


# ---------------------------------------------------------------------------
# linear solves: Jacobi, red-black, and the whole tier

# The whole tier's cooperative launch keeps its fields in the card's 50 MB
# L2: up to nine for a solve, nineteen for a whole step.  64^3 (1.15 MB a
# field) takes both, 256^3 (68.7 MB) streams.
WHOLE_MAX_FIELD_BYTES = 4 * 1024 * 1024
STEP_MAX_FIELD_BYTES = 2 * 1024 * 1024


def whole_ok(x: torch.Tensor) -> bool:
    """True when fields shaped like ``x`` take the whole tier's solves
    (diffuse3d_multi, project3d_whole)."""
    return x.numel() * x.element_size() <= WHOLE_MAX_FIELD_BYTES


def step_whole_ok(x: torch.Tensor) -> bool:
    """True when fields shaped like ``x`` take the whole step
    (step3d_whole)."""
    return x.numel() * x.element_size() <= STEP_MAX_FIELD_BYTES


def _check_solve(b: int, iters: int):
    if b not in (0, 1, 2, 3):
        raise ValueError(f"set_bnd mode must be 0..3, got {b}")
    if not isinstance(iters, int) or iters < 1:
        raise ValueError(f"iters must be an int >= 1, got {iters!r}")


def _solve_on_cuda(b, x, x0, iters) -> bool:
    _check_solve(b, iters)
    return _on_cuda(x0) if x is None else _on_cuda(x, x0)


def lin_solve3d_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters)


def lin_solve3d(b, x, x0, a, c, iters):
    """``iters`` Jacobi sweeps of (x0 + a * sum of neighbours) / c, each
    followed by set_bnd3d(b); as stam.lin_solve3d.  ``x`` None is a zero
    initial guess.

    Replaces lin_solve3d_pallas (tpufluids/grid/pallas_kernels.py).
    Bound by bytes: x, x0 in and the result out, once per sweep here.
    One launch per sweep, out of place between two buffers, one thread
    per output cell (csrc/jacobi.cu)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_plain(b, x, x0, a, c, iters)
    out, tmp = torch.empty_like(x0), torch.empty_like(x0)
    _build.launch("tf_lin_solve3d", x, x0, out, tmp, b, x0.shape[0] - 2,
                  iters, a, 1.0 / c)
    lin_solve3d.launches += 1
    return out


lin_solve3d.launches = 0


def lin_solve3d_rb_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters, red_black=True)


def lin_solve3d_rb(b, x, x0, a, c, iters):
    """``iters`` red-black Gauss-Seidel iterations, each two half-sweeps
    (parity 0, then 1) followed by set_bnd3d(b); as
    stam.lin_solve3d(red_black=True).  ``x`` None is a zero initial
    guess.

    Replaces lin_solve3d_rb_packed (tpufluids/grid/pallas_kernels.py).
    Bound by bytes.  One launch per half-sweep over the active cells
    only, in place, then one launch that writes the ghosts
    (csrc/jacobi.cu; the header says how ghost taps avoid a race)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_rb_plain(b, x, x0, a, c, iters)
    out = torch.empty_like(x0)
    _build.launch("tf_lin_solve3d_rb", x, x0, out, b, x0.shape[0] - 2,
                  iters, a, 1.0 / c)
    lin_solve3d_rb.launches += 1
    return out


lin_solve3d_rb.launches = 0


def diffuse3d_multi_plain(xs, params, iters):
    return tuple(stam.lin_solve3d(b, x, x, a, c, iters)
                 for x, (b, a, c) in zip(xs, params))


def diffuse3d_multi(xs, params, iters):
    """Diffuse each field of ``xs`` (1 to 3) by ``iters`` Jacobi sweeps
    with its own (b, a, c) from ``params``, x0 being the field itself;
    as lin_solve3d(b, x, x, a, c, iters) per field.

    Replaces diffuse3d_whole_multi (tpufluids/grid/pallas_kernels.py).
    One cooperative launch runs every sweep of every field, with a
    grid-wide barrier between sweeps (csrc/jacobi.cu); only for fields
    that pass ``whole_ok``."""
    xs, params = tuple(xs), tuple(params)
    if not 1 <= len(xs) <= 3 or len(params) != len(xs):
        raise ValueError("diffuse3d_multi takes 1 to 3 fields, one "
                         "(b, a, c) each")
    for b, _, _ in params:
        _check_solve(b, iters)
    if not _on_cuda(*xs):
        return diffuse3d_multi_plain(xs, params, iters)
    if not whole_ok(xs[0]):
        raise ValueError(f"{tuple(xs[0].shape)} fields are outside the "
                         f"whole tier (whole_ok)")
    k, pad = len(xs), (None,) * (3 - len(xs))
    outs = tuple(torch.empty_like(x) for x in xs)
    tmps = tuple(torch.empty_like(x) for x in xs)
    bs, as_, cs = zip(*params)
    _build.launch("tf_diffuse3d_multi", *xs, *pad, *outs, *pad, *tmps, *pad,
                  k, *bs, *(0,) * (3 - k), xs[0].shape[0] - 2, iters, *as_,
                  *(0.0,) * (3 - k), *(1.0 / c for c in cs),
                  *(0.0,) * (3 - k))
    diffuse3d_multi.launches += 1
    return outs


diffuse3d_multi.launches = 0


def project3d_whole_plain(u, v, w, iters, red_black):
    p = stam.lin_solve3d(0, None, div3d_plain(u, v, w), 1.0, 6.0, iters,
                         red_black=red_black)
    return gradsub3d_plain(p, u, v, w)


def project3d_whole(u, v, w, iters, red_black):
    """The Jacobi projection: divergence, ``iters`` Jacobi or red-black
    sweeps of the pressure solve from a zero guess (a = 1, c = 6, b =
    0), gradient subtraction; as div3d, lin_solve3d(_rb) and gradsub3d
    in turn.

    Replaces project3d_whole_pallas (tpufluids/grid/pallas_kernels.py).
    One cooperative launch runs the three phases with the cell bodies of
    the three-launch path (csrc/jacobi.cu, csrc/divgrad.cuh); only for
    fields that pass ``whole_ok``."""
    _check_solve(0, iters)
    if not _on_cuda(u, v, w):
        return project3d_whole_plain(u, v, w, iters, red_black)
    if not whole_ok(u):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole "
                         f"tier (whole_ok)")
    n = u.shape[0] - 2
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(3))
    div, p = torch.empty_like(u), torch.empty_like(u)
    p2 = None if red_black else torch.empty_like(u)
    _build.launch("tf_project3d_whole", u, v, w, *outs, div, p, p2, n, iters,
                  bool(red_black), -0.5 * h, 1.0 / h, 1.0 / 6.0)
    project3d_whole.launches += 1
    return outs


project3d_whole.launches = 0


# ---------------------------------------------------------------------------
# the whole step

# scratch fields of the whole step: two velocity trios and one for |curl|,
# the diffusion's second buffers and the projection's div and p
STEP_SCRATCH = 9


def _check_step(cfg: stam.StamConfig):
    if (cfg.projection != "jacobi" or cfg.solver_dtype != "float32"
            or cfg.advect_mode != "stencil"):
        raise ValueError(f"the whole step runs the float32 Jacobi projection"
                         f" and stencil advection, not projection="
                         f"{cfg.projection!r}, solver_dtype="
                         f"{cfg.solver_dtype!r}, advect_mode="
                         f"{cfg.advect_mode!r}")
    _check_solve(0, cfg.jacobi_iters)


def step3d_whole_plain(u, v, w, dens, temp, cfg: stam.StamConfig):
    n = u.shape[0] - 2
    dt0 = cfg.dt * n
    iters, rb = cfg.jacobi_iters, cfg.red_black

    def diffuse(fields, bnds, coeff):
        params = tuple((b, *stam._diffusion_ac(cfg, coeff, n)) for b in bnds)
        return diffuse3d_multi_plain(fields, params, iters)

    u, v, w = forcing3d_plain(u, v, w, dens, temp, cfg)
    if cfg.visc:
        u, v, w = diffuse((u, v, w), (1, 2, 3), cfg.visc)
    u, v, w = project3d_whole_plain(u, v, w, iters, rb)
    u, v, w = advect3d_multi_plain((u, v, w), (1, 2, 3), u, v, w, dt0)
    u, v, w = project3d_whole_plain(u, v, w, iters, rb)
    if cfg.diff:
        (dens,) = diffuse((dens,), (0,), cfg.diff)
    if cfg.temp_diff:
        (temp,) = diffuse((temp,), (0,), cfg.temp_diff)
    dens, temp = advect3d_multi_plain((dens, temp), (0, 0), u, v, w, dt0)
    return u, v, w, dens, temp


def step3d_whole(u, v, w, dens, temp, cfg: stam.StamConfig):
    """One step of the Jacobi path without the residual: forcing,
    velocity diffusion, projection, self-advection, projection, dens/temp
    diffusion, dens/temp advection; as stam.step3d_multi (each stage
    through its own kernel) and returning (u, v, w, dens, temp).

    Replaces step3d_whole_pallas (tpufluids/grid/pallas_kernels.py).
    One cooperative launch runs every phase with the cell bodies of the
    separate kernels and a grid-wide barrier between phases and sweeps
    (csrc/step.cu); only for fields that pass ``step_whole_ok``."""
    _check_step(cfg)
    if not _on_cuda(u, v, w, dens, temp):
        return step3d_whole_plain(u, v, w, dens, temp, cfg)
    if not step_whole_ok(u):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole "
                         f"step (step_whole_ok)")
    n = u.shape[0] - 2
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(5))
    scratch = torch.empty((STEP_SCRATCH, *u.shape), dtype=u.dtype,
                          device=u.device)

    def ac(coeff):
        a, c = stam._diffusion_ac(cfg, coeff, n)
        return a, 1.0 / c

    # the constants the separate wrappers pass, computed as they do
    _build.launch("tf_step3d_whole", u, v, w, dens, temp, *outs, scratch, n,
                  cfg.jacobi_iters, bool(cfg.red_black),
                  bool(cfg.buoyancy_alpha or cfg.buoyancy_beta),
                  bool(cfg.vorticity_eps), bool(cfg.visc), bool(cfg.diff),
                  bool(cfg.temp_diff), cfg.dt, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta, cfg.ambient_temp, 1.0 / h,
                  cfg.vorticity_eps * h, -0.5 * (1.0 / n), 1.0 / 6.0,
                  cfg.dt * n, *ac(cfg.visc), *ac(cfg.diff),
                  *ac(cfg.temp_diff))
    step3d_whole.launches += 1
    return outs


step3d_whole.launches = 0


# ---------------------------------------------------------------------------
# the 2D kernels: one thread block each

# shared memory one block may use on the H100 (227 KB, opt-in above 48 KB)
BLOCK_SMEM_BYTES = 232448


def step2d_whole_ok(x: torch.Tensor) -> bool:
    """True when the two Jacobi buffers of a 2D solve on fields shaped
    like ``x`` fit one block's shared memory (up to 170^2 cells, ghosts
    included).  Such fields take the whole 2D step; lin_solve2d keeps its
    buffers there, or else in device memory."""
    return 2 * x.numel() * x.element_size() <= BLOCK_SMEM_BYTES


def lin_solve2d_plain(b, x, x0, a, c, iters):
    return stam.lin_solve2d(b, x, x0, a, c, iters)


def lin_solve2d(b, x, x0, a, c, iters):
    """``iters`` Jacobi sweeps of (x0 + a * sum of the four neighbours)
    / c, each followed by set_bnd2d(b) with its corner averages; as
    stam.lin_solve2d.  ``x`` None is a zero initial guess.

    Replaces lin_solve2d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by latency: a sweep is a few microseconds of work, and the sweeps are
    serial.  One block of 1024 threads runs every sweep with a block
    barrier between sweeps, its two buffers in shared memory, or in
    device memory past ``step2d_whole_ok`` (csrc/grid2d.cu)."""
    if b not in (0, 1, 2):
        raise ValueError(f"set_bnd2d mode must be 0..2, got {b}")
    _check_solve(b, iters)
    if not (_on_cuda(x0, ndim=2) if x is None else _on_cuda(x, x0, ndim=2)):
        return lin_solve2d_plain(b, x, x0, a, c, iters)
    out = torch.empty_like(x0)
    tmp = None if step2d_whole_ok(x0) else torch.empty_like(x0)
    _build.launch("tf_lin_solve2d", x, x0, out, tmp, b, x0.shape[0] - 2,
                  iters, a, 1.0 / c)
    lin_solve2d.launches += 1
    return out


lin_solve2d.launches = 0

# scratch fields of the whole 2D step: two velocity pairs, |curl| and div
STEP2D_SCRATCH = 6


def step2d_whole_plain(u, v, dens, temp, cfg: stam.StamConfig):
    s = stam.step2d_multi(stam.GridState2D(u, v, dens, temp), cfg,
                          solve=lin_solve2d_plain)
    return s.u, s.v, s.dens, s.temp


def step2d_whole(u, v, dens, temp, cfg: stam.StamConfig):
    """One 2D step with stencil advection and the Jacobi projection,
    without the residual: buoyancy, vorticity confinement, velocity
    diffusion, projection, self-advection, projection, dens/temp
    diffusion and advection; as stam.step2d_multi, returning (u, v, dens,
    temp).

    Replaces step2d_whole_pallas (tpufluids/grid/pallas_kernels.py).  One
    block of 1024 threads runs every phase in the reference's order, a
    block barrier between phases and sweeps; the solves' two buffers live
    in shared memory, every other field in device memory (L2-resident at
    128^2).  Only for fields that pass ``step2d_whole_ok``
    (csrc/grid2d.cu)."""
    _check_step(cfg)
    if not _on_cuda(u, v, dens, temp, ndim=2):
        return step2d_whole_plain(u, v, dens, temp, cfg)
    if not step2d_whole_ok(u):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole 2D "
                         f"step (step2d_whole_ok)")
    n = u.shape[0] - 2
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(4))
    scratch = torch.empty((STEP2D_SCRATCH, *u.shape), dtype=u.dtype,
                          device=u.device)

    def ac(coeff):
        a, c = stam._diffusion_ac(cfg, coeff, n, 2)
        return a, 1.0 / c

    # the constants of the plain version's stages, computed as they do;
    # its tensor / h runs on the card as tensor * fl(1 / h), the
    # reciprocal taken in double
    _build.launch("tf_step2d_whole", u, v, dens, temp, *outs, scratch, n,
                  cfg.jacobi_iters,
                  bool(cfg.buoyancy_alpha or cfg.buoyancy_beta),
                  bool(cfg.vorticity_eps), bool(cfg.visc), bool(cfg.diff),
                  bool(cfg.temp_diff), cfg.dt, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta, cfg.ambient_temp, 1.0 / h,
                  cfg.vorticity_eps * h, -cfg.vorticity_eps * h, -0.5 * h,
                  cfg.dt * n, *ac(cfg.visc), *ac(cfg.diff),
                  *ac(cfg.temp_diff))
    step2d_whole.launches += 1
    return outs


step2d_whole.launches = 0

KERNELS = (advect3d_multi, forcing3d, div3d, gradsub3d, lin_solve3d,
           lin_solve3d_rb, diffuse3d_multi, project3d_whole, step3d_whole,
           lin_solve2d, step2d_whole)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
