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
passes over a few (n+2)^3 float32 fields; a ghost output is the interior
value at its clamped index times the set_bnd sign
(csrc/grid_common.cuh), so no second boundary pass is needed.  The
divergence and the gradient subtraction run one thread per output cell,
ghosts included; the advection and the forcing march each block's tile
along x through a ring of planes in shared memory
(csrc/stencil_march.cuh; ``march_plan``, and the emulations
``advect3d_march`` and ``forcing3d_march``).  The float32 Jacobi solve (csrc/jacobi.cu)
streams one pass per sweep; the red-black solves, dense and sharded in
float32 and dense in bfloat16 (each operation rounded to bfloat16, 2 B a
cell), do up to k half-sweeps a pass in shared memory
(csrc/rb_blocked.cu, ``rb_passes`` and ``rb_chunks`` below), and the
bfloat16 Jacobi solve two sweeps a pass (csrc/jacobi_blocked.cu,
``jacobi_passes``); the whole tier (the
whole solve in either type, the multi-field diffusion, the fused
projection and the whole step) runs a whole solve, or a whole step, in
one cooperative launch, for grids whose fields stay in the card's L2
(``solve_whole_ok``), each as blocked passes in shared memory, a grid
barrier a pass (``solve_plan``, ``diffuse_plan``, ``project_plan``,
``step_plan``).

The four stencil stages also take an x-slab of the sharded step
(``tpufluids_torch.shard``): a (rows, n+2, n+2) field placed at global
row ``gx0`` of the (n+2)^3 grid, whose x clamps and x ghosts follow
global rows (csrc/grid_common.cuh says which cells have no stencil and
are written as 0), with h = 1 / n of the global grid.  The sharded
red-black solve (``lin_solve3d_rb_shard``) runs its blocked passes on
such a slab padded with a deep halo.

A 2D field is small (130^2 float32 is 68 KB).  The 2D solve
(csrc/grid2d.cu) and the whole 2D step (csrc/step2d.cu) are each one
cooperative launch of a persistent block a multiprocessor, their solves
and diffusions blocked in shared memory as the whole 3D step's are
(csrc/step2d_blocked.cuh; ``solve2d_plan``, ``step2d_plan``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpufluids_torch import _build
from tpufluids_torch.grid import stam


def _on_cuda(*tensors, ndim: int = 3, slab: bool = False) -> bool:
    """Validate a kernel's field arguments, cubic (n+2)^3 fields, with
    ``slab`` x-slabs (rows, n+2, n+2) of at least 3 rows, or with
    ``ndim=2`` square (n+2)^2 ones; True for CUDA tensors, False for CPU
    tensors (the plain version runs)."""
    ref = tensors[0]
    shape = tuple(ref.shape)
    square = shape[1:] if slab else shape
    if (ref.dim() != ndim or len(set(square)) != 1 or min(shape) < 3):
        kind = ("an x-slab (rows, n+2, n+2)" if slab else
                f"a {'square' if ndim == 2 else 'cubic'} (n+2)^{ndim} field")
        raise ValueError(f"expected {kind} with n >= 1, got shape {shape}")
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
        raise ValueError("the kernels index cells with int32: the field's "
                         "cells must stay below 2^31")
    return ref.device.type == "cuda"


def _place_args(x, gx0):
    """(n, rows, gx0) of a kernel launch: n from the y extent, a cubic
    field (gx0 None) at gx0 = 0."""
    return x.shape[1] - 2, x.shape[0], 0 if gx0 is None else int(gx0)


# ---------------------------------------------------------------------------
# the plain versions' slab placement (csrc/grid_common.cuh)


def _slab_rows(x, gx0: int):
    """For each local row of slab ``x`` at global row ``gx0``: the local
    row of its clamped global row (clamped into the slab), whether the
    clamp moved it (the x ghost sign applies), and whether that row has
    both x neighbours in the slab (else the cell has no stencil)."""
    rows, n = x.shape[0], x.shape[1] - 2
    g = torch.arange(rows, device=x.device) + gx0
    gc = g.clamp(1, n)
    ci = gc - gx0
    ok = (ci >= 1) & (ci <= rows - 2)
    return ci.clamp(0, rows - 1), gc != g, ok


def _set_bnd_yz_(b: int, x: torch.Tensor) -> torch.Tensor:
    """The y and z faces of set_bnd3d(b), in place, in its order."""
    _, sy, sz = stam._bnd_signs(b)
    x[:, 0] = sy * x[:, 1]
    x[:, -1] = sy * x[:, -2]
    x[:, :, 0] = sz * x[:, :, 1]
    x[:, :, -1] = sz * x[:, :, -2]
    return x


def _placed(core, b: int, rows):
    """A slab output from ``core``, its stencil values on the interior of
    rows 1 .. rows - 2: the y and z ghosts by set_bnd3d(b), each row the
    value at its clamped global row times its x ghost sign, 0 where the
    cell has no stencil."""
    ci, flip, ok = rows
    full = core.new_zeros((len(ci), core.shape[1] + 2, core.shape[2] + 2))
    full[1:-1, 1:-1, 1:-1] = core
    out = _set_bnd_yz_(b, full)[ci]
    if b == 1:
        out = torch.where(flip[:, None, None], -out, out)
    return torch.where(ok[:, None, None], out, 0.0)


# ---------------------------------------------------------------------------
# the x-march of the streamed stencil kernels (csrc/stencil_march.cuh)


@dataclasses.dataclass(frozen=True)
class MarchTile:
    """A shape of a marching stencil kernel: a ``ty`` x ``tz`` (y, z)
    tile of interior cells, ``z`` cells a thread, ``seg`` centre rows a
    segment."""
    ty: int
    tz: int
    z: int
    seg: int


# The shapes csrc/advect.cu and csrc/forcing.cu compile (their
# ``Shipped``; ``march_shapes`` reads them back): change both together.
ADVECT_TILE = MarchTile(8, 64, 2, 8)
FORCING_TILE = MarchTile(8, 32, 1, 32)


@dataclasses.dataclass(frozen=True)
class MarchBlock:
    """One block of a march: its tile's interior cells y0 .. y1 and
    z0 .. z1, its centre rows s0 .. s1 (none when s0 > s1), and whether
    it is in the first and in the last segment."""
    y0: int
    y1: int
    z0: int
    z1: int
    s0: int
    s1: int
    first: bool
    last: bool


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """tf::March of a (rows, n+2, n+2) field at global row gx0: the
    centre rows c_lo .. c_hi (the local rows whose cells have a stencil)
    cut into segments of ``tile.seg`` from c_lo up, and the tiles over
    [1, n]^2, y-major; block i is tile i % tiles of segment i // tiles."""
    n: int
    rows: int
    gx0: int
    tile: MarchTile
    c_lo: int
    c_hi: int

    @property
    def tiles_z(self) -> int:
        return -(-self.n // self.tile.tz)

    @property
    def tiles(self) -> int:
        return self.tiles_z * -(-self.n // self.tile.ty)

    @property
    def segments(self) -> int:
        return max(1, -(-(self.c_hi - self.c_lo + 1) // self.tile.seg))

    @property
    def blocks(self) -> int:
        return self.tiles * self.segments

    def block(self, i: int) -> MarchBlock:
        t, tile, s = self.tile, i % self.tiles, i // self.tiles
        y0 = 1 + tile // self.tiles_z * t.ty
        z0 = 1 + tile % self.tiles_z * t.tz
        s0 = self.c_lo + s * t.seg
        s1 = min(s0 + t.seg - 1, self.c_hi)
        return MarchBlock(y0, min(y0 + t.ty - 1, self.n), z0,
                          min(z0 + t.tz - 1, self.n), s0, s1, s == 0,
                          s1 >= self.c_hi)

    def rows_lo(self, c: int) -> int:
        """The first output row that clamps to centre row c."""
        return 0 if self.gx0 + c == 1 else c

    def rows_hi(self, c: int) -> int:
        """The last output row that clamps to centre row c."""
        return self.rows - 1 if self.gx0 + c == self.n else c


def march_plan(n: int, rows: int, gx0: int, tile: MarchTile) -> MarchPlan:
    return MarchPlan(n, rows, gx0, tile, max(1, 1 - gx0),
                     min(n - gx0, rows - 2))


@functools.cache
def march_shapes() -> dict:
    """The shapes csrc/advect.cu and csrc/forcing.cu were compiled with:
    name -> (MarchTile, threads a block, shared memory bytes a block, at
    K = 3 for advection)."""
    lib = _build.load()
    found = {}
    for name, entry in (("advect3d_multi", "tf_advect3d_shape"),
                        ("forcing3d", "tf_forcing3d_shape")):
        out = (ctypes.c_int * 6)()
        getattr(lib, entry)(out)
        found[name] = (MarchTile(*out[:4]), out[4], out[5])
    return found


def _owned(lo: int, hi: int, n: int):
    """Along y or z: the output indices whose clamped index lies in
    lo .. hi, their positions in lo .. hi, and the ghost sign of each."""
    idx, src = list(range(lo, hi + 1)), list(range(hi - lo + 1))
    sign = [1.0] * len(idx)
    if lo == 1:
        idx, src, sign = [0] + idx, [0] + src, [-1.0] + sign
    if hi == n:
        idx, src, sign = idx + [n + 1], src + [hi - lo], sign + [-1.0]
    return idx, src, sign


def _put(out, value, b: int, x: int, blk: MarchBlock, plan: MarchPlan):
    """tf::for_outputs over a block's tile: ``value`` (its interior cells
    y0 .. y1 x z0 .. z1 of centre row x) into every output cell that
    clamps to one of them, times that cell's set_bnd3d(b) sign."""
    jy, sj, gy = _owned(blk.y0, blk.y1, plan.n)
    kz, sk, gz = _owned(blk.z0, blk.z1, plan.n)
    dev = value.device
    v = value[torch.tensor(sj, device=dev)][:, torch.tensor(sk, device=dev)]
    at = (torch.tensor(jy, device=dev)[:, None],
          torch.tensor(kz, device=dev)[None, :])
    sy = torch.tensor(gy, device=dev)[:, None]
    sz = torch.tensor(gz, device=dev)[None, :]
    for i in range(plan.rows_lo(x), plan.rows_hi(x) + 1):
        sx = -1.0 if i != x else 1.0
        sign = {0: 1.0, 1: sx, 2: sy, 3: sz}[b]
        out[i][at] = sign * v


def _zero_rows(outs, plan: MarchPlan, blk: MarchBlock):
    """tf::zero_rows: 0 in the block's output cells (its tile and the
    ghosts beside it) of the rows without a stencil, below the centre
    rows (first segment) and above them (last segment)."""
    n, any_ = plan.n, plan.c_lo <= plan.c_hi
    below = ((plan.rows_lo(plan.c_lo) if any_ else plan.rows)
             if blk.first else 0)
    above = plan.rows_hi(plan.c_hi) + 1 if blk.last and any_ else plan.rows
    js = slice(0 if blk.y0 == 1 else blk.y0,
               n + 2 if blk.y1 == n else blk.y1 + 1)
    ks = slice(0 if blk.z0 == 1 else blk.z0,
               n + 2 if blk.z1 == n else blk.z1 + 1)
    for out in outs:
        out[:below, js, ks] = 0.0
        out[above:, js, ks] = 0.0


def _staged(fields, p: int, lo_y: int, lo_z: int, hy: int, hz: int,
            shape):
    """A ring plane: the fields' plane p from (lo_y, lo_z) on, clipped to
    the array, placed at the same offset in a NaN plane of ``shape`` (the
    kernel's shared memory holds stale values where nothing is
    staged)."""
    N = fields.shape[-1]
    plane = torch.full(shape, float("nan"), device=fields.device)
    y0, z0 = max(lo_y, 0), max(lo_z, 0)
    y1, z1 = min(lo_y + hy, N), min(lo_z + hz, N)
    plane[:, y0 - lo_y:y1 - lo_y, z0 - lo_z:z1 - lo_z] = \
        fields[:, p, y0:y1, z0:z1]
    return plane


# ---------------------------------------------------------------------------
# advection


def _advect_hats(vels, ias, n: int, dt0: float):
    """The backtrace hats of tf::advect_hats, per axis the three
    max(0, 1 - |off - d|) for d = -1, 0, 1: the offset -dt0 * vel clamped
    to one cell and to the source range [0.5, n + 0.5] around index
    ia."""
    hats = []
    for vel, ia in zip(vels, ias):
        off = torch.clamp(-dt0 * vel, -1.0, 1.0)
        off = torch.clamp(off, 0.5 - ia, n + 0.5 - ia)
        hats.append([torch.clamp(1.0 - torch.abs(off - d), min=0.0)
                     for d in (-1, 0, 1)])
    return hats


def advect3d_multi_plain(fields, bnds, u, v, w, dt0: float, gx0=None):
    """stam._advect_stencil per field, on cubic fields or slabs: the x
    backtrace clamped by the global row."""
    gx0 = 0 if gx0 is None else int(gx0)
    rows, n = u.shape[0], u.shape[1] - 2
    inner = (slice(1, -1),) * 3
    gi = (torch.arange(1, rows - 1, device=u.device) + gx0).to(
        torch.float32).reshape(-1, 1, 1)
    hats = _advect_hats((u[inner], v[inner], w[inner]),
                        (gi, stam._axis_index(n, 1, 3, u.device),
                         stam._axis_index(n, 2, 3, u.device)), n, dt0)
    outs = [torch.zeros((rows - 2, n, n), dtype=torch.float32,
                        device=u.device) for _ in fields]
    for d in stam._SHIFTS[3]:
        wgt = hats[0][d[0] + 1] * hats[1][d[1] + 1] * hats[2][d[2] + 1]
        sl = (slice(1 + d[0], rows - 1 + d[0]),) + tuple(
            slice(1 + da, 1 + da + n) for da in d[1:])
        for out, q in zip(outs, fields):
            out += wgt * q[sl]
    place = _slab_rows(u, gx0)
    return tuple(_placed(out, b, place) for out, b in zip(outs, bnds))


def advect3d_march(fields, bnds, u, v, w, dt0: float, gx0=None,
                   tile: MarchTile = ADVECT_TILE):
    """csrc/advect.cu's x-march in torch ops, block by block and plane by
    plane.  A block stages planes of its tile widened by one cell,
    clipped to the array, into a ring of 4 slots (NaN where the kernel's
    shared memory holds whatever it held); at centre row x it reads the
    velocity (the ring's centre slot when the fields are u, v, w
    themselves, else the field), computes the tile from slots x - 1, x
    and x + 1 with the plain version's arithmetic, writes every output
    cell that clamps to one of its cells with that cell's sign, then
    stages plane x + 2.  The first and the last segment write the rows
    without a stencil as 0.  Every output starts as NaN, so a cell that
    no block writes shows."""
    fields = tuple(fields)
    k, gx0 = len(fields), 0 if gx0 is None else int(gx0)
    rows, n = u.shape[0], u.shape[1] - 2
    plan = march_plan(n, rows, gx0, tile)
    self_advect = k == 3 and all(q is p for q, p in zip(fields, (u, v, w)))
    stacked, vels = torch.stack(fields), torch.stack((u, v, w))
    outs = [torch.full_like(u, float("nan")) for _ in fields]
    ty, tz = tile.ty, tile.tz
    dev = u.device
    for i in range(plan.blocks):
        blk = plan.block(i)
        _zero_rows(outs, plan, blk)
        if blk.s0 > blk.s1:
            continue
        my, mz = blk.y1 - blk.y0 + 1, blk.z1 - blk.z0 + 1
        ring = [None] * 4

        def stage(p):
            ring[p % 4] = _staged(stacked, p, blk.y0 - 1, blk.z0 - 1, my + 2,
                                  mz + 2, (k, ty + 2, tz + 2))

        for p in range(blk.s0 - 1, blk.s0 + 2):
            stage(p)
        iy = torch.arange(blk.y0, blk.y0 + ty, device=dev).to(
            torch.float32)[:, None]
        iz = torch.arange(blk.z0, blk.z0 + tz, device=dev).to(
            torch.float32)[None, :]
        for x in range(blk.s0, blk.s1 + 1):
            if self_advect:
                vel = ring[x % 4][:, 1:1 + ty, 1:1 + tz]
            else:
                vel = torch.full((3, ty, tz), float("nan"), device=dev)
                vel[:, :my, :mz] = vels[:, x, blk.y0:blk.y1 + 1,
                                        blk.z0:blk.z1 + 1]
            ix = torch.full((1, 1), float(gx0 + x), device=dev)
            hats = _advect_hats(vel, (ix, iy, iz), n, dt0)
            acc = [torch.zeros((ty, tz), device=dev) for _ in fields]
            for d in stam._SHIFTS[3]:
                wgt = hats[0][d[0] + 1] * hats[1][d[1] + 1] * hats[2][d[2] + 1]
                src = ring[(x + d[0]) % 4]
                for q in range(k):
                    acc[q] = acc[q] + wgt * src[q, 1 + d[1]:1 + d[1] + ty,
                                                1 + d[2]:1 + d[2] + tz]
            for q in range(k):
                _put(outs[q], acc[q][:my, :mz], bnds[q], x, blk, plan)
            if x + 2 <= blk.s1 + 1:
                stage(x + 2)
    return tuple(outs)


def advect3d_multi(fields, bnds, u, v, w, dt0: float, gx0=None):
    """27-tap stencil advection of ``fields`` (1 to 3) by (u, v, w), then
    set_bnd3d(b) per field with b from ``bnds``; as
    stam.advect3d_stencil per field.  ``gx0``: the fields are x-slabs
    whose row 0 is global row gx0 (None: cubic fields).

    Replaces advect3d_multi_pallas (tpufluids/grid/pallas_kernels.py),
    its gx0/gn slab placement included.  One launch of csrc/advect.cu's
    x-march (``advect3d_march`` emulates it): a block owns a (y, z) tile
    and a segment of x rows, stages each x-plane of the fields in shared
    memory once, and computes a cell's backtrace weights once for all
    its fields.  Bound by bytes: the fields and the velocity in (3 fields
    when a velocity advects itself), k out."""
    fields, bnds = tuple(fields), tuple(bnds)
    if not 1 <= len(fields) <= 3 or len(bnds) != len(fields):
        raise ValueError("advect3d_multi takes 1 to 3 fields, one b each")
    if any(b not in (0, 1, 2, 3) for b in bnds):
        raise ValueError(f"set_bnd modes must be 0..3, got {bnds}")
    if not _on_cuda(u, v, w, *fields, slab=gx0 is not None):
        return advect3d_multi_plain(fields, bnds, u, v, w, dt0, gx0)
    k = len(fields)
    outs = tuple(torch.empty_like(u) for _ in fields)
    pad = (None,) * (3 - k)
    _build.launch("tf_advect3d", u, v, w, *fields, *pad, *outs, *pad, k,
                  *bnds, *(0,) * (3 - k), *_place_args(u, gx0), dt0)
    advect3d_multi.launches += 1
    return outs


advect3d_multi.launches = 0


# ---------------------------------------------------------------------------
# forcing: the plain version's arithmetic as value functions of a cell's
# neighbours, which forcing3d_plain and the emulation share (csrc/forcing.cuh)


def _half_diff(hi, lo, h: float):
    """0.5 (hi - lo) / h.  On the card torch's division by the Python
    scalar h runs as a product with fl(1 / h), which the kernels take as
    inv_h."""
    return 0.5 * (hi - lo) / h


def _curl(u_yp, u_ym, u_zp, u_zm, v_zp, v_zm, v_xp, v_xm, w_yp, w_ym, w_xp,
          w_xm, h: float):
    """tf::curl_of: the curl at cells from their neighbours' values."""
    return (_half_diff(w_yp, w_ym, h) - _half_diff(v_zp, v_zm, h),
            _half_diff(u_zp, u_zm, h) - _half_diff(w_xp, w_xm, h),
            _half_diff(v_xp, v_xm, h) - _half_diff(u_yp, u_ym, h))


def _curl_mag(wx, wy, wz):
    return torch.sqrt(wx * wx + wy * wy + wz * wz)


def _confine(u, v, w, wx, wy, wz, m_xp, m_xm, m_yp, m_ym, m_zp, m_zm,
             dt: float, eps_h: float, h: float):
    """tf::confine: u, v, w plus dt eps h (N x curl), N the normalised
    gradient of |curl|."""
    gx = _half_diff(m_xp, m_xm, h)
    gy = _half_diff(m_yp, m_ym, h)
    gz = _half_diff(m_zp, m_zm, h)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    return (u + dt * (eps_h * (gy * wz - gz * wy)),
            v + dt * (eps_h * (gz * wx - gx * wz)),
            w + dt * (eps_h * (gx * wy - gy * wx)))


def _w_prime(w, dens, temp, cfg: stam.StamConfig, ci):
    """w after buoyancy at every row's clamped global row ``ci``, the y
    and z ghosts by set_bnd3d(3): the w the curl reads."""
    f = (-cfg.buoyancy_alpha * dens[:, 1:-1, 1:-1]
         + cfg.buoyancy_beta * (temp[:, 1:-1, 1:-1] - cfg.ambient_temp))
    full = torch.zeros_like(w)
    full[:, 1:-1, 1:-1] = w[:, 1:-1, 1:-1] + cfg.dt * f
    return _set_bnd_yz_(3, full)[ci]


def _neighbour(q, axis: int, s: int):
    """q at the interior cells' neighbour s (-1 or 1) along ``axis``."""
    sl = [slice(1, -1)] * 3
    sl[axis] = slice(1 + s, q.shape[axis] - 1 + s)
    return q[tuple(sl)]


def _curl_at_interior(u, v, w, h: float):
    nb = _neighbour
    return _curl(nb(u, 1, 1), nb(u, 1, -1), nb(u, 2, 1), nb(u, 2, -1),
                 nb(v, 2, 1), nb(v, 2, -1), nb(v, 0, 1), nb(v, 0, -1),
                 nb(w, 1, 1), nb(w, 1, -1), nb(w, 0, 1), nb(w, 0, -1), h)


def forcing3d_plain(u, v, w, dens, temp, cfg: stam.StamConfig, gx0=None):
    """Buoyancy and vorticity confinement as torch ops, on cubic fields or
    slabs, in the two halves the whole step of csrc/step.cu runs: half A
    gives w' = stam.buoyancy3d's w (0 on the rows without a stencil) and
    |curl| of (u, v, w') (0 off the interior), half B the confined u, v,
    w of stam.vorticity_confinement3d from half A's w' and |curl|."""
    gx0 = 0 if gx0 is None else int(gx0)
    n = u.shape[1] - 2
    h = 1.0 / n
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    place = _slab_rows(u, gx0)
    ci, flip, ok = place
    inner = (slice(1, -1),) * 3
    wp = w
    if buoy:
        wp = _w_prime(w, dens, temp, cfg, ci)
        w = torch.where(ok[:, None, None], wp, 0.0)
    if not cfg.vorticity_eps:
        return u, v, w
    mag = torch.zeros_like(u)
    mag[inner] = _curl_mag(*_curl_at_interior(u, v, wp, h))
    mag = torch.where((ok & ~flip)[:, None, None], mag, 0.0)
    # half B reads half A's w'
    nb = _neighbour
    outs = _confine(u[inner], v[inner], w[inner], *_curl_at_interior(u, v, w, h),
                    nb(mag, 0, 1), nb(mag, 0, -1), nb(mag, 1, 1),
                    nb(mag, 1, -1), nb(mag, 2, 1), nb(mag, 2, -1), cfg.dt,
                    cfg.vorticity_eps * h, h)
    return tuple(_placed(f, b, place) for b, f in zip((1, 2, 3), outs))


def forcing3d_march(u, v, w, dens, temp, cfg: stam.StamConfig, gx0=None,
                    tile: MarchTile = FORCING_TILE):
    """csrc/forcing.cu's x-march in torch ops, block by block and plane
    by plane.  A block stages planes of u, v and w' (w' computed at the
    clamped cell, as the kernel computes it when it stages a cell) over
    its tile widened by 2, clipped to the array, into a ring of 6 slots
    (NaN where nothing is staged); |curl| of plane x + 1 over the tile
    widened by 1 into a ring of 4 (0 off the interior); then the
    confined cells of plane x, reading half A's w' as 0 on a row without
    a stencil; then it stages plane x + 3.  Outputs start as NaN, as in
    advect3d_march.  With buoyancy alone the kernel is one elementwise
    pass, as forcing3d_plain."""
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    if not cfg.vorticity_eps:
        return forcing3d_plain(u, v, w, dens, temp, cfg, gx0)
    gx0 = 0 if gx0 is None else int(gx0)
    rows, n = u.shape[0], u.shape[1] - 2
    h = 1.0 / n
    ci, _, ok = _slab_rows(u, gx0)
    wp = _w_prime(w, dens, temp, cfg, ci) if buoy else w
    stacked = torch.stack((u, v, wp))
    plan = march_plan(n, rows, gx0, tile)
    outs = [torch.full_like(u, float("nan")) for _ in range(3)]
    ty, tz = tile.ty, tile.tz
    dev = u.device
    for i in range(plan.blocks):
        blk = plan.block(i)
        _zero_rows(outs, plan, blk)
        if blk.s0 > blk.s1:
            continue
        my, mz = blk.y1 - blk.y0 + 1, blk.z1 - blk.z0 + 1
        ring, mags = [None] * 6, [None] * 4
        yy = torch.arange(blk.y0 - 1, blk.y0 + ty + 1, device=dev)
        zz = torch.arange(blk.z0 - 1, blk.z0 + tz + 1, device=dev)
        interior = (((yy >= 1) & (yy <= n))[:, None]
                    & ((zz >= 1) & (zz <= n))[None, :])

        def stage(p):
            if 0 <= p <= rows - 1:
                ring[p % 6] = _staged(stacked, p, blk.y0 - 2, blk.z0 - 2,
                                      my + 4, mz + 4, (3, ty + 4, tz + 4))

        def at(p, f, dy, dz, e):
            """Field f of ring plane p over the tile widened by e, shifted
            by (dy, dz)."""
            return ring[p % 6][f, 2 - e + dy:2 + ty + e + dy,
                               2 - e + dz:2 + tz + e + dz]

        def curl_plane(p):
            mag = torch.zeros((ty + 2, tz + 2), device=dev)
            if 1 <= p <= rows - 2 and 1 <= gx0 + p <= n:
                def a(f, dy, dz, dx=0):
                    return at(p + dx, f, dy, dz, 1)
                m = _curl_mag(*_curl(a(0, 1, 0), a(0, -1, 0), a(0, 0, 1),
                                     a(0, 0, -1), a(1, 0, 1), a(1, 0, -1),
                                     a(1, 0, 0, 1), a(1, 0, 0, -1),
                                     a(2, 1, 0), a(2, -1, 0), a(2, 0, 0, 1),
                                     a(2, 0, 0, -1), h))
                mag = torch.where(interior, m, 0.0)
            mags[p % 4] = mag

        for p in range(blk.s0 - 2, blk.s0 + 3):
            stage(p)
        curl_plane(blk.s0 - 1)
        curl_plane(blk.s0)
        for x in range(blk.s0, blk.s1 + 1):
            curl_plane(x + 1)

            def c(f, dy, dz, dx=0):
                return at(x + dx, f, dy, dz, 0)

            def m(dx, dy, dz):
                return mags[(x + dx) % 4][1 + dy:1 + dy + ty,
                                          1 + dz:1 + dz + tz]

            zero = torch.zeros((ty, tz), device=dev)
            w_xp = c(2, 0, 0, 1) if not buoy or ok[x + 1] else zero
            w_xm = c(2, 0, 0, -1) if not buoy or ok[x - 1] else zero
            wx, wy, wz = _curl(c(0, 1, 0), c(0, -1, 0), c(0, 0, 1),
                               c(0, 0, -1), c(1, 0, 1), c(1, 0, -1),
                               c(1, 0, 0, 1), c(1, 0, 0, -1), c(2, 1, 0),
                               c(2, -1, 0), w_xp, w_xm, h)
            forced = _confine(c(0, 0, 0), c(1, 0, 0), c(2, 0, 0), wx, wy, wz,
                              m(1, 0, 0), m(-1, 0, 0), m(0, 1, 0),
                              m(0, -1, 0), m(0, 0, 1), m(0, 0, -1), cfg.dt,
                              cfg.vorticity_eps * h, h)
            for q, f in enumerate(forced):
                _put(outs[q], f[:my, :mz], q + 1, x, blk, plan)
            if x + 3 <= blk.s1 + 2:
                stage(x + 3)
    return tuple(outs)


def forcing3d(u, v, w, dens, temp, cfg: stam.StamConfig, gx0=None):
    """Buoyancy on w (if alpha or beta) then vorticity confinement (if
    eps), each with its set_bnd; as stam.buoyancy3d followed by
    stam.vorticity_confinement3d.  ``gx0``: the fields are x-slabs
    whose row 0 is global row gx0 (None: cubic fields); a slab's outer
    two rows a side have no stencil.

    Replaces forcing3d_pallas (tpufluids/grid/pallas_kernels.py), its
    gx0/gn slab placement included.  One launch of csrc/forcing.cu: with
    vorticity, an x-march (``forcing3d_march`` emulates it) that stages
    u, v and w' (w after buoyancy) with a halo of 2 and |curl| with a
    halo of 1 in shared memory, as the TPU kernel held its halo of 2 in
    VMEM; with buoyancy alone, an elementwise pass writing w'.  Bound by
    bytes: u, v, w, dens and temp in and u, v, w out (without buoyancy
    u, v, w in)."""
    if not _on_cuda(u, v, w, dens, temp, slab=gx0 is not None):
        return forcing3d_plain(u, v, w, dens, temp, cfg, gx0)
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    if not (buoy or vort):
        return u, v, w
    place = _place_args(u, gx0)
    h = 1.0 / place[0]
    outs = (tuple(torch.empty_like(u) for _ in range(3)) if vort
            else (None, None, torch.empty_like(w)))
    # the plain version's tensor / h runs on the card as tensor * fl(1 / h),
    # the reciprocal taken in double: the kernel multiplies by 1 / h
    _build.launch("tf_forcing3d", u, v, w, dens, temp, *outs, *place,
                  int(buoy), int(vort), cfg.dt, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta, cfg.ambient_temp,
                  cfg.vorticity_eps * h, 1.0 / h)
    forcing3d.launches += 1
    return outs if vort else (u, v, outs[2])


forcing3d.launches = 0


# ---------------------------------------------------------------------------
# projection: divergence and gradient subtraction


def div3d_plain(u, v, w, gx0=None):
    return _placed(stam.divergence3d(u, v, w), 0,
                   _slab_rows(u, 0 if gx0 is None else int(gx0)))


def div3d(u, v, w, gx0=None):
    """set_bnd3d(0, divergence3d(u, v, w) on the interior): the
    right-hand side of the pressure solve.  ``gx0``: the fields are
    x-slabs whose row 0 is global row gx0 (None: cubic fields).

    Replaces div3d_pallas (tpufluids/grid/pallas_kernels.py), with its
    h = 1 / n_global on slabs.  Bound by
    bytes: 3 fields in, 1 out (csrc/divgrad.cu)."""
    if not _on_cuda(u, v, w, slab=gx0 is not None):
        return div3d_plain(u, v, w, gx0)
    place = _place_args(u, gx0)
    out = torch.empty_like(u)
    _build.launch("tf_div3d", u, v, w, out, *place, -0.5 * (1.0 / place[0]))
    div3d.launches += 1
    return out


div3d.launches = 0


def gradsub3d_plain(p, u, v, w, gx0=None):
    h = 1.0 / (u.shape[1] - 2)
    place = _slab_rows(u, 0 if gx0 is None else int(gx0))
    out = []
    for axis, (b, q) in enumerate(((1, u), (2, v), (3, w))):
        hi, lo = [slice(1, -1)] * 3, [slice(1, -1)] * 3
        hi[axis] = slice(2, None)
        lo[axis] = slice(0, -2)
        out.append(_placed(q[stam._I] + -0.5 * (p[tuple(hi)]
                                                - p[tuple(lo)]) / h,
                           b, place))
    return tuple(out)


def gradsub3d(p, u, v, w, gx0=None):
    """Subtract the pressure gradient 0.5 (p[+1] - p[-1]) / h from each
    velocity component, then set_bnd3d(1 / 2 / 3): the tail of
    stam.project3d.  ``gx0``: the fields are x-slabs whose row 0 is
    global row gx0 (None: cubic fields).

    Replaces gradsub3d_pallas (tpufluids/grid/pallas_kernels.py), with
    its h = 1 / n_global on slabs.  Bound
    by bytes: 4 fields in, 3 out (csrc/divgrad.cu)."""
    if not _on_cuda(p, u, v, w, slab=gx0 is not None):
        return gradsub3d_plain(p, u, v, w, gx0)
    place = _place_args(u, gx0)
    outs = tuple(torch.empty_like(u) for _ in range(3))
    h = 1.0 / place[0]
    _build.launch("tf_gradsub3d", p, u, v, w, *outs, *place, 1.0 / h)
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


def solve_whole_ok(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """True when a solve of fields shaped like ``x``, stored as
    ``dtype``, takes the whole tier (lin_solve3d_whole): up to n = 99
    stored as float32, n = 126 as bfloat16.  The whole and streamed
    solves compute the same function, so the gate only decides speed."""
    return x.numel() * dtype.itemsize <= WHOLE_MAX_FIELD_BYTES


def step_whole_ok(x: torch.Tensor) -> bool:
    """True when fields shaped like ``x`` take the whole step
    (step3d_whole)."""
    return x.numel() * x.element_size() <= STEP_MAX_FIELD_BYTES


def _check_solve(b: int, iters: int):
    if b not in (0, 1, 2, 3):
        raise ValueError(f"set_bnd mode must be 0..3, got {b}")
    if not isinstance(iters, int) or iters < 1:
        raise ValueError(f"iters must be an int >= 1, got {iters!r}")


def _solve_on_cuda(b, x, x0, iters, slab=False) -> bool:
    _check_solve(b, iters)
    return (_on_cuda(x0, slab=slab) if x is None
            else _on_cuda(x, x0, slab=slab))


def lin_solve3d_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters)


def lin_solve3d(b, x, x0, a, c, iters):
    """``iters`` Jacobi sweeps of (x0 + a * sum of neighbours) / c, each
    followed by set_bnd3d(b); as stam.lin_solve3d.  ``x`` None is a zero
    initial guess.

    Replaces lin_solve3d_pallas (tpufluids/grid/pallas_kernels.py).
    Bound on paper by bytes; on the card, with the bytes cut, by the
    multiprocessor's work a level (PERF.md).  ceil(iters / k) launches of
    the blocked kernel in float32 storage, each up to k = JACOBI_TILE.k
    sweeps with one read of x and x0 and one write of every cell, ghosts
    included, alternating between out and a scratch buffer so that the
    last lands in out (csrc/jacobi_blocked.cu)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_plain(b, x, x0, a, c, iters)
    out = _jacobi_solve(b, x, x0, a, 1.0 / c, iters)
    lin_solve3d.launches += 1
    return out


lin_solve3d.launches = 0


def lin_solve3d_rb_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters, red_black=True)


# the temporally blocked red-black passes (csrc/rb_blocked.cu): the pass
# schedule and the x-chunks live here, where the CPU tests reach them


@dataclasses.dataclass(frozen=True)
class RbTile:
    """A shape of a blocked kernel: up to ``k`` half-sweeps (red-black)
    or sweeps (Jacobi) a pass on a ``ty`` x ``tz`` (y, z) tile with a
    k-deep halo."""
    k: int
    ty: int
    tz: int

    def tiles(self, n: int) -> int:
        return -(-n // self.ty) * -(-n // self.tz)


# The shapes csrc/rb_blocked.cu compiles (its ``ShapeOf``), in float32 and
# in bfloat16: the fastest at the main path's shapes on the H100 of those
# measured, and in float32 for fields of n <= RB_SMALL_N, where the large
# tile leaves most of the card idle, the fastest at multigrid's coarse
# levels (PERF.md).
RB_TILE = RbTile(4, 32, 64)
RB_TILE_SMALL = RbTile(4, 16, 32)
RB_SMALL_N = 64
RB_TILE_BF16 = RbTile(4, 48, 64)


def rb_tile(dtype: torch.dtype, n: int) -> RbTile:
    """The blocked red-black kernel's shape in storage ``dtype`` on a
    field of n^2 cells a plane."""
    if dtype == torch.bfloat16:
        return RB_TILE_BF16
    return RB_TILE_SMALL if n <= RB_SMALL_N else RB_TILE


@dataclasses.dataclass(frozen=True)
class RbPass:
    """One launch: ``half_sweeps`` half-sweeps from parity ``parity``;
    ``first``: its first is the solve's first (the stored ghosts, or
    zeros for a zero guess)."""
    half_sweeps: int
    parity: int
    first: bool


def rb_passes(half_sweeps: int, k: int, first: bool = True):
    """The launches of ``half_sweeps`` half-sweeps (parities 0, 1, 0,
    ...) at up to ``k`` a launch; the last does the rest."""
    return [RbPass(min(k, half_sweeps - h0), h0 & 1, first and h0 == 0)
            for h0 in range(0, half_sweeps, k)]


def rb_lands_in_out(i: int, passes: int) -> bool:
    """Pass i of a dense solve writes ``out`` (else the scratch buffer):
    the two alternate, and the last pass lands in out."""
    return (passes - 1 - i) % 2 == 0


@dataclasses.dataclass(frozen=True)
class RbChunks:
    """The x-chunks of a pass over local rows r_lo .. r_hi (those whose
    global row is interior, the slab's outermost rows excluded): chunk i
    owns rows [r_lo + i length, min(r_lo + (i+1) length, r_hi + 1))."""
    r_lo: int
    r_hi: int
    length: int
    count: int

    def rows(self, i: int, h: int):
        """(c0, c1, lo, hi) of chunk i in a pass of h half-sweeps: it
        owns rows [c0, c1) and its levels read rows lo .. hi (h more a
        side, clipped below at r_lo - 1).  The kernels also fetch rows
        hi + 1 and hi + 2 where they exist, which no level reads."""
        c0 = self.r_lo + i * self.length
        c1 = min(c0 + self.length, self.r_hi + 1)
        return c0, c1, max(c0 - h + 1, self.r_lo) - 1, c1 + h - 1


@functools.cache
def rb_chunks(rows: int, gx0: int, n: int, tile: RbTile,
              slots: int) -> RbChunks:
    """The x-chunks of a (rows, n+2, n+2) field at global row gx0, chosen
    so that tiles x chunks blocks, in waves of ``slots`` resident blocks,
    stream the fewest rows: each chunk streams its rows and about 2k
    more (its halo rows, and the steps the wavefront's levels trail
    by)."""
    r_lo, r_hi = max(1, 1 - gx0), min(n - gx0, rows - 2)
    nr = r_hi - r_lo + 1
    if nr < 1:
        raise ValueError(f"a ({rows}, {n + 2}, {n + 2}) field at gx0={gx0} "
                         f"has no interior row")
    tiles = tile.tiles(n)
    best = None
    for want in range(1, nr + 1):
        length = -(-nr // want)
        count = -(-nr // length)
        cost = -(-tiles * count // slots) * (length + 2 * tile.k)
        if best is None or cost < best[0]:
            best = (cost, length, count)
    return RbChunks(r_lo, r_hi, best[1], best[2])


def _tile_info(entry: str, device_index: int, *args):
    """(resident blocks on the card, dynamic shared memory bytes a block)
    of a blocked kernel on CUDA device ``device_index`` from its C entry
    ``entry``, which first sets the kernel's shared-memory attribute
    there: its launches need it (a launch without it is refused)."""
    lib = _build.load()
    slots, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, entry)(*args, ctypes.byref(slots),
                                 ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
    return slots.value, smem.value


@functools.cache
def rb_tile_info(device_index: int, dtype: torch.dtype, n: int):
    """_tile_info of the blocked red-black kernel's shape in storage
    ``dtype`` (float32 or bfloat16) for n (rb_tile), each shape compiled
    for every half-sweep count 1 .. k: once a device, type and n."""
    return _tile_info("tf_rb_blocked_info", device_index,
                      int(dtype == torch.bfloat16), n)


def _device_index(t) -> int:
    return (torch.cuda.current_device() if t.device.index is None
            else t.device.index)


def _rb_pass(src, x0, dst, gx0, chunks, p: RbPass, b, a, c_inv):
    _build.launch("tf_rb_blocked_pass", src, x0, dst, x0.shape[0], gx0,
                  x0.shape[1] - 2, chunks.r_lo, chunks.r_hi, chunks.length,
                  chunks.count, p.half_sweeps, p.parity, int(p.first), b,
                  int(x0.dtype == torch.bfloat16), a, c_inv)


def _rb_chunks_on(x0, gx0):
    n = x0.shape[1] - 2
    slots, _ = rb_tile_info(_device_index(x0), x0.dtype, n)
    return rb_chunks(x0.shape[0], gx0, n, rb_tile(x0.dtype, n), slots)


def _rb_solve(b, x, x0, a, c_inv, iters):
    """The dense blocked red-black solve in x0's storage type (float32 or
    bfloat16): ceil(2 iters / k) passes, alternating between out and a
    scratch buffer so that the last lands in out, then the ghost pass."""
    out, tmp = torch.empty_like(x0), torch.empty_like(x0)
    chunks = _rb_chunks_on(x0, 0)
    passes = rb_passes(2 * iters, rb_tile(x0.dtype, x0.shape[1] - 2).k)
    src = x
    for i, p in enumerate(passes):
        dst = out if rb_lands_in_out(i, len(passes)) else tmp
        _rb_pass(src, x0, dst, 0, chunks, p, b, a, c_inv)
        src = dst
    _build.launch("tf_rb_ghosts", out, x0.shape[0] - 2, b,
                  int(x0.dtype == torch.bfloat16))
    return out


def lin_solve3d_rb(b, x, x0, a, c, iters):
    """``iters`` red-black Gauss-Seidel iterations, each two half-sweeps
    (parity 0, then 1) followed by set_bnd3d(b); as
    stam.lin_solve3d(red_black=True).  ``x`` None is a zero initial
    guess.

    Replaces lin_solve3d_rb_packed (tpufluids/grid/pallas_kernels.py).
    Bound on paper by bytes; on the card, with the bytes cut, by the
    multiprocessor's work a level (PERF.md).  ceil(2 iters / k) launches
    of the temporally blocked kernel, each up to k half-sweeps with one
    read of x and x0 and one write, alternating between out and a
    scratch buffer so that the last lands in out; then one launch that
    writes the ghosts (csrc/rb_blocked.cu)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_rb_plain(b, x, x0, a, c, iters)
    out = _rb_solve(b, x, x0, a, 1.0 / c, iters)
    lin_solve3d_rb.launches += 1
    return out


lin_solve3d_rb.launches = 0


# the sharded red-black solve on one deep-padded x-slab


def rb_shard_plan(c_local: int, iters: int) -> int:
    """The iterations per halo exchange (``fuse``) of
    lin_solve3d_rb_shard on a slab of ``c_local`` rows: the largest of
    4, 2 and 1 that divides ``iters`` and whose halo of 2 fuse rows a
    side one neighbouring slab can fill (2 fuse <= c_local); the fuse
    of rb_shard_plan (tpufluids/grid/pallas_kernels.py), which also
    sizes TPU windows."""
    for fuse in (4, 2, 1):
        if iters % fuse == 0 and 2 * fuse <= c_local:
            return fuse
    raise ValueError(f"a slab of {c_local} x rows cannot host the minimal "
                     f"halo of 2 rows (needs c_local >= 2)")


def _rb_shard_shape(b, x0, iters, fuse):
    """(c_local, halo) of a sharded solve, after validating it."""
    _check_solve(b, iters)
    if not isinstance(fuse, int) or fuse < 1 or iters % fuse:
        raise ValueError(f"iters={iters} must be a multiple of fuse={fuse}")
    halo = 2 * fuse
    c_local = x0.shape[0] - 2 * halo
    if c_local < halo:
        raise ValueError(f"{x0.shape[0]} rows hold fewer owned rows than "
                         f"the halo of {halo}")
    if c_local % 2:
        raise ValueError(f"c_local={c_local} must be even")
    return c_local, halo


def lin_solve3d_rb_shard_plain(b, x, x0, a, c, iters, *, gx0, fuse,
                               exchange=None):
    _, halo = _rb_shard_shape(b, x0, iters, fuse)
    rows, n = x0.shape[0], x0.shape[1] - 2
    c_inv = 1.0 / c
    sx = stam._bnd_signs(b)[0]
    x = torch.zeros_like(x0) if x is None else x.clone()
    # rows 1 .. rows - 2 by their 0-based global interior index
    i = torch.arange(rows - 2, device=x0.device) + gx0
    jk = torch.arange(n, device=x0.device)
    m0 = (i[:, None, None] + jk[None, :, None] + jk[None, None, :]) % 2 == 0
    inside = ((i >= 0) & (i < n))[:, None, None]
    lo, hi = -gx0, n + 1 - gx0       # the local rows of the x ghosts
    for p in range(iters // fuse):
        if p:
            exchange(x)
        for _ in range(fuse):
            for m in (m0, ~m0):
                x[stam._I] = torch.where(m & inside,
                                         stam._jacobi_new(x, x0, a, c_inv),
                                         x[stam._I])
                # set_bnd3d(b): the x ghost rows in the slab, then y and z
                if 0 <= lo < rows - 1:
                    x[lo] = sx * x[lo + 1]
                if 1 <= hi < rows:
                    x[hi] = sx * x[hi - 1]
                _set_bnd_yz_(b, x)
    return x[halo:rows - halo].clone()


def lin_solve3d_rb_shard(b, x, x0, a, c, iters, *, gx0, fuse,
                         exchange=None):
    """``iters`` red-black iterations, as lin_solve3d_rb, on one x-slab of
    the sharded step.  ``x0`` and ``x`` (None: a zero initial guess) are
    deep-padded slabs (c_local + 4 fuse, n+2, n+2): c_local owned rows
    between halos of 2 fuse rows, row 0 at global row ``gx0``, the pad
    rows filled by the caller (at a domain face the set_bnd ghost row).
    Every ``fuse`` iterations but the first, ``exchange(slab)`` refreshes
    the pad rows of the working slab in place: it must rewrite every pad
    row that lies in the grid, on either route, since a stale one reaches
    the owned rows within a pass (grid_sharded._refresh_pad_ rewrites
    every pad row); None is allowed for one pass (iters == fuse).  The
    rows the kernel never writes start as zeros, so an exchange that
    misses one gives wrong rows, not uninitialised memory.  Returns the
    c_local owned rows with their y and z ghosts.  Stitched, the slabs'
    results equal
    lin_solve3d_rb on the whole grid bit for bit when x's x ghosts are
    set_bnd-consistent; the plain version runs the dense solver's
    half-sweeps and set_bnd on the slab.

    Replaces lin_solve3d_rb_shard (tpufluids/grid/pallas_kernels.py).
    Bound as lin_solve3d_rb.  A pass of 2 fuse half-sweeps is
    ceil(2 fuse / k) launches of the temporally blocked kernel, out of
    place between two buffers (the exchange refreshes the pad of the one
    the last launch wrote), then one launch writes the owned rows out
    (csrc/rb_blocked.cu, csrc/jacobi_shard.cu)."""
    if not _solve_on_cuda(b, x, x0, iters, slab=True):
        return lin_solve3d_rb_shard_plain(b, x, x0, a, c, iters, gx0=gx0,
                                          fuse=fuse, exchange=exchange)
    c_local, halo = _rb_shard_shape(b, x0, iters, fuse)
    if iters > fuse and exchange is None:
        raise ValueError("more than one pass needs an exchange")
    gx0 = int(gx0)
    chunks = _rb_chunks_on(x0, gx0)
    bufs = (torch.empty_like(x0), torch.empty_like(x0))
    for q in bufs:
        q[:chunks.r_lo].zero_()
        q[chunks.r_hi + 1:].zero_()
    src, launches = x, 0
    for sp in range(iters // fuse):
        if sp:
            exchange(src)
        for p in rb_passes(2 * fuse, rb_tile(x0.dtype, x0.shape[1] - 2).k,
                           first=sp == 0):
            dst = bufs[launches % 2]
            _rb_pass(src, x0, dst, gx0, chunks, p, b, a, 1.0 / c)
            src, launches = dst, launches + 1
    out = torch.empty((c_local,) + tuple(x0.shape[1:]), dtype=x0.dtype,
                      device=x0.device)
    _build.launch("tf_rb_shard_finish", src, out, c_local, halo,
                  x0.shape[1] - 2, b)
    lin_solve3d_rb_shard.launches += 1
    return out


lin_solve3d_rb_shard.launches = 0


# the solves in bfloat16: x and x0 are cast to bfloat16 and the result
# back to float32 by torch ops around the launch, as the reference casts
# around its pallas_call; a and 1 / c are rounded to bfloat16 here, as the
# reference's weak-typed scalars are


def _bf16_operands(x, x0, a, c):
    bf16 = torch.bfloat16
    return (None if x is None else x.to(bf16), x0.to(bf16),
            stam.round_scalar(a, bf16), stam.round_scalar(1.0 / c, bf16))


def lin_solve3d_bf16_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters, dtype=torch.bfloat16)


# the blocked Jacobi passes (csrc/jacobi_blocked.cu)


# The shapes csrc/jacobi_blocked.cu compiles (its ``Shape``), in float32
# and in bfloat16: k sweeps a pass on a ty x tz tile (its z halo deeper
# than k, so that a slot's cells start at K = 0 mod the cells a slot: 4
# in float32, 192 threads; 2 in bfloat16, 384 threads).  k = 2 is the
# reference's fuse; the float32 shape is the fastest of the probe's at
# 256^3 on the H100 (PERF.md), the bfloat16 one at 512^3.
JACOBI_TILE = RbTile(2, 16, 64)
JACOBI_TILE_BF16 = RbTile(2, 16, 128)


def jacobi_tile(dtype: torch.dtype) -> RbTile:
    """The blocked Jacobi kernel's shape in storage ``dtype``."""
    return JACOBI_TILE_BF16 if dtype == torch.bfloat16 else JACOBI_TILE


def jacobi_passes(iters: int, k: int):
    """The sweeps of each launch of an ``iters``-sweep solve at up to
    ``k`` a launch; the last does the rest."""
    return [min(k, iters - s0) for s0 in range(0, iters, k)]


@functools.cache
def jacobi_tile_info(device_index: int, dtype: torch.dtype = torch.float32):
    """_tile_info of the blocked Jacobi kernel in storage ``dtype``
    (float32 or bfloat16, one instantiation each): once a device and
    type."""
    return _tile_info("tf_jacobi_blocked_info", device_index,
                      int(dtype == torch.bfloat16))


def _jacobi_chunks_on(x0):
    slots, _ = jacobi_tile_info(_device_index(x0), x0.dtype)
    n = x0.shape[0] - 2
    return rb_chunks(n + 2, 0, n, jacobi_tile(x0.dtype), slots)


def _jacobi_pass(src, x0, dst, chunks, sweeps, b, a, c_inv):
    _build.launch("tf_jacobi_blocked_pass", src, x0, dst, x0.shape[0] - 2,
                  chunks.r_lo, chunks.r_hi, chunks.length, chunks.count,
                  sweeps, b, int(x0.dtype == torch.bfloat16), a, c_inv)


@dataclasses.dataclass(frozen=True)
class JacobiProbeShape:
    """One float32 shape of csrc/jacobi_blocked.cu's probe (its
    ``Probe``): ``tile`` (k sweeps a pass on ty x tz), ``threads`` a
    block, ``cells`` a thread's slot, whether it is the shipped
    ``Shape``, the card's resident blocks and the shared memory of
    one."""
    index: int
    tile: RbTile
    threads: int
    cells: int
    shipped: bool
    slots: int
    smem: int


@functools.cache
def jacobi_probe_shapes(device_index: int):
    """The probe's shapes on CUDA device ``device_index`` (setting each
    kernel's shared-memory attribute there): once a device."""
    lib = _build.load()
    shapes = []
    with torch.cuda.device(device_index):
        while True:
            dims = (ctypes.c_int * 6)()
            slots, smem = ctypes.c_int(0), ctypes.c_int(0)
            rc = lib.tf_jacobi_probe_info(len(shapes), dims,
                                          ctypes.byref(slots),
                                          ctypes.byref(smem))
            if rc == -1:
                return tuple(shapes)
            if rc:
                raise RuntimeError(f"tf_jacobi_probe_info: CUDA error {rc} "
                                   f"({lib.tf_error_string(rc).decode()})")
            shapes.append(JacobiProbeShape(
                len(shapes), RbTile(*dims[:3]), dims[3], dims[4],
                bool(dims[5]), slots.value, smem.value))


def lin_solve3d_probe(shape: JacobiProbeShape, b, x, x0, a, c, iters):
    """lin_solve3d's passes on CUDA float32 fields with probe shape
    ``shape`` (one of jacobi_probe_shapes): the shipped one runs
    lin_solve3d's launches."""
    n = x0.shape[0] - 2
    chunks = rb_chunks(n + 2, 0, n, shape.tile, shape.slots)
    return _alternating(x, x0, jacobi_passes(iters, shape.tile.k),
                        lambda src, dst, sweeps: _build.launch(
                            "tf_jacobi_probe_pass", shape.index, src, x0,
                            dst, n, chunks.r_lo, chunks.r_hi, chunks.length,
                            chunks.count, sweeps, b, a, 1.0 / c))


def _alternating(x, x0, passes, launch):
    """``launch(src, dst, sweeps)`` for each pass's sweeps, from x, the
    passes alternating between out and a scratch buffer (shaped like x0)
    so that the last lands in out; returns out."""
    out, tmp = torch.empty_like(x0), torch.empty_like(x0)
    src = x
    for i, sweeps in enumerate(passes):
        dst = out if rb_lands_in_out(i, len(passes)) else tmp
        launch(src, dst, sweeps)
        src = dst
    return out


def _jacobi_solve(b, x, x0, a, c_inv, iters):
    """The dense blocked Jacobi solve in x0's storage type (float32 or
    bfloat16): ceil(iters / k) passes, alternating between out and a
    scratch buffer so that the last lands in out."""
    chunks = _jacobi_chunks_on(x0)
    return _alternating(x, x0, jacobi_passes(iters, jacobi_tile(x0.dtype).k),
                        lambda src, dst, sweeps: _jacobi_pass(
                            src, x0, dst, chunks, sweeps, b, a, c_inv))


def lin_solve3d_bf16(b, x, x0, a, c, iters):
    """lin_solve3d in bfloat16: ``iters`` Jacobi sweeps, each operation
    rounded to bfloat16; float32 in and out, as
    stam.lin_solve3d(dtype=torch.bfloat16).

    Replaces lin_solve3d_pallas(dtype=bfloat16)
    (tpufluids/grid/pallas_kernels.py).  Bound on paper by bytes, at 2 B
    a cell.  lin_solve3d's passes in bfloat16 storage: the same blocked
    kernel compiled for __nv_bfloat16 (k = JACOBI_TILE_BF16.k sweeps a
    pass), two cells an operation in bf16x2 (csrc/jacobi_blocked.cu)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_bf16_plain(b, x, x0, a, c, iters)
    out = _jacobi_solve(b, *_bf16_operands(x, x0, a, c), iters)
    lin_solve3d_bf16.launches += 1
    return out.float()


lin_solve3d_bf16.launches = 0


def lin_solve3d_rb_bf16_plain(b, x, x0, a, c, iters):
    return stam.lin_solve3d(b, x, x0, a, c, iters, red_black=True,
                            dtype=torch.bfloat16)


def lin_solve3d_rb_bf16(b, x, x0, a, c, iters):
    """lin_solve3d_rb in bfloat16, each operation rounded to bfloat16;
    float32 in and out, as stam.lin_solve3d(red_black=True,
    dtype=torch.bfloat16).

    Replaces lin_solve3d_pallas(red_black=True, dtype=bfloat16)
    (tpufluids/grid/pallas_kernels.py).  Bound on paper by bytes, at 2 B
    a cell.  lin_solve3d_rb's passes in bfloat16 storage: the same
    blocked kernel compiled for __nv_bfloat16, two cells an operation in
    bf16x2, then the ghost pass (csrc/rb_blocked.cu)."""
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_rb_bf16_plain(b, x, x0, a, c, iters)
    x, x0, a, c_inv = _bf16_operands(x, x0, a, c)
    out = _rb_solve(b, x, x0, a, c_inv, iters)
    lin_solve3d_rb_bf16.launches += 1
    return out.float()


lin_solve3d_rb_bf16.launches = 0


def _check_solve_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the solves run in float32 or bfloat16, not "
                        f"{dtype}")


def lin_solve3d_whole_plain(b, x, x0, a, c, iters, red_black, dtype):
    return stam.lin_solve3d(b, x, x0, a, c, iters, red_black=red_black,
                            dtype=dtype)


def lin_solve3d_whole(b, x, x0, a, c, iters, red_black, dtype):
    """The whole solve: ``iters`` Jacobi sweeps, or red-black iterations,
    in ``dtype`` (float32 or bfloat16); float32 in and out, as
    stam.lin_solve3d(red_black=red_black, dtype=dtype), so as the
    streamed lin_solve3d, lin_solve3d_rb and their bfloat16 versions.

    Replaces the whole-solve mode of lin_solve3d_pallas
    (_solve_whole_kernel, tpufluids/grid/pallas_kernels.py).  Bound by
    its chain of dependent sweeps.  One cooperative launch of a
    persistent block a multiprocessor runs blocked passes in shared
    memory, up to SOLVE_RB_LEVELS half-sweeps or SOLVE_JACOBI_LEVELS
    sweeps a pass and a grid barrier between passes (solve_plan,
    solve_barriers; csrc/jacobi.cu, csrc/step_blocked.cuh); its buffers
    stay in the card's L2.  Only for fields that pass
    ``solve_whole_ok``."""
    _check_solve_dtype(dtype)
    if not _solve_on_cuda(b, x, x0, iters):
        return lin_solve3d_whole_plain(b, x, x0, a, c, iters, red_black,
                                       dtype)
    if not solve_whole_ok(x0, dtype):
        raise ValueError(f"{tuple(x0.shape)} fields in {dtype} are outside "
                         f"the whole tier (solve_whole_ok)")
    blocks, smem = solve_info(_device_index(x0))
    plan = solve_plan(x0.shape[0] - 2, red_black, dtype, blocks, smem)
    out = _solve_whole_launch(b, x, x0, a, c, iters, red_black, dtype, plan)
    lin_solve3d_whole.launches += 1
    return out


def _solve_whole_launch(b, x, x0, a, c, iters, red_black, dtype,
                        plan: SolvePlan):
    """lin_solve3d_whole's launch on CUDA fields with ``plan`` (one the
    card takes: at most its resident blocks and shared memory)."""
    if dtype == torch.bfloat16:
        x, x0, a, c_inv = _bf16_operands(x, x0, a, c)
    else:
        c_inv = 1.0 / c
    out, tmp = torch.empty_like(x0), torch.empty_like(x0)
    t = plan.tile
    _build.launch("tf_lin_solve3d_whole", x, x0, out, tmp, b,
                  x0.shape[0] - 2, iters, bool(red_black),
                  dtype == torch.bfloat16, plan.blocks, plan.threads,
                  plan.smem, plan.levels, t.tx, t.ty, t.tz, a, c_inv)
    return out.float()


lin_solve3d_whole.launches = 0


def diffuse3d_multi_plain(xs, params, iters):
    return tuple(stam.lin_solve3d(b, x, x, a, c, iters)
                 for x, (b, a, c) in zip(xs, params))


def diffuse3d_multi(xs, params, iters):
    """Diffuse each field of ``xs`` (1 to 3) by ``iters`` Jacobi sweeps
    with its own (b, a, c) from ``params``, x0 being the field itself;
    as lin_solve3d(b, x, x, a, c, iters) per field.

    Replaces diffuse3d_whole_multi (tpufluids/grid/pallas_kernels.py).
    Bound by its chain of dependent sweeps.  One cooperative launch of
    the whole solve's blocked passes (csrc/jacobi.cu,
    csrc/step_blocked.cuh): SOLVE_JACOBI_LEVELS sweeps a pass on the
    tiles of diffuse_plan, the blocks taking the (field, tile) pairs in
    turn, and a grid barrier between passes (solve_barriers); only for
    fields that pass ``solve_whole_ok`` in float32."""
    xs, params = tuple(xs), tuple(params)
    if not 1 <= len(xs) <= 3 or len(params) != len(xs):
        raise ValueError("diffuse3d_multi takes 1 to 3 fields, one "
                         "(b, a, c) each")
    for b, _, _ in params:
        _check_solve(b, iters)
    if not _on_cuda(*xs):
        return diffuse3d_multi_plain(xs, params, iters)
    if not solve_whole_ok(xs[0], torch.float32):
        raise ValueError(f"{tuple(xs[0].shape)} fields are outside the "
                         f"whole tier (solve_whole_ok)")
    blocks, smem = solve_info(_device_index(xs[0]))
    plan = diffuse_plan(xs[0].shape[0] - 2, len(xs), blocks, smem)
    outs = _diffuse_launch(xs, params, iters, plan)
    diffuse3d_multi.launches += 1
    return outs


def _diffuse_launch(xs, params, iters, plan: SolvePlan):
    """diffuse3d_multi's launch on CUDA fields with ``plan``."""
    k, pad = len(xs), (None,) * (3 - len(xs))
    outs = tuple(torch.empty_like(x) for x in xs)
    tmps = tuple(torch.empty_like(x) for x in xs)
    bs, as_, cs = zip(*params)
    t = plan.tile
    _build.launch("tf_diffuse3d_multi", *xs, *pad, *outs, *pad, *tmps, *pad,
                  k, *bs, *(0,) * (3 - k), xs[0].shape[0] - 2, iters,
                  plan.blocks, plan.threads, plan.smem, plan.levels, t.tx,
                  t.ty, t.tz, *as_, *(0.0,) * (3 - k),
                  *(1.0 / c for c in cs), *(0.0,) * (3 - k))
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
    Bound by its chain of dependent sweeps.  One cooperative launch of
    the whole step's blocked projection (csrc/jacobi.cu,
    csrc/step_blocked.cuh): a persistent block a tile, the divergence
    kept in its shared memory for the whole solve, passes of
    project_plan's levels and a grid barrier between passes
    (solve_barriers), the gradient subtracted in the last pass with the
    cell arithmetic of the three-launch path; only for fields that pass
    ``solve_whole_ok`` in float32."""
    _check_solve(0, iters)
    if not _on_cuda(u, v, w):
        return project3d_whole_plain(u, v, w, iters, red_black)
    if not solve_whole_ok(u, torch.float32):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole "
                         f"tier (solve_whole_ok)")
    blocks, smem = solve_info(_device_index(u))
    plan = project_plan(u.shape[0] - 2, red_black, blocks, smem)
    outs = _project_launch(u, v, w, iters, red_black, plan)
    project3d_whole.launches += 1
    return outs


def _project_launch(u, v, w, iters, red_black, plan: SolvePlan):
    """project3d_whole's launch on CUDA fields with ``plan`` (one tile a
    block); the pressure alternates between two buffers."""
    n = u.shape[0] - 2
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(3))
    p0, p1 = torch.empty_like(u), torch.empty_like(u)
    t = plan.tile
    _build.launch("tf_project3d_whole", u, v, w, *outs, p0, p1, n, iters,
                  bool(red_black), plan.blocks, plan.threads, plan.smem,
                  plan.levels, t.tx, t.ty, t.tz, -0.5 * h, 1.0 / h,
                  1.0 / 6.0)
    return outs


project3d_whole.launches = 0


# ---------------------------------------------------------------------------
# the whole step

# scratch fields of the whole step: two velocity trios, the diffused dens
# and temp, and the pressure between passes (csrc/step.cu)
STEP_SCRATCH = 10
# (half-)sweeps a pass of the whole step's blocked phases
# (csrc/step_blocked.cuh): red-black half-sweeps of the pressure solve,
# and Jacobi sweeps of the pressure solve and of the diffusions
STEP_RB_LEVELS = 4
STEP_JACOBI_LEVELS = 3


@dataclasses.dataclass(frozen=True)
class StepTile:
    """The tiles of a blocked phase of the whole step: tx x ty x tz
    interior cells (the last of a row clipped at n), tiles in C order,
    each held in a box widened by ``halo`` cells and clipped to the
    (n+2)^3 array."""
    tx: int
    ty: int
    tz: int
    halo: int

    def counts(self, n: int):
        return (-(-n // self.tx), -(-n // self.ty), -(-n // self.tz))

    def count(self, n: int) -> int:
        cx, cy, cz = self.counts(n)
        return cx * cy * cz

    def box_cells(self, n: int) -> int:
        """The cells of the largest box in shared memory, its z rows
        padded to an even length (csrc/step_blocked.cuh's Box)."""
        x, y, z = (min(t + 2 * self.halo, n + 2)
                   for t in (self.tx, self.ty, self.tz))
        return x * y * (z + z % 2)

    def tile(self, n: int, t: int):
        """Tile t: its first and last interior cell on each axis, as
        ((x0, x1), (y0, y1), (z0, z1))."""
        _, cy, cz = self.counts(n)
        at = (t // (cy * cz), t // cz % cy, t % cz)
        return tuple((1 + i * e, min(1 + i * e + e - 1, n))
                     for i, e in zip(at, (self.tx, self.ty, self.tz)))


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """How the whole step runs at one size and configuration: ``blocks``
    persistent blocks (one a multiprocessor), ``smem`` bytes of shared
    memory each; pressure passes of ``rb_levels`` half-sweeps
    (red-black) or ``jacobi_levels`` sweeps on ``project``'s tiles, one a
    block; diffusion passes of ``jacobi_levels`` sweeps on ``diffuse``'s
    tiles, the blocks taking the (field, tile) pairs in turn."""
    blocks: int
    smem: int
    rb_levels: int
    jacobi_levels: int
    project: StepTile
    diffuse: StepTile


def step_fields(cfg: stam.StamConfig) -> int:
    """The fields the whole step diffuses: u, v, w (visc), dens, temp."""
    return 3 * bool(cfg.visc) + bool(cfg.diff) + bool(cfg.temp_diff)


@functools.cache
def _step_tile(n, blocks, halo, fields, boxes, smem, itemsize=4):
    """The tile of a blocked phase with ``fields`` fields, ``boxes`` boxes
    of ``itemsize`` bytes a cell a block in ``smem`` bytes: the least
    rounds x box cells, rounds = ceil(fields x tiles / blocks), on ties
    the widest (y, z) plane, then the longest z rows; a single field (the
    pressure, a whole solve) takes at most one tile a block."""
    sizes = sorted({-(-n // c) for c in range(1, n + 1)})
    best = None
    for tx in sizes:
        for ty in sizes:
            for tz in sizes:
                t = StepTile(tx, ty, tz, halo)
                count = t.count(n)
                if fields == 1 and count > blocks:
                    continue
                if itemsize * boxes * t.box_cells(n) > smem:
                    continue
                rounds = -(-fields * count // blocks)
                key = (rounds * t.box_cells(n), -ty * tz, -tz)
                if best is None or key < best[0]:
                    best = (key, t)
    if best is None:
        raise ValueError(f"no tile of the whole step fits {boxes} boxes of "
                         f"halo {halo} at n = {n} in {smem} B on {blocks} "
                         f"blocks")
    return best[1]


def step_plan(n: int, cfg: stam.StamConfig, blocks: int,
              smem: int) -> StepPlan:
    """The whole step's plan at size n on ``blocks`` blocks of at most
    ``smem`` bytes of shared memory: the pressure's tiles with a halo of
    its levels + 1 (its last pass widens the cone by one for the
    gradient) in two boxes (red-black) or three (Jacobi), the diffusions'
    with a halo of their levels in three."""
    return _step_plan(n, bool(cfg.red_black), step_fields(cfg), blocks, smem)


@functools.cache
def _step_plan(n, rb, fields, blocks, smem):
    levels = STEP_RB_LEVELS if rb else STEP_JACOBI_LEVELS
    project = _step_tile(n, blocks, levels + 1, 1, 2 if rb else 3, smem)
    diffuse = _step_tile(n, blocks, STEP_JACOBI_LEVELS, max(fields, 1), 3,
                         smem)
    need = max((2 if rb else 3) * project.box_cells(n),
               3 * diffuse.box_cells(n) if fields else 0)
    return StepPlan(blocks, 4 * need, STEP_RB_LEVELS, STEP_JACOBI_LEVELS,
                    project, diffuse)


# the whole solve's blocked passes (csrc/jacobi.cu, with the bodies of
# csrc/step_blocked.cuh): red-black half-sweeps or Jacobi sweeps a pass,
# and threads a block (at most 512, one block a multiprocessor); chosen
# by a probe on the card at 64^3 (PERF.md, the whole solves)
SOLVE_RB_LEVELS = 4
SOLVE_JACOBI_LEVELS = 3
SOLVE_THREADS = 512


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """How a whole solve runs at one size: ``blocks`` persistent blocks
    of ``threads`` threads (no more blocks than tiles), ``smem`` bytes of
    shared memory each, passes of ``levels`` sweeps (red-black:
    half-sweeps) on the tiles of ``tile`` (a StepTile in 3D, a
    Step2dTile in 2D) with a halo of ``levels`` (the fused projection's:
    ``levels`` + 1).  A block takes tiles t, t + blocks, ...; one that
    holds one tile keeps its x0 in shared memory for the whole solve."""
    blocks: int
    threads: int
    smem: int
    levels: int
    tile: StepTile | Step2dTile


def solve_plan(n: int, red_black: bool, dtype: torch.dtype, blocks: int,
               smem: int) -> SolvePlan:
    """The whole solve's plan at size n, stored as ``dtype``, on ``blocks``
    blocks of at most ``smem`` bytes of shared memory: one tile a block,
    in two boxes (red-black: x0 and the field, updated in place) or three
    (Jacobi: its second buffer), with a halo of its levels."""
    return _solve_plan(n, bool(red_black), dtype.itemsize, blocks, smem)


@functools.cache
def _solve_plan(n, rb, itemsize, blocks, smem):
    levels = SOLVE_RB_LEVELS if rb else SOLVE_JACOBI_LEVELS
    boxes = 2 if rb else 3
    tile = _step_tile(n, blocks, levels, 1, boxes, smem, itemsize)
    return SolvePlan(min(blocks, tile.count(n)), SOLVE_THREADS,
                     itemsize * boxes * tile.box_cells(n), levels, tile)


def project_plan(n: int, red_black: bool, blocks: int,
                 smem: int) -> SolvePlan:
    """The fused projection's plan at size n on ``blocks`` blocks of at
    most ``smem`` bytes of shared memory: one tile a block for the whole
    solve (its divergence stays in the block's x0), in two float32 boxes
    (red-black: x0 and the pressure, updated in place) or three (Jacobi:
    its second buffer), with a halo of its levels + 1 (the last pass
    widens the cone by one for the gradient), SOLVE_THREADS threads.
    The levels are SOLVE_RB_LEVELS half-sweeps or SOLVE_JACOBI_LEVELS
    sweeps a pass where such a tile fits one a block, else the most
    below that which fit: on the card's 132 blocks of 232448 B, Jacobi
    takes 2 sweeps a pass at n = 93 to 99 (its three boxes of halo 4 fit
    no tiling of 132 tiles or fewer there), and every other size and
    mode its own levels."""
    return _project_plan(n, bool(red_black), blocks, smem)


@functools.cache
def _project_plan(n, rb, blocks, smem):
    boxes = 2 if rb else 3
    for levels in range(SOLVE_RB_LEVELS if rb else SOLVE_JACOBI_LEVELS, 0,
                        -1):
        try:
            tile = _step_tile(n, blocks, levels + 1, 1, boxes, smem)
        except ValueError:
            continue
        return SolvePlan(tile.count(n), SOLVE_THREADS,
                         4 * boxes * tile.box_cells(n), levels, tile)
    raise ValueError(f"no tile of the fused projection fits one a block at "
                     f"n = {n} in {smem} B on {blocks} blocks")


def diffuse_plan(n: int, fields: int, blocks: int, smem: int) -> SolvePlan:
    """The multi-field diffusion's plan at size n for ``fields`` fields
    (1 to 3) on ``blocks`` blocks of at most ``smem`` bytes of shared
    memory: the whole Jacobi solve's levels and threads, tiles in three
    float32 boxes chosen for the fewest rounds of (field, tile) pairs
    times box cells (_step_tile), so a block may take several."""
    return _diffuse_plan(n, fields, blocks, smem)


@functools.cache
def _diffuse_plan(n, fields, blocks, smem):
    tile = _step_tile(n, blocks, SOLVE_JACOBI_LEVELS, fields, 3, smem)
    return SolvePlan(min(blocks, fields * tile.count(n)), SOLVE_THREADS,
                     4 * 3 * tile.box_cells(n), SOLVE_JACOBI_LEVELS, tile)


def solve_passes(iters: int, red_black: bool, plan: SolvePlan) -> int:
    """The passes of a whole solve, 3D or 2D: its sweeps (red-black:
    half-sweeps), ``plan.levels`` a pass."""
    return -(-(2 * iters if red_black else iters) // plan.levels)


def solve_barriers(iters: int, red_black: bool, plan: SolvePlan) -> int:
    """The grid-wide barriers of a whole solve: one between passes."""
    return solve_passes(iters, red_black, plan) - 1


@functools.cache
def solve_info(device_index: int):
    """(persistent blocks, shared memory bytes a block may take) of the
    whole solve and the multi-field diffusion on CUDA device
    ``device_index``; it also sets their kernels' shared-memory
    attribute, once a device."""
    return _tile_info("tf_lin_solve3d_whole_info", device_index)


def step_passes(cfg: stam.StamConfig, plan: StepPlan):
    """(diffusion passes, passes of each projection) of a whole step."""
    iters = cfg.jacobi_iters
    diffuse = -(-iters // plan.jacobi_levels) if step_fields(cfg) else 0
    if cfg.red_black:
        return diffuse, -(-2 * iters // plan.rb_levels)
    return diffuse, -(-iters // plan.jacobi_levels)


def step_barriers(cfg: stam.StamConfig, plan: StepPlan) -> int:
    """The grid-wide barriers of one whole step: forcing half A (with
    buoyancy or vorticity) and half B (vorticity), one a diffusion pass,
    one a pressure pass of each projection, one after the
    self-advection."""
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    diffuse, project = step_passes(cfg, plan)
    return (buoy or vort) + vort + diffuse + 2 * project + 1


@functools.cache
def step_info(device_index: int):
    """(persistent blocks, threads a block, shared memory bytes a block
    may take) of the whole step's kernel on CUDA device ``device_index``;
    it also sets the kernel's shared-memory attribute to that size, once
    a device, so step3d_whole's launches need no setting of their own."""
    lib = _build.load()
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        rc = lib.tf_step3d_whole_info(*map(ctypes.byref, vals))
    if rc:
        raise RuntimeError(f"tf_step3d_whole_info: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
    return tuple(v.value for v in vals)


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
    Bound by its grid-wide barriers and the latency of each phase.  One
    cooperative launch of a persistent block a multiprocessor runs every
    phase; the pressure solves and the diffusions run blocked in shared
    memory, a few (half-)sweeps a pass and a grid barrier a pass
    (step_plan, step_barriers; csrc/step.cu, csrc/step_blocked.cuh); only
    for fields that pass ``step_whole_ok``."""
    _check_step(cfg)
    if not _on_cuda(u, v, w, dens, temp):
        return step3d_whole_plain(u, v, w, dens, temp, cfg)
    if not step_whole_ok(u):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole "
                         f"step (step_whole_ok)")
    blocks, _, smem = step_info(_device_index(u))
    n = u.shape[0] - 2
    plan = step_plan(n, cfg, blocks, smem)
    h = 1.0 / n
    outs = tuple(torch.empty_like(u) for _ in range(5))
    scratch = torch.empty((STEP_SCRATCH, *u.shape), dtype=u.dtype,
                          device=u.device)

    def ac(coeff):
        a, c = stam._diffusion_ac(cfg, coeff, n)
        return a, 1.0 / c

    p, d = plan.project, plan.diffuse
    # the constants the separate wrappers pass, computed as they do
    _build.launch("tf_step3d_whole", u, v, w, dens, temp, *outs, scratch, n,
                  cfg.jacobi_iters, bool(cfg.red_black),
                  bool(cfg.buoyancy_alpha or cfg.buoyancy_beta),
                  bool(cfg.vorticity_eps), bool(cfg.visc), bool(cfg.diff),
                  bool(cfg.temp_diff), plan.blocks, plan.smem,
                  plan.rb_levels, plan.jacobi_levels, p.tx, p.ty, p.tz, d.tx,
                  d.ty, d.tz, cfg.dt, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta, cfg.ambient_temp, 1.0 / h,
                  cfg.vorticity_eps * h, -0.5 * (1.0 / n), 1.0 / 6.0,
                  cfg.dt * n, *ac(cfg.visc), *ac(cfg.diff),
                  *ac(cfg.temp_diff))
    step3d_whole.launches += 1
    return outs


step3d_whole.launches = 0


# ---------------------------------------------------------------------------
# the 2D kernels

def step2d_whole_ok(x: torch.Tensor) -> bool:
    """True for 2D fields shaped like ``x`` that the whole 2D step takes:
    the reference's gate (step2d_whole_ok in
    tpufluids/grid/pallas_kernels.py), nx ny 4 B x 20 <= 96 MiB, up to
    1121^2 cells (n = 1119)."""
    nx, ny = x.shape
    return nx * ny * 4 * 20 <= 96 * 1024 * 1024


def lin_solve2d_plain(b, x, x0, a, c, iters):
    return stam.lin_solve2d(b, x, x0, a, c, iters)


def lin_solve2d(b, x, x0, a, c, iters):
    """``iters`` Jacobi sweeps of (x0 + a * sum of the four neighbours)
    / c, each followed by set_bnd2d(b) with its corner averages; as
    stam.lin_solve2d.  ``x`` None is a zero initial guess.

    Replaces lin_solve2d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by its chain of dependent sweeps.  One cooperative launch of
    persistent blocks across the multiprocessors runs the whole 2D
    step's blocked passes, SOLVE2D_LEVELS sweeps in shared memory a pass
    and a grid barrier between passes, at every n (solve2d_plan,
    solve_barriers; csrc/grid2d.cu, csrc/step2d_blocked.cuh)."""
    if b not in (0, 1, 2):
        raise ValueError(f"set_bnd2d mode must be 0..2, got {b}")
    _check_solve(b, iters)
    if not (_on_cuda(x0, ndim=2) if x is None else _on_cuda(x, x0, ndim=2)):
        return lin_solve2d_plain(b, x, x0, a, c, iters)
    blocks, smem = solve2d_info(_device_index(x0))
    plan = solve2d_plan(x0.shape[0] - 2, blocks, smem)
    out = _solve2d_launch(b, x, x0, a, c, iters, plan)
    lin_solve2d.launches += 1
    return out


def _solve2d_launch(b, x, x0, a, c, iters, plan: SolvePlan):
    """lin_solve2d's launch on CUDA fields with ``plan`` (one the card
    takes: at most its resident blocks and shared memory)."""
    out, tmp = torch.empty_like(x0), torch.empty_like(x0)
    _build.launch("tf_lin_solve2d", x, x0, out, tmp, b, x0.shape[0] - 2,
                  iters, plan.blocks, plan.threads, plan.smem, plan.levels,
                  plan.tile.tx, plan.tile.ty, a, 1.0 / c)
    return out


lin_solve2d.launches = 0

# scratch fields of the whole 2D step: two velocity pairs, the diffused
# dens and temp, and the pressure between passes (csrc/step2d.cu)
STEP2D_SCRATCH = 8
# persistent blocks of the whole 2D step (at most the card's resident
# blocks: one a multiprocessor on the H100) and Jacobi sweeps a pass of
# its blocked phases (two passes a solve of 20), chosen by probes on the
# card (PERF.md); its threads a block are kStepThreads (256) in
# csrc/step2d.cu
STEP2D_BLOCKS = 132
STEP2D_LEVELS = 10


@dataclasses.dataclass(frozen=True)
class Step2dTile:
    """The tiles of a blocked phase of the whole 2D step: tx x ty interior
    cells (the last of a row clipped at n), tiles in C order, each held in
    a box widened by ``halo`` cells and clipped to the (n+2)^2 array."""
    tx: int
    ty: int
    halo: int

    def counts(self, n: int):
        return (-(-n // self.tx), -(-n // self.ty))

    def count(self, n: int) -> int:
        cx, cy = self.counts(n)
        return cx * cy

    def box_cells(self, n: int) -> int:
        """The cells of the largest box in shared memory."""
        return (min(self.tx + 2 * self.halo, n + 2)
                * min(self.ty + 2 * self.halo, n + 2))

    def tile(self, n: int, t: int):
        """Tile t: its first and last interior cell on each axis, as
        ((x0, x1), (y0, y1))."""
        _, cy = self.counts(n)
        return tuple((1 + i * e, min(i * e + e, n))
                     for i, e in zip((t // cy, t % cy), (self.tx, self.ty)))


@dataclasses.dataclass(frozen=True)
class Step2dPlan:
    """How the whole 2D step runs at one size and configuration:
    ``blocks`` persistent blocks, ``smem`` bytes of shared memory each;
    passes of ``levels`` Jacobi sweeps, the pressure's on ``project``'s
    tiles (halo levels + 1), the diffusions' on ``diffuse``'s (halo
    levels), the blocks taking the tiles, or (field, tile) pairs, in
    turn."""
    blocks: int
    smem: int
    levels: int
    project: Step2dTile
    diffuse: Step2dTile


def step2d_fields(cfg: stam.StamConfig) -> int:
    """The fields the whole 2D step diffuses: u, v (visc), dens, temp."""
    return 2 * bool(cfg.visc) + bool(cfg.diff) + bool(cfg.temp_diff)


@functools.cache
def _step2d_tile(n, blocks, halo, fields, smem):
    """The tile of a blocked 2D phase with ``fields`` fields and three
    float32 boxes a block in ``smem`` bytes: the least rounds x box cells,
    rounds = ceil(fields x tiles / blocks), on ties the longest y rows."""
    sizes = sorted({-(-n // c) for c in range(1, n + 1)})
    best = None
    for tx in sizes:
        for ty in sizes:
            t = Step2dTile(tx, ty, halo)
            if 4 * 3 * t.box_cells(n) > smem:
                continue
            rounds = -(-fields * t.count(n) // blocks)
            key = (rounds * t.box_cells(n), -ty)
            if best is None or key < best[0]:
                best = (key, t)
    if best is None:
        raise ValueError(f"no tile of the whole 2D step fits three boxes of "
                         f"halo {halo} at n = {n} in {smem} B")
    return best[1]


def step2d_plan(n: int, cfg: stam.StamConfig, blocks: int,
                smem: int) -> Step2dPlan:
    """The whole 2D step's plan at size n on ``blocks`` blocks of at most
    ``smem`` bytes of shared memory, F = STEP2D_LEVELS sweeps a pass."""
    return _step2d_plan(n, step2d_fields(cfg), blocks, smem)


@functools.cache
def _step2d_plan(n, fields, blocks, smem):
    project = _step2d_tile(n, blocks, STEP2D_LEVELS + 1, 1, smem)
    diffuse = _step2d_tile(n, blocks, STEP2D_LEVELS, max(fields, 1), smem)
    need = max(project.box_cells(n), diffuse.box_cells(n) if fields else 0)
    return Step2dPlan(blocks, 4 * 3 * need, STEP2D_LEVELS, project, diffuse)


# the whole 2D solve's blocked passes (csrc/grid2d.cu, with the bodies of
# csrc/step2d_blocked.cuh): Jacobi sweeps a pass and threads a block (at
# most 1024), on at most STEP2D_BLOCKS persistent blocks; chosen by a
# probe on the card at 130^2 and 1026^2 (PERF.md, the whole solves)
SOLVE2D_LEVELS = 10
SOLVE2D_THREADS = 384


def solve2d_plan(n: int, blocks: int, smem: int) -> SolvePlan:
    """The whole 2D solve's plan at size n on ``blocks`` blocks of at most
    ``smem`` bytes of shared memory: the whole 2D step's tiles for one
    field, three boxes, a halo of SOLVE2D_LEVELS."""
    return _solve2d_plan(n, blocks, smem)


@functools.cache
def _solve2d_plan(n, blocks, smem):
    tile = _step2d_tile(n, blocks, SOLVE2D_LEVELS, 1, smem)
    return SolvePlan(min(blocks, tile.count(n)), SOLVE2D_THREADS,
                     4 * 3 * tile.box_cells(n), SOLVE2D_LEVELS, tile)


@functools.cache
def solve2d_info(device_index: int):
    """(persistent blocks, shared memory bytes a block may take) of the
    whole 2D solve on CUDA device ``device_index``: at most STEP2D_BLOCKS
    blocks, and no more than the card keeps resident; it also sets the
    kernel's shared-memory attribute, once a device."""
    resident, smem = _tile_info("tf_lin_solve2d_info", device_index)
    return min(STEP2D_BLOCKS, resident), smem


def step2d_passes(cfg: stam.StamConfig, plan: Step2dPlan):
    """(diffusion passes, passes of each projection) of a whole 2D step."""
    passes = -(-cfg.jacobi_iters // plan.levels)
    return (passes if step2d_fields(cfg) else 0), passes


def step2d_barriers(cfg: stam.StamConfig, plan: Step2dPlan) -> int:
    """The grid-wide barriers of one whole 2D step: one after buoyancy,
    two in vorticity confinement (|curl|, the force), one a diffusion
    pass, one a pressure pass of each projection, one after the
    self-advection."""
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    diffuse, project = step2d_passes(cfg, plan)
    return buoy + 2 * vort + diffuse + 2 * project + 1


@functools.cache
def step2d_info(device_index: int):
    """(persistent blocks, threads a block, shared memory bytes a block
    may take) of the whole 2D step on CUDA device ``device_index``: at
    most STEP2D_BLOCKS blocks, and no more than the card keeps resident;
    it also sets the kernel's shared-memory attribute to that size, once
    a device, so step2d_whole's launches need no setting of their own."""
    lib = _build.load()
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        rc = lib.tf_step2d_whole_info(*map(ctypes.byref, vals))
    if rc:
        raise RuntimeError(f"tf_step2d_whole_info: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
    resident, threads, smem = (v.value for v in vals)
    return min(STEP2D_BLOCKS, resident), threads, smem


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

    Replaces step2d_whole_pallas (tpufluids/grid/pallas_kernels.py).
    Bound by its grid-wide barriers and the latency of each phase.  One
    cooperative launch of STEP2D_BLOCKS persistent blocks runs every
    phase; the pressure solves and the four diffusions run blocked in
    shared memory, F = STEP2D_LEVELS sweeps and one grid barrier a pass
    (step2d_plan, step2d_barriers; csrc/step2d.cu); only for fields that
    pass ``step2d_whole_ok``."""
    _check_step(cfg)
    if not _on_cuda(u, v, dens, temp, ndim=2):
        return step2d_whole_plain(u, v, dens, temp, cfg)
    if not step2d_whole_ok(u):
        raise ValueError(f"{tuple(u.shape)} fields are outside the whole 2D "
                         f"step (step2d_whole_ok)")
    n = u.shape[0] - 2
    h = 1.0 / n
    blocks, _, smem = step2d_info(_device_index(u))
    plan = step2d_plan(n, cfg, blocks, smem)
    outs = tuple(torch.empty_like(u) for _ in range(4))
    scratch = torch.empty((STEP2D_SCRATCH, *u.shape), dtype=u.dtype,
                          device=u.device)

    def ac(coeff):
        a, c = stam._diffusion_ac(cfg, coeff, n, 2)
        return a, 1.0 / c

    p, d = plan.project, plan.diffuse
    # the constants of the plain version's stages, computed as they do;
    # its tensor / h runs on the card as tensor * fl(1 / h), the
    # reciprocal taken in double
    _build.launch("tf_step2d_whole", u, v, dens, temp, *outs, scratch, n,
                  cfg.jacobi_iters,
                  bool(cfg.buoyancy_alpha or cfg.buoyancy_beta),
                  bool(cfg.vorticity_eps), bool(cfg.visc), bool(cfg.diff),
                  bool(cfg.temp_diff), plan.blocks, plan.smem, plan.levels,
                  p.tx, p.ty, d.tx, d.ty, cfg.dt, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta, cfg.ambient_temp, 1.0 / h,
                  cfg.vorticity_eps * h, -cfg.vorticity_eps * h, -0.5 * h,
                  cfg.dt * n, *ac(cfg.visc), *ac(cfg.diff),
                  *ac(cfg.temp_diff))
    step2d_whole.launches += 1
    return outs


step2d_whole.launches = 0

KERNELS = (advect3d_multi, forcing3d, div3d, gradsub3d, lin_solve3d,
           lin_solve3d_rb, lin_solve3d_rb_shard, lin_solve3d_bf16, lin_solve3d_rb_bf16,
           lin_solve3d_whole, diffuse3d_multi, project3d_whole,
           step3d_whole, lin_solve2d, step2d_whole)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
