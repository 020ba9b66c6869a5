// One whole 2D step of the Jacobi path in one cooperative launch:
// buoyancy, vorticity confinement, velocity diffusion, projection,
// velocity self-advection, projection, dens/temp diffusion, dens/temp
// advection (stam.step2d_multi with stencil advection).
//
// Replaces step2d_whole_pallas / _step2d_whole_kernel
// (tpufluids/grid/pallas_kernels.py), which keeps every field resident
// in VMEM for one program.  Here the fields stay in L2 (130^2 float32 is
// 68 KB) and the cells are spread over persistent blocks, one a
// multiprocessor.
//
// What bounds it on the H100.  Neither bytes nor operations: config 1's
// step (128^2) is 0.2 us of operations at 67 TFLOP/s.  It is a chain of
// some hundred dependent Jacobi sweeps and stencil phases, each waiting
// for the one before.  The design it replaces ran every phase in one
// block of 1024 threads, a block barrier a sweep and 17 cells a thread
// per sweep, on one of the card's 132 multiprocessors.
//
// Design.  One cooperative launch of kernels.STEP2D_BLOCKS persistent
// blocks of kStepThreads threads, F = kernels.STEP2D_LEVELS sweeps a
// pass (132 x 256 and F = 10, chosen by probes on the card: PERF.md),
// a grid-wide barrier only where the data flow needs one:
// - Blocked Jacobi passes.  A solve runs in passes of up to F sweeps
//   (levels).  A pass cuts the interior into tiles of tx x ty cells; a
//   block loads its tile widened by a halo of F cells (its box) from the
//   buffer the previous pass wrote into shared memory, runs the levels
//   there with a block barrier between them, level h updating the tile
//   widened by F-1-h, and writes its tile; then comes one grid barrier.
// - The four diffusing fields (u and v under visc, dens under diff,
//   temp under temp_diff) diffuse in one set of passes after the
//   forcing phases, the blocks taking the (field, tile) pairs in turn:
//   the scalars' diffusion reads only the step's inputs.
// - A projection costs one barrier a pass: its first pass computes the
//   divergence over the box into the box's shared x0 (kept for the whole
//   solve by a block with one tile, recomputed each pass by one with
//   several), the pressure box starts as zeros (the zero guess, ghosts
//   included), and the last pass widens its cone by one and subtracts
//   the gradient on its tile and the tile's ghosts.
// - Buoyancy, vorticity confinement and the two advections stay strided
//   elementwise phases over the (n+2)^2 cells, one grid barrier each
//   (none after the last), indexed by rows: a thread finds its row and
//   column once a phase, not once a cell.
//
// Ghosts (the rules of step_blocked.cuh, with set_bnd2d's corners).  A
// Jacobi tap across a face of the grid is the cell's own value times
// the face's set_bnd2d sign, which is what the ghost holds after a
// sweep, except on level 0 of a diffusion's first pass (the field's own
// stored ghosts, which need not be sign x interior after the sources are
// added) and on the pressure's first sweep (the zero guess).  Every
// level-0 read of a later pass sees what the previous pass stored.  A
// pass that writes a field's ghosts writes every output cell whose
// clamped cell lies in its tile, corners included (advection's 9 taps
// read them): sx or sy times the clamped cell's value on an edge, and
// 0.5 (sy c + sx c) at a corner, c the diagonal interior cell
// (stam.set_bnd2d's corner average).  The pressure's passes write
// interior cells only; its ghosts, where the gradient reads them, are
// those of set_bnd2d(0), the clamped cell's own value.
//
// Per cell the arithmetic is the plain version's, operation by
// operation with one rounding each (-fmad=false): the neighbour sum x-1,
// x+1, then y-1, then y+1, then (x0 + a nb) c_inv; the plain version's
// tensor / h is tensor * fl(1 / h) on the card (the reciprocal taken in
// double), so the kernel multiplies by that reciprocal, passed from
// Python.  So the step equals stam.step2d_multi bit for bit
// (tests/test_torch_step2d_blocked.py emulates it tile by tile).
//
// The tiles, boxes, levels and stores of the blocked passes, and the
// diffusions' passes themselves, are step2d_blocked.cuh's, shared with
// the whole 2D solve (grid2d.cu).  The host plans every buffer and tile
// (tf_step2d_whole below and kernels.step2d_plan); the kernel plans
// nothing.  No pointer is __restrict__: a phase reads what the phase
// before wrote.
#include <math.h>

#include "step2d_blocked.cuh"

namespace {

using namespace tf2d;

constexpr int kStepThreads = 256;
constexpr int kScratch = 8;

// ---------------------------------------------------------------------------
// the projection

struct BlockedProject {
  const float *u, *v;
  float *uo, *vo;
  float *p0, *p1;  // the pressure between passes, alternately
  int iters;
  int levels;  // sweeps a pass
  float coef, inv_h;
  Tiles tiles;  // halo levels + 1
};

// The divergence coef ((u[x+1] - u[x-1]) + v[y+1]) - v[y-1] (as
// stam.divergence2d) into X0 on every cell a level of any pass reads as
// x0.
__device__ __forceinline__ void divergence_box(float* X0,
                                               const BlockedProject& g,
                                               const Box& b, int n) {
  const Region r = widen(b, g.tiles.halo - 1, 1, n);
  const Runs R(r);
  const int N = n + 2;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    int s = b.at(i, j), c = i * N + j;
    for (; i < ie; ++i, s += b.ny, c += N)
      X0[s] = g.coef * (((g.u[c + N] - g.u[c - N]) + g.v[c + 1])
                        - g.v[c - 1]);
  }
}

// q - 0.5 (p+ - p-) / h on the owned cells, then set_bnd2d(1) for u and
// (2) for v, as stam.project2d; p's ghost taps are set_bnd2d(0)'s, the
// clamped cell's own value.
__device__ __forceinline__ void gradient_owned(const float* P,
                                               const BlockedProject& g,
                                               const Box& b, int n) {
  const Region r = owned(b, n);
  const Runs R(r);
  const int N = n + 2, sx = b.ny;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    const int cj = tf::clamp_interior(j, n);
    for (; i < ie; ++i) {
      const int ci = tf::clamp_interior(i, n);
      const int s = b.at(ci, cj), c = ci * N + cj, o = i * N + j;
      const float pc = P[s];
      const float pxm = ci == 1 ? pc : P[s - sx];
      const float pxp = ci == n ? pc : P[s + sx];
      const float pym = cj == 1 ? pc : P[s - 1];
      const float pyp = cj == n ? pc : P[s + 1];
      const bool xo = ci != i, yo = cj != j;
      g.uo[o] = bnd(xo, yo, bnd_for(1),
                    g.u[c] + (-0.5f * (pxp - pxm)) * g.inv_h);
      g.vo[o] = bnd(xo, yo, bnd_for(2),
                    g.v[c] + (-0.5f * (pyp - pym)) * g.inv_h);
    }
  }
}

// A projection of stam.project2d's Jacobi path: divergence, the
// zero-guess pressure solve (a = 1, c = 4, b = 0), gradient subtraction,
// in ceil(iters / levels) passes of the blocked solve, a grid-wide
// barrier after each.  ``smem`` holds three boxes: x0 (the divergence)
// and the pressure's two.
__device__ __forceinline__ void blocked_project(cg::grid_group& grid,
                                                const BlockedProject& g,
                                                float* smem, int n) {
  const int passes = (g.iters + g.levels - 1) / g.levels;
  const bool resident = g.tiles.count <= (int)gridDim.x;
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    const int h0 = pass * g.levels, H = min(g.levels, g.iters - h0);
    const int extra = last ? 1 : 0;
    for (int tile = blockIdx.x; tile < g.tiles.count; tile += gridDim.x) {
      const Box b = box_of(g.tiles, tile, n);
      const int vol = b.cells();
      float* X0 = smem;
      float* cur = smem + vol;
      float* nxt = cur + vol;
      if (pass == 0 || !resident) divergence_box(X0, g, b, n);
      if (pass == 0)
        zero_box(cur, b);
      else
        load_region(cur, pass & 1 ? g.p0 : g.p1, nullptr, nullptr, b,
                    widen(b, H + extra, 0, n + 1), n + 2);
      __syncthreads();
      for (int h = 0; h < H; ++h) {
        jacobi_level(cur, nxt, X0, b, widen(b, H - 1 - h + extra, 1, n), n,
                     h0 + h == 0, Bnd{1.0f, 1.0f}, 1.0f, 0.25f);
        float* t = cur;
        cur = nxt;
        nxt = t;
        __syncthreads();
      }
      if (last)
        gradient_owned(cur, g, b, n);
      else
        store_tile(cur, b, pass & 1 ? g.p1 : g.p0, n);
      __syncthreads();
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// the elementwise phases

// The (n+2)^2 output cells by rows: a block takes ``rows`` rows at a time
// (as many as its threads cover), thread t row t / N of them and column
// t % N, or, when a row is wider than the block, every row and columns
// t, t + threads, ...; found once a phase.
struct RowLoop {
  int i0, istep, j0, jstep;
  __device__ __forceinline__ explicit RowLoop(int N) {
    const int T = blockDim.x, rows = max(1, T / N);
    const int r = threadIdx.x / N;
    i0 = r < rows ? blockIdx.x * rows + r : N;
    istep = gridDim.x * rows;
    j0 = threadIdx.x % N;
    jstep = min(N, T);
  }
};

struct Pair {
  const float *u, *v;
};

struct OutPair {
  float *u, *v;
};

// (0.5 (q[+1] - q[-1])) / h along the axis of stride ``stride``.
__device__ __forceinline__ float dq(const float* q, int c, int stride,
                                    float inv_h) {
  return 0.5f * (q[c + stride] - q[c - stride]) * inv_h;
}

// The curl 0.5 ((v[x+1] - v[x-1]) - (u[y+1] - u[y-1])) / h at interior c.
__device__ __forceinline__ float curl2d(Pair q, int c, int N, float inv_h) {
  return 0.5f * ((q.v[c + N] - q.v[c - N]) - (q.u[c + 1] - q.u[c - 1]))
         * inv_h;
}

// 9-tap stencil advection of the two fields of ``q`` by ``vel`` into
// ``out`` with set_bnd2d(b0) and (b1) at output cell (i, j); as
// stam._advect_stencil.
__device__ __forceinline__ void advect_cell(int i, int j, int n, float dt0,
                                            Pair vel, Pair q, OutPair out,
                                            int b0, int b1) {
  const int N = n + 2;
  const int ci = tf::clamp_interior(i, n), cj = tf::clamp_interior(j, n);
  const int k = ci * N + cj;
  const float at[2] = {(float)ci, (float)cj};
  const float v[2] = {vel.u[k], vel.v[k]};
  // hat[a][d + 1] = max(0, 1 - |off_a - d|), the backtrace offset clamped
  // to one cell and to the source range [0.5, n + 0.5]
  float hat[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float off = fminf(fmaxf(-dt0 * v[a], -1.0f), 1.0f);
    off = fminf(fmaxf(off, 0.5f - at[a]), ((float)n + 0.5f) - at[a]);
#pragma unroll
    for (int d = -1; d <= 1; ++d)
      hat[a][d + 1] = fmaxf(0.0f, 1.0f - fabsf(off - (float)d));
  }
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const float wgt = hat[0][dx + 1] * hat[1][dy + 1];
      const int src = k + dx * N + dy;
      acc0 = acc0 + wgt * q.u[src];
      acc1 = acc1 + wgt * q.v[src];
    }
  const bool xo = ci != i, yo = cj != j;
  out.u[i * N + j] = bnd(xo, yo, bnd_for(b0), acc0);
  out.v[i * N + j] = bnd(xo, yo, bnd_for(b1), acc1);
}

// ---------------------------------------------------------------------------
// the step

struct Step2dArgs {
  const float *u, *v, *dens, *temp;
  int n, buoy, vort;
  float dt, alpha, beta, t_amb, inv_h, eps_h, neg_eps_h, dt0;
  float* buoy_v;     // v after buoyancy (reads v, dens, temp)
  Pair vort_in;      // vorticity confinement: reads vort_in, writes
  float* mag;        // |curl| (0 on the ghosts), then vort_out
  OutPair vort_out;
  // the diffusions of u, v (visc) and dens, temp, in the same passes;
  // then the two projections around the self-advection
  BlockedSolve diffuse;
  BlockedProject project_first;
  Pair advect_by;    // self-advection of advect_by into advect_out
  OutPair advect_out;
  BlockedProject project_final;
  Pair scalars;      // dens and temp as diffused, advected by the final
  OutPair scalars_out;  // velocity into the outputs
};

__global__ void __launch_bounds__(kStepThreads, 1)
    step2d_whole_kernel(const Step2dArgs g) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int n = g.n, N = n + 2;
  const RowLoop L(N);
  if (g.buoy) {
    // stam.buoyancy2d
    for (int i = L.i0; i < N; i += L.istep)
      for (int j = L.j0; j < N; j += L.jstep) {
        const int ci = tf::clamp_interior(i, n);
        const int cj = tf::clamp_interior(j, n);
        const int k = ci * N + cj;
        const float f =
            -g.alpha * g.dens[k] + g.beta * (g.temp[k] - g.t_amb);
        g.buoy_v[i * N + j] =
            bnd(ci != i, cj != j, bnd_for(2), g.v[k] + g.dt * f);
      }
    grid.sync();
  }
  if (g.vort) {
    // stam.vorticity_confinement2d: |curl|, then the force
    for (int i = L.i0; i < N; i += L.istep)
      for (int j = L.j0; j < N; j += L.jstep) {
        const bool ghost = i == 0 || i == N - 1 || j == 0 || j == N - 1;
        g.mag[i * N + j] =
            ghost ? 0.0f : fabsf(curl2d(g.vort_in, i * N + j, N, g.inv_h));
      }
    grid.sync();
    for (int i = L.i0; i < N; i += L.istep)
      for (int j = L.j0; j < N; j += L.jstep) {
        const int ci = tf::clamp_interior(i, n);
        const int cj = tf::clamp_interior(j, n);
        const int k = ci * N + cj;
        const float curl = curl2d(g.vort_in, k, N, g.inv_h);
        float gx = dq(g.mag, k, N, g.inv_h);
        float gy = dq(g.mag, k, 1, g.inv_h);
        const float norm = sqrtf(gx * gx + gy * gy) + 1e-5f;
        gx = gx / norm;
        gy = gy / norm;
        const float fu = g.eps_h * gy * curl;
        const float fv = g.neg_eps_h * gx * curl;
        const bool xo = ci != i, yo = cj != j;
        g.vort_out.u[i * N + j] =
            bnd(xo, yo, bnd_for(1), g.vort_in.u[k] + g.dt * fu);
        g.vort_out.v[i * N + j] =
            bnd(xo, yo, bnd_for(2), g.vort_in.v[k] + g.dt * fv);
      }
    grid.sync();
  }
  if (g.diffuse.fields) blocked_solve(grid, g.diffuse, smem, n, true);
  blocked_project(grid, g.project_first, smem, n);
  for (int i = L.i0; i < N; i += L.istep)
    for (int j = L.j0; j < N; j += L.jstep)
      advect_cell(i, j, n, g.dt0, g.advect_by, g.advect_by, g.advect_out, 1,
                  2);
  grid.sync();
  blocked_project(grid, g.project_final, smem, n);
  const Pair fin{g.project_final.uo, g.project_final.vo};
  for (int i = L.i0; i < N; i += L.istep)
    for (int j = L.j0; j < N; j += L.jstep)
      advect_cell(i, j, n, g.dt0, fin, g.scalars, g.scalars_out, 0, 0);
}

}  // namespace

// The velocity moves between the scratch pairs X and Y, a phase reading
// one and writing the other; the velocity diffusion's second buffers are
// uo and vo (written last, by the final projection), and |curl| and the
// buoyed v take P[0] and Y.v.  dens and temp diffuse into S with dens_o
// and temp_o as the second buffers (written last, by their advection).
// The pressure passes alternate between P[0] and P[1].  ``blocks``
// persistent blocks of kStepThreads threads, ``smem`` bytes of dynamic
// shared memory each; passes of ``levels`` sweeps on the pressure's tiles
// (pt*, halo levels + 1) and the diffusions' (dt*, halo levels)
// (kernels.step2d_plan).
extern "C" int tf_step2d_whole(
    const float* u, const float* v, const float* dens, const float* temp,
    float* uo, float* vo, float* dens_o, float* temp_o, float* scratch,
    int n, int iters, int buoy, int vort, int visc, int diff, int temp_diff,
    int blocks, int smem, int levels, int ptx, int pty, int dtx, int dty,
    float dt, float alpha, float beta, float t_amb, float inv_h,
    float eps_h, float neg_eps_h, float div_coef, float dt0, float visc_a,
    float visc_c_inv, float diff_a, float diff_c_inv, float temp_a,
    float temp_c_inv, void* stream) {
  if (levels < 1 || iters < 1 || blocks < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t cells = (size_t)(n + 2) * (n + 2);
  float* buf[kScratch];
  for (int i = 0; i < kScratch; ++i) buf[i] = scratch + i * cells;
  const OutPair X{buf[0], buf[1]}, Y{buf[2], buf[3]};
  float* const* S = buf + 4;
  float* const* P = buf + 6;

  Step2dArgs g{};
  g.u = u;
  g.v = v;
  g.dens = dens;
  g.temp = temp;
  g.n = n;
  g.buoy = buoy;
  g.vort = vort;
  g.dt = dt;
  g.alpha = alpha;
  g.beta = beta;
  g.t_amb = t_amb;
  g.inv_h = inv_h;
  g.eps_h = eps_h;
  g.neg_eps_h = neg_eps_h;
  g.dt0 = dt0;

  Pair cur{u, v};
  bool in_x = false;  // cur lies in X (else in the inputs or Y)
  auto other = [&]() { return in_x ? Y : X; };
  if (buoy) {
    g.buoy_v = Y.v;
    cur.v = Y.v;
  }
  if (vort) {
    g.mag = P[0];
    g.vort_in = cur;
    g.vort_out = X;
    cur = {X.u, X.v};
    in_x = true;
  }
  BlockedSolve& d = g.diffuse;
  d.iters = iters;
  d.levels = levels;
  d.tiles = tiles_of(n, dtx, dty, levels);
  if (visc) {
    const OutPair o = other();
    d.f[d.fields++] =
        SolveField{cur.u, cur.u, o.u, uo, 1, visc_a, visc_c_inv};
    d.f[d.fields++] =
        SolveField{cur.v, cur.v, o.v, vo, 2, visc_a, visc_c_inv};
    cur = {o.u, o.v};
    in_x = !in_x;
  }
  g.scalars = {dens, temp};
  if (diff) {
    d.f[d.fields++] = SolveField{dens, dens, S[0], dens_o, 0, diff_a,
                                   diff_c_inv};
    g.scalars.u = S[0];
  }
  if (temp_diff) {
    d.f[d.fields++] = SolveField{temp, temp, S[1], temp_o, 0, temp_a,
                                   temp_c_inv};
    g.scalars.v = S[1];
  }
  const Tiles pt = tiles_of(n, ptx, pty, levels + 1);
  auto project = [&](OutPair o) {
    return BlockedProject{cur.u, cur.v, o.u,     o.v,   P[0], P[1],
                          iters, levels, div_coef, inv_h, pt};
  };
  {
    const OutPair o = other();
    g.project_first = project(o);
    cur = {o.u, o.v};
    in_x = !in_x;
  }
  g.advect_by = cur;
  g.advect_out = other();
  cur = {g.advect_out.u, g.advect_out.v};
  g.project_final = project(OutPair{uo, vo});
  g.scalars_out = OutPair{dens_o, temp_o};

  // tf_step2d_whole_info has set the kernel's shared-memory attribute to
  // the most a block may take, once a device; ``smem`` is within it
  void* params[] = {&g};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)step2d_whole_kernel, dim3((unsigned)blocks),
      dim3(kStepThreads), params, (size_t)smem, (cudaStream_t)stream);
}

// The kernel's shape on the current device: the blocks the card keeps
// resident (at the most shared memory a block may take), the threads of
// one, and that shared memory in bytes; it sets the kernel's
// shared-memory attribute to that size.
extern "C" int tf_step2d_whole_info(int* blocks, int* threads, int* smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(step2d_whole_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, step2d_whole_kernel, kStepThreads, optin);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  *threads = kStepThreads;
  *smem = optin;
  return 0;
}
