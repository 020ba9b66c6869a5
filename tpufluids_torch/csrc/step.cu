// One whole 3D step of the Jacobi path in one cooperative launch:
// forcing, velocity diffusion, projection, velocity self-advection,
// projection, dens/temp diffusion, dens/temp advection.
//
// Replaces step3d_whole_pallas / _step_whole_kernel
// (tpufluids/grid/pallas_kernels.py), which runs the step with its
// fields resident in VMEM.  Here the five fields, their five outputs and
// ten scratch fields stay in the 50 MB L2 at 64^3 (20 fields of
// 1.15 MB).
//
// What bounds it on the H100.  Neither bytes nor operations: at 64^3 the
// step's operations take 6 us at 67 TFLOP/s, while it is a chain of
// dependent phases, each ended by a grid-wide barrier that costs 1.1 us
// on one block a multiprocessor and 1.6 us on the 528 blocks of 256
// threads of the design this replaces (empty barriers, chip_smoke.py),
// and each waiting for its slowest block.  That design ran one barrier a
// sweep, about 130 a step at 20 iterations.
//
// Design.  One persistent block of 640 threads on each multiprocessor
// (the fewest arrivals at a barrier; 96 registers a thread, no spill),
// and the solves and diffusions blocked in shared memory
// (step_blocked.cuh): a pass loads a tile with a halo, runs up to k
// red-black half-sweeps or F Jacobi sweeps there, and writes the tile;
// only then comes a grid barrier.  The projection computes its
// divergence into the tile's shared x0 and subtracts the gradient in its
// last pass, so it costs one barrier a pass; the fields that diffuse (u,
// v, w, dens, temp) diffuse in the same passes at the start of the step,
// since the scalars' diffusion reads only the step's inputs.  The
// forcing halves and the advections stride over the cells as before.
// At 20 iterations, k = 4 and F = 3 (kernels.step_plan) that is 30 grid
// barriers a step for config 4 (kernels.step_barriers), from 130.
// Thread block clusters were measured and not used: the card accepts a
// cooperative launch with clusters, but a cluster barrier costs 0.7 us,
// too near a grid barrier to pay for exchanging halos each level.
//
// Each phase runs the cell bodies of the separate kernels (forcing.cuh,
// jacobi.cuh's cell_update, divgrad.cuh, advect.cuh) with the constants
// their wrappers pass, in the same order per cell, so the step equals
// the sequence of separate launches (stam.step3d_multi) bit for bit.
//
// The host plans which buffer each phase reads and writes, and passes
// every phase's arguments as kernel parameters, as the kernels of
// jacobi.cu take theirs; the tiles come from the wrapper
// (kernels.step_plan).
#include "advect.cuh"
#include "forcing.cuh"
#include "step_blocked.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStepThreads = 640;
constexpr int kScratch = 10;

struct Vel {
  const float *u, *v, *w;
};

struct StepArgs {
  // forcing: half A reads the inputs, writes w' and |curl|; half B reads
  // force_in and |curl|, writes force_u, force_v, force_w
  const float *u, *v, *w, *dens, *temp;
  float *w1, *mag;
  Vel force_in;
  float *force_u, *force_v, *force_w;
  int buoy, vort;
  tf::Buoyancy buoyancy;
  float inv_h, eps_h;
  // the diffusions of u, v, w (visc) and dens, temp, in the same passes;
  // then the two projections around the self-advection
  tf::BlockedDiffuse diffuse;
  tf::BlockedProject project_first;
  Vel advect_by;
  tf::AdvectFields advect_vel;
  tf::BlockedProject project_final;
  tf::AdvectFields advect_scalars;  // by the final velocity
  int n;
  float dt0;
};

__global__ void __launch_bounds__(kStepThreads, 1)
    step_whole_kernel(const StepArgs g) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const tf::GridLoop loop;
  const int n = g.n;
  const int cells = (n + 2) * (n + 2) * (n + 2);
  if (g.buoy || g.vort) {
    for (int idx = loop.start; idx < cells; idx += loop.stride)
      tf::forcing_a_cell(idx, g.u, g.v, g.w, g.dens, g.temp, g.w1, g.mag, n,
                         g.buoy, g.vort, g.buoyancy, g.inv_h);
    grid.sync();
    if (g.vort) {
      for (int idx = loop.start; idx < cells; idx += loop.stride)
        tf::forcing_b_cell(idx, g.force_in.u, g.force_in.v, g.force_in.w,
                           g.mag, g.force_u, g.force_v, g.force_w, n,
                           g.buoyancy.dt, g.eps_h, g.inv_h);
      grid.sync();
    }
  }
  if (g.diffuse.fields)
    tf::blocked_solve<float, false, false>(grid, g.diffuse, smem, n);
  tf::blocked_project<false>(grid, g.project_first, smem, n);
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    tf::advect_cell<3>(idx, g.advect_by.u, g.advect_by.v, g.advect_by.w,
                       g.advect_vel, n, g.dt0);
  grid.sync();
  tf::blocked_project<false>(grid, g.project_final, smem, n);
  const tf::BlockedProject& fin = g.project_final;
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    tf::advect_cell<2>(idx, fin.uo, fin.vo, fin.wo, g.advect_scalars, n,
                       g.dt0);
}

tf::StepTiles tiles_of(int n, int tx, int ty, int tz, int halo) {
  const int cx = (n + tx - 1) / tx, cy = (n + ty - 1) / ty,
            cz = (n + tz - 1) / tz;
  return tf::StepTiles{tx, ty, tz, halo, cy, cz, cx * cy * cz};
}

}  // namespace

// The velocity moves between the scratch trios X and Y, a phase reading
// one and writing the other; the velocity diffusion's second buffers
// are uo, vo, wo (written last, by the final projection), and |curl|
// and w' take P[0] and Y[2].  dens and temp diffuse into S with dens_o
// and temp_o as the second buffers (written last, by their advection).
// The pressure passes alternate between P[0] and P[1].  ``blocks``
// persistent blocks of 640 threads (one a multiprocessor), ``smem``
// bytes of dynamic shared memory each (kernels.step_plan); the pressure
// passes run ``rb_levels`` half-sweeps (red-black) or ``jacobi_levels``
// sweeps, the diffusions ``jacobi_levels`` sweeps, on tiles (pt*) and
// (dt*).
extern "C" int tf_step3d_whole(
    const float* u, const float* v, const float* w, const float* dens,
    const float* temp, float* uo, float* vo, float* wo, float* dens_o,
    float* temp_o, float* scratch, int n, int iters, int red_black, int buoy,
    int vort, int visc, int diff, int temp_diff, int blocks, int smem,
    int rb_levels, int jacobi_levels, int ptx, int pty, int ptz, int dtx,
    int dty, int dtz, float dt, float alpha, float beta, float t_amb,
    float inv_h, float eps_h, float div_coef, float p_c_inv, float dt0,
    float visc_a, float visc_c_inv, float diff_a, float diff_c_inv,
    float temp_a, float temp_c_inv, void* stream) {
  const long long cells = (long long)(n + 2) * (n + 2) * (n + 2);
  float* buf[kScratch];
  for (int i = 0; i < kScratch; ++i) buf[i] = scratch + i * cells;
  float* const* X = buf;
  float* const* Y = buf + 3;
  float* const* S = buf + 6;
  float* const* P = buf + 8;

  StepArgs g{};
  g.u = u;
  g.v = v;
  g.w = w;
  g.dens = dens;
  g.temp = temp;
  g.n = n;
  g.dt0 = dt0;
  g.buoy = buoy;
  g.vort = vort;
  g.buoyancy = tf::Buoyancy{dt, alpha, beta, t_amb};
  g.inv_h = inv_h;
  g.eps_h = eps_h;

  Vel cur{u, v, w};
  bool in_x = false;  // cur lies in X (else in the inputs or Y)
  auto other = [&]() { return in_x ? Y : X; };
  if (buoy || vort) {
    g.w1 = buoy ? Y[2] : nullptr;
    g.mag = vort ? P[0] : nullptr;
    if (buoy) cur.w = g.w1;
    if (vort) {
      g.force_in = cur;
      g.force_u = X[0];
      g.force_v = X[1];
      g.force_w = X[2];
      cur = {X[0], X[1], X[2]};
      in_x = true;
    }
  }
  tf::BlockedDiffuse& d = g.diffuse;
  d.iters = iters;
  d.levels = jacobi_levels;
  d.tiles = tiles_of(n, dtx, dty, dtz, jacobi_levels);
  if (visc) {
    float* const* o = other();
    const float* in[3] = {cur.u, cur.v, cur.w};
    float* tmp[3] = {uo, vo, wo};
    for (int f = 0; f < 3; ++f)
      d.f[d.fields++] =
          tf::DiffuseField{in[f], in[f], o[f], tmp[f], f + 1, visc_a,
                           visc_c_inv};
    cur = {o[0], o[1], o[2]};
    in_x = !in_x;
  }
  const float* sd = dens;
  const float* st = temp;
  if (diff) {
    d.f[d.fields++] = tf::DiffuseField{dens, dens, S[0], dens_o, 0, diff_a,
                                       diff_c_inv};
    sd = S[0];
  }
  if (temp_diff) {
    d.f[d.fields++] = tf::DiffuseField{temp, temp, S[1], temp_o, 0, temp_a,
                                       temp_c_inv};
    st = S[1];
  }
  const int levels = red_black ? rb_levels : jacobi_levels;
  const tf::StepTiles pt = tiles_of(n, ptx, pty, ptz, levels + 1);
  // one pressure tile a block, for the whole solve
  if (pt.count > blocks || levels < 1 || jacobi_levels < 1)
    return (int)cudaErrorInvalidConfiguration;
  auto project = [&](float* ou, float* ov, float* ow) {
    return tf::BlockedProject{cur.u,   cur.v, cur.w,    ou,     ov,
                              ow,      P[0],  P[1],     iters,  red_black,
                              levels,  div_coef, inv_h, p_c_inv, pt};
  };
  {
    float* const* o = other();
    g.project_first = project(o[0], o[1], o[2]);
    cur = {o[0], o[1], o[2]};
    in_x = !in_x;
  }
  {
    float* const* o = other();
    g.advect_by = cur;
    g.advect_vel = tf::AdvectFields{{cur.u, cur.v, cur.w}, {o[0], o[1], o[2]},
                                    {1, 2, 3}};
    cur = {o[0], o[1], o[2]};
  }
  g.project_final = project(uo, vo, wo);
  g.advect_scalars = tf::AdvectFields{{sd, st, nullptr},
                                      {dens_o, temp_o, nullptr},
                                      {0, 0, 0}};

  // tf_step3d_whole_info has set the kernel's shared-memory attribute to
  // the most a block may take, once a device; ``smem`` is within it
  void* params[] = {&g};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)step_whole_kernel, dim3((unsigned)blocks),
      dim3(kStepThreads), params, (size_t)smem, (cudaStream_t)stream);
}

// The kernel's shape on the current device: the persistent blocks (one a
// multiprocessor at the most shared memory a block may take), the
// threads of one, and that shared memory in bytes.
extern "C" int tf_step3d_whole_info(int* blocks, int* threads, int* smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(step_whole_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, step_whole_kernel, kStepThreads, optin);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  *threads = kStepThreads;
  *smem = optin;
  return 0;
}

namespace {

__global__ void grid_barrier_kernel(int count) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}

}  // namespace

// ``count`` empty grid-wide barriers in one cooperative launch of
// ``blocks`` blocks of ``threads``: what a barrier costs with no work
// between (chip_smoke.py times it on the step's grid and on the grid of
// the design it replaced).
extern "C" int tf_barrier_probe(int blocks, int threads, int count,
                                void* stream) {
  void* params[] = {&count};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_barrier_kernel, dim3((unsigned)blocks),
      dim3((unsigned)threads), params, 0, (cudaStream_t)stream);
  // a refused probe leaves no error for the next launch's check to find
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
