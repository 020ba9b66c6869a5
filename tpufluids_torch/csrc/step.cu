// One whole 3D step of the Jacobi path in one cooperative launch:
// forcing, velocity diffusion, projection, velocity self-advection,
// projection, dens/temp diffusion, dens/temp advection.
//
// Replaces step3d_whole_pallas / _step_whole_kernel
// (tpufluids/grid/pallas_kernels.py), which runs the step with its
// fields resident in VMEM.  Here the five fields, their five outputs and
// nine scratch fields stay in the 50 MB L2 at 64^3 (19 fields of
// 1.15 MB), and a grid-wide barrier separates the phases and the sweeps
// (jacobi.cuh).  Each phase runs the cell bodies of the separate kernels
// (forcing.cuh, jacobi.cuh, divgrad.cuh, advect.cuh) with the constants
// their wrappers pass, so the step equals the sequence of separate
// launches (stam.step3d_multi) bit for bit.  About 130 barriers a step at
// 20 iterations, between phases of a few microseconds each.
//
// The host plans which buffer each phase reads and writes, and passes
// every phase's arguments as kernel parameters, as the kernels of
// jacobi.cu take theirs.
#include "advect.cuh"
#include "forcing.cuh"
#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScratch = 9;

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
  // velocity diffusion (visc), then the two projections around the
  // self-advection, then dens/temp diffusion (n_scalar fields)
  int visc, n_scalar;
  tf::DiffuseArgs visc_args;
  tf::ProjectArgs project_first;
  Vel advect_by;
  tf::AdvectFields advect_vel;
  tf::ProjectArgs project_final;
  tf::DiffuseArgs scalar_args;
  tf::AdvectFields advect_scalars;  // by the final velocity
  int n;
  float dt0;
};

__global__ void step_whole_kernel(StepArgs g) {
  cg::grid_group grid = cg::this_grid();
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
  if (g.visc) tf::diffuse_phase<3>(grid, loop, g.visc_args);
  tf::project_phase(grid, loop, g.project_first);
  grid.sync();
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    tf::advect_cell<3>(idx, g.advect_by.u, g.advect_by.v, g.advect_by.w,
                       g.advect_vel, n, g.dt0);
  grid.sync();
  tf::project_phase(grid, loop, g.project_final);
  grid.sync();
  if (g.n_scalar == 2)
    tf::diffuse_phase<2>(grid, loop, g.scalar_args);
  else if (g.n_scalar == 1)
    tf::diffuse_phase<1>(grid, loop, g.scalar_args);
  const tf::ProjectArgs& fin = g.project_final;
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    tf::advect_cell<2>(idx, fin.uo, fin.vo, fin.wo, g.advect_scalars, n,
                       g.dt0);
}

}  // namespace

// The velocity moves between the scratch trios X and Y, a phase reading
// one and writing the other; T holds |curl|, the diffusion's second
// Jacobi buffers, and the projection's div, p and p2, each only within its
// phase.
extern "C" int tf_step3d_whole(
    const float* u, const float* v, const float* w, const float* dens,
    const float* temp, float* uo, float* vo, float* wo, float* dens_o,
    float* temp_o, float* scratch, int n, int iters, int red_black, int buoy,
    int vort, int visc, int diff, int temp_diff, float dt, float alpha,
    float beta, float t_amb, float inv_h, float eps_h, float div_coef,
    float p_c_inv, float dt0, float visc_a, float visc_c_inv, float diff_a,
    float diff_c_inv, float temp_a, float temp_c_inv, void* stream) {
  const long long cells = (long long)(n + 2) * (n + 2) * (n + 2);
  float* buf[kScratch];
  for (int i = 0; i < kScratch; ++i) buf[i] = scratch + i * cells;
  float* const* X = buf;
  float* const* Y = buf + 3;
  float* const* T = buf + 6;

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
    g.mag = vort ? T[0] : nullptr;
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
  g.visc = visc;
  if (visc) {
    float* const* o = other();
    g.visc_args = tf::DiffuseArgs{{cur.u, cur.v, cur.w}, {o[0], o[1], o[2]},
                                  {T[0], T[1], T[2]},    {1, 2, 3},
                                  {visc_a, visc_a, visc_a},
                                  {visc_c_inv, visc_c_inv, visc_c_inv},
                                  n,                     iters};
    cur = {o[0], o[1], o[2]};
    in_x = !in_x;
  }
  auto project = [&](float* ou, float* ov, float* ow) {
    return tf::ProjectArgs{cur.u, cur.v, cur.w, ou, ov,        ow,
                           T[0],  T[1],  T[2],  n,  iters,     red_black,
                           div_coef, inv_h, p_c_inv};
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

  // X and Y are free again: the scalars diffuse into X with Y as the
  // second buffers
  const float* sd = dens;
  const float* st = temp;
  tf::DiffuseArgs& s = g.scalar_args;
  s.n = n;
  s.iters = iters;
  g.n_scalar = 0;
  if (diff) {
    const int f = g.n_scalar++;
    s.in[f] = dens;
    s.out[f] = X[f];
    s.tmp[f] = Y[f];
    s.b[f] = 0;
    s.a[f] = diff_a;
    s.c_inv[f] = diff_c_inv;
    sd = X[f];
  }
  if (temp_diff) {
    const int f = g.n_scalar++;
    s.in[f] = temp;
    s.out[f] = X[f];
    s.tmp[f] = Y[f];
    s.b[f] = 0;
    s.a[f] = temp_a;
    s.c_inv[f] = temp_c_inv;
    st = X[f];
  }
  g.advect_scalars = tf::AdvectFields{{sd, st, nullptr},
                                      {dens_o, temp_o, nullptr},
                                      {0, 0, 0}};
  return tf::launch_cooperative(step_whole_kernel, g, n,
                                (cudaStream_t)stream);
}
