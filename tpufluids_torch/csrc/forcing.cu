// Buoyancy + vorticity confinement, in two launches.
//
// Replaces forcing3d_pallas / _force_kernel / _forcing_stage
// (tpufluids/grid/pallas_kernels.py), which does both in one pass with a
// halo of 2 planes held in VMEM.  Here the halo-2 dependency (mag needs
// the curl at +-1, which needs w' at +-2) is cut into two launches
// through two scratch fields the wrapper allocates: launch A writes
// w' = buoyancy(w) with its b = 3 ghosts and |curl| on the interior
// (zero ghosts, as stam.vorticity_confinement3d leaves them); launch B
// writes the confined u, v, w.  Each launch is one pass over at most
// five fields, bound by device-memory bytes.  The cell bodies live in
// forcing.cuh, which the whole step of step.cu shares.
#include "forcing.cuh"

namespace {

__global__ void forcing_a_kernel(const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ dens,
                                 const float* __restrict__ temp,
                                 float* __restrict__ w_out,
                                 float* __restrict__ mag_out, int n,
                                 int buoy, int vort, tf::Buoyancy b,
                                 float inv_h) {
  tf::forcing_a_cell(blockIdx.x * blockDim.x + threadIdx.x, u, v, w, dens,
                     temp, w_out, mag_out, n, buoy, vort, b, inv_h);
}

__global__ void forcing_b_kernel(const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ mag,
                                 float* __restrict__ uo,
                                 float* __restrict__ vo,
                                 float* __restrict__ wo, int n, float dt,
                                 float eps_h, float inv_h) {
  tf::forcing_b_cell(blockIdx.x * blockDim.x + threadIdx.x, u, v, w, mag, uo,
                     vo, wo, n, dt, eps_h, inv_h);
}

}  // namespace

extern "C" int tf_forcing_a(const float* u, const float* v, const float* w,
                            const float* dens, const float* temp,
                            float* w_out, float* mag_out, int n, int buoy,
                            int vort, float dt, float alpha, float beta,
                            float t_amb, float inv_h, void* stream) {
  forcing_a_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                     (cudaStream_t)stream>>>(
      u, v, w, dens, temp, w_out, mag_out, n, buoy, vort,
      tf::Buoyancy{dt, alpha, beta, t_amb}, inv_h);
  return tf::launch_status();
}

extern "C" int tf_forcing_b(const float* u, const float* v, const float* w,
                            const float* mag, float* uo, float* vo, float* wo,
                            int n, float dt, float eps_h, float inv_h,
                            void* stream) {
  forcing_b_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                     (cudaStream_t)stream>>>(u, v, w, mag, uo, vo, wo, n, dt,
                                             eps_h, inv_h);
  return tf::launch_status();
}
