// The 2D grid kernels: the Jacobi solve with set_bnd2d, and the whole 2D
// step.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve2d_pallas / _lin_solve2d_kernel     -> tf_lin_solve2d
//   step2d_whole_pallas / _step2d_whole_kernel   -> tf_step2d_whole
//
// A 2D field is small: 130^2 float32 (n = 128) is 68 KB.  The TPU kernels
// keep it in VMEM for a whole solve or step.  Here one thread block of
// 1024 threads runs every sweep and every phase, with a block barrier
// (__syncthreads) between them; a solve's two ping-pong buffers live in
// the block's shared memory (2 (n+2)^2 floats, 135 KB at n = 128, opted in
// above 48 KB), every other field in device memory, where it stays in L2.
// What bounds it on the H100 is latency, not bytes or operations: a sweep
// is some 17 cells a thread, and the sweeps are serial.  A solve whose
// buffers do not fit shared memory (n + 2 > 170) keeps them in device
// memory, still in one block.
//
// Every output cell is written by one thread, ghosts included, with no
// atomics.  A ghost takes the value set_bnd2d leaves there, computed from
// the new interior value at its clamped index (recomputed by the ghost's
// thread, so no second pass): sx or sy times it on an edge, and 0.5 (sy c
// + sx c) at a corner, c the diagonal interior value (stam.set_bnd2d's
// corner averages of the two edge cells).  The arithmetic is that of the
// plain PyTorch version, operation by operation with one rounding each
// (-fmad=false), so kernel and plain version agree bit for bit.  One
// exception in form, not in bits: the plain version divides a tensor by
// the Python scalar h, which PyTorch's CUDA division computes as a
// product with the reciprocal 1 / h taken in double and rounded to float
// (n itself for h = 1 / n), so the kernel multiplies by that reciprocal,
// passed from Python.  PyTorch on the CPU divides by fl(h) instead; the
// two meet for n a power of two.  No pointer is __restrict__: a phase
// reads what the phase before wrote.
#include <math.h>

#include "grid_common.cuh"

namespace {

constexpr int kBlock = 1024;

struct Bnd {
  float sx, sy;
};

__host__ __device__ inline Bnd bnd_for(int b) {
  return {b == 1 ? -1.0f : 1.0f, b == 2 ? -1.0f : 1.0f};
}

// Output cell (i, j): c is the flat index of its clamped interior cell,
// xo / yo whether i / j lie on a ghost row / column.
struct Cell2 {
  int c;
  bool xo, yo;
};

__device__ __forceinline__ Cell2 cell2(int idx, int n) {
  const int N = n + 2, i = idx / N, j = idx % N;
  const int ci = tf::clamp_interior(i, n), cj = tf::clamp_interior(j, n);
  return {ci * N + cj, ci != i, cj != j};
}

// The value set_bnd2d(b) leaves at the cell, given the interior value c
// at its clamped index.
__device__ __forceinline__ float bnd(const Cell2& g, Bnd s, float c) {
  if (g.xo && g.yo) return 0.5f * (s.sy * c + s.sx * c);
  if (g.xo) return s.sx * c;
  if (g.yo) return s.sy * c;
  return c;
}

// The Jacobi update (x0 + a * nb) * c_inv of interior cell c, the
// neighbours summed x-1, x+1, y-1, y+1; src NULL is a zero field.
__device__ __forceinline__ float jacobi2d(const float* src, const float* x0,
                                          int c, int N, float a,
                                          float c_inv) {
  float nb = 0.0f;
  if (src) {
    nb = src[c - N] + src[c + N];
    nb = nb + src[c - 1];
    nb = nb + src[c + 1];
  }
  return (x0[c] + a * nb) * c_inv;
}

// ``iters`` Jacobi sweeps, each followed by set_bnd2d: sweep k reads x
// (k = 0; NULL for a zero guess) or the buffer sweep k - 1 wrote, and
// writes ``even`` or ``odd`` by the parity of k, or ``last`` (if not NULL)
// for the last sweep.  A barrier follows every sweep.  Returns the buffer
// that holds the result.
__device__ __forceinline__ float* solve2d(const float* x, const float* x0,
                                          float* even, float* odd,
                                          float* last, int n, int iters,
                                          Bnd s, float a, float c_inv) {
  const int N = n + 2;
  const float* src = x;
  float* dst = nullptr;
  for (int k = 0; k < iters; ++k) {
    dst = (last && k == iters - 1) ? last : ((k & 1) ? odd : even);
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const Cell2 g = cell2(idx, n);
      dst[idx] = bnd(g, s, jacobi2d(src, x0, g.c, N, a, c_inv));
    }
    __syncthreads();
    src = dst;
  }
  return dst;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; a request past the card's limit returns its error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

__global__ void __launch_bounds__(kBlock)
    lin_solve2d_kernel(const float* x, const float* x0, float* even,
                       float* odd, float* last, int n, int iters, Bnd s,
                       float a, float c_inv) {
  extern __shared__ float smem[];
  if (!even) {
    even = smem;
    odd = smem + (n + 2) * (n + 2);
  }
  solve2d(x, x0, even, odd, last, n, iters, s, a, c_inv);
}

// ---------------------------------------------------------------------------
// the whole step

struct Pair {
  const float *u, *v;
};

struct OutPair {
  float *u, *v;
};

struct Diffuse {
  const float* in;  // x and x0
  float* out;
  float a, c_inv;
};

struct Step2dArgs {
  const float *u, *v, *dens, *temp;
  int n, iters, buoy, vort, visc, diff, temp_diff;
  float dt, alpha, beta, t_amb, inv_h, eps_h, neg_eps_h, div_coef, dt0;
  float* buoy_v;         // v after buoyancy (reads v, dens, temp)
  Pair vort_in;          // vorticity confinement: reads vort_in, writes
  float* mag;            // |curl| (0 on the ghosts), then vort_out
  OutPair vort_out;
  Diffuse visc_u, visc_v;
  Pair first_in;         // the first projection, div in ``div``
  OutPair first_out;
  float* div;
  Pair advect_in;        // self-advection by advect_in
  OutPair advect_out;
  Pair final_in;         // the final projection into the outputs
  OutPair final_out;
  Diffuse dens_diff, temp_diff_args;
  Pair scalars;          // dens and temp as advected, by final_out
  OutPair scalars_out;
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

// divergence, zero-guess pressure solve in shared memory (a = 1, c = 4,
// b = 0), gradient subtraction; as stam.project2d.
__device__ __forceinline__ void project2d(const Step2dArgs& g, Pair in,
                                          OutPair out, float* s0,
                                          float* s1) {
  const int n = g.n, N = n + 2;
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const Cell2 c = cell2(idx, n);
    const int k = c.c;
    g.div[idx] = bnd(c, bnd_for(0),
                     g.div_coef * (((in.u[k + N] - in.u[k - N]) + in.v[k + 1])
                                   - in.v[k - 1]));
  }
  __syncthreads();
  const float* p = solve2d(nullptr, g.div, s0, s1, nullptr, n, g.iters,
                           bnd_for(0), 1.0f, 0.25f);
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const Cell2 c = cell2(idx, n);
    const int k = c.c;
    out.u[idx] = bnd(c, bnd_for(1),
                     in.u[k] + (-0.5f * (p[k + N] - p[k - N])) * g.inv_h);
    out.v[idx] = bnd(c, bnd_for(2),
                     in.v[k] + (-0.5f * (p[k + 1] - p[k - 1])) * g.inv_h);
  }
  __syncthreads();
}

// 9-tap stencil advection of the two fields of ``q`` by ``vel`` into
// ``out`` with set_bnd2d(b0) and (b1); as stam._advect_stencil.
__device__ __forceinline__ void advect2d(const Step2dArgs& g, Pair vel,
                                         Pair q, OutPair out, int b0,
                                         int b1) {
  const int n = g.n, N = n + 2;
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const Cell2 c = cell2(idx, n);
    const int k = c.c;
    const float at[2] = {(float)(k / N), (float)(k % N)};
    const float v[2] = {vel.u[k], vel.v[k]};
    // hat[a][d + 1] = max(0, 1 - |off_a - d|), the backtrace offset
    // clamped to one cell and to the source range [0.5, n + 0.5]
    float hat[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float off = fminf(fmaxf(-g.dt0 * v[a], -1.0f), 1.0f);
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
    out.u[idx] = bnd(c, bnd_for(b0), acc0);
    out.v[idx] = bnd(c, bnd_for(b1), acc1);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock) step2d_whole_kernel(Step2dArgs g) {
  extern __shared__ float smem[];
  const int n = g.n, N = n + 2, cells = N * N;
  float* s0 = smem;
  float* s1 = smem + cells;
  if (g.buoy) {
    // stam.buoyancy2d
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const Cell2 c = cell2(idx, n);
      const int k = c.c;
      const float f = -g.alpha * g.dens[k] + g.beta * (g.temp[k] - g.t_amb);
      g.buoy_v[idx] = bnd(c, bnd_for(2), g.v[k] + g.dt * f);
    }
    __syncthreads();
  }
  if (g.vort) {
    // stam.vorticity_confinement2d: |curl|, then the force
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const Cell2 c = cell2(idx, n);
      g.mag[idx] =
          (c.xo || c.yo) ? 0.0f : fabsf(curl2d(g.vort_in, c.c, N, g.inv_h));
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const Cell2 c = cell2(idx, n);
      const int k = c.c;
      const float curl = curl2d(g.vort_in, k, N, g.inv_h);
      float gx = dq(g.mag, k, N, g.inv_h);
      float gy = dq(g.mag, k, 1, g.inv_h);
      const float norm = sqrtf(gx * gx + gy * gy) + 1e-5f;
      gx = gx / norm;
      gy = gy / norm;
      const float fu = g.eps_h * gy * curl;
      const float fv = g.neg_eps_h * gx * curl;
      g.vort_out.u[idx] = bnd(c, bnd_for(1), g.vort_in.u[k] + g.dt * fu);
      g.vort_out.v[idx] = bnd(c, bnd_for(2), g.vort_in.v[k] + g.dt * fv);
    }
    __syncthreads();
  }
  if (g.visc) {
    solve2d(g.visc_u.in, g.visc_u.in, s0, s1, g.visc_u.out, n, g.iters,
            bnd_for(1), g.visc_u.a, g.visc_u.c_inv);
    solve2d(g.visc_v.in, g.visc_v.in, s0, s1, g.visc_v.out, n, g.iters,
            bnd_for(2), g.visc_v.a, g.visc_v.c_inv);
  }
  project2d(g, g.first_in, g.first_out, s0, s1);
  advect2d(g, g.advect_in, g.advect_in, g.advect_out, 1, 2);
  project2d(g, g.final_in, g.final_out, s0, s1);
  if (g.diff)
    solve2d(g.dens_diff.in, g.dens_diff.in, s0, s1, g.dens_diff.out, n,
            g.iters, bnd_for(0), g.dens_diff.a, g.dens_diff.c_inv);
  if (g.temp_diff)
    solve2d(g.temp_diff_args.in, g.temp_diff_args.in, s0, s1,
            g.temp_diff_args.out, n, g.iters, bnd_for(0),
            g.temp_diff_args.a, g.temp_diff_args.c_inv);
  advect2d(g, {g.final_out.u, g.final_out.v}, g.scalars, g.scalars_out, 0,
           0);
}

}  // namespace

extern "C" int tf_lin_solve2d(const float* x, const float* x0, float* out,
                              float* tmp, int b, int n, int iters, float a,
                              float c_inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Bnd s = bnd_for(b);
  if (tmp) {
    // device-memory buffers: the last sweep's natural buffer is out
    const bool odd_last = (iters - 1) & 1;
    lin_solve2d_kernel<<<1, kBlock, 0, st>>>(x, x0, odd_last ? tmp : out,
                                             odd_last ? out : tmp, nullptr,
                                             n, iters, s, a, c_inv);
    return tf::launch_status();
  }
  const size_t bytes = 2 * sizeof(float) * (size_t)(n + 2) * (n + 2);
  const int rc = allow_smem(lin_solve2d_kernel, bytes);
  if (rc) return rc;
  lin_solve2d_kernel<<<1, kBlock, bytes, st>>>(x, x0, nullptr, nullptr, out,
                                               n, iters, s, a, c_inv);
  return tf::launch_status();
}

// The velocity moves between the scratch pairs X and Y, a phase reading
// one and writing the other; M holds |curl| and D the projections'
// divergence.  Once the final projection has written the outputs, X takes
// the diffused dens and temp.
extern "C" int tf_step2d_whole(
    const float* u, const float* v, const float* dens, const float* temp,
    float* uo, float* vo, float* dens_o, float* temp_o, float* scratch,
    int n, int iters, int buoy, int vort, int visc, int diff, int temp_diff,
    float dt, float alpha, float beta, float t_amb, float inv_h,
    float eps_h,
    float neg_eps_h, float div_coef, float dt0, float visc_a,
    float visc_c_inv, float diff_a, float diff_c_inv, float temp_a,
    float temp_c_inv, void* stream) {
  const size_t cells = (size_t)(n + 2) * (n + 2);
  float* buf[6];
  for (int i = 0; i < 6; ++i) buf[i] = scratch + i * cells;
  const OutPair X{buf[0], buf[1]}, Y{buf[2], buf[3]};

  Step2dArgs g{};
  g.u = u;
  g.v = v;
  g.dens = dens;
  g.temp = temp;
  g.n = n;
  g.iters = iters;
  g.buoy = buoy;
  g.vort = vort;
  g.visc = visc;
  g.diff = diff;
  g.temp_diff = temp_diff;
  g.dt = dt;
  g.alpha = alpha;
  g.beta = beta;
  g.t_amb = t_amb;
  g.inv_h = inv_h;
  g.eps_h = eps_h;
  g.neg_eps_h = neg_eps_h;
  g.div_coef = div_coef;
  g.dt0 = dt0;
  g.mag = buf[4];
  g.div = buf[5];

  Pair cur{u, v};
  bool in_x = false;  // cur lies in X (else in the inputs or Y)
  auto next = [&]() {
    const OutPair o = in_x ? Y : X;
    in_x = !in_x;
    return o;
  };
  if (buoy) {
    g.buoy_v = Y.v;
    cur.v = Y.v;
  }
  if (vort) {
    g.vort_in = cur;
    g.vort_out = X;
    cur = {X.u, X.v};
    in_x = true;
  }
  if (visc) {
    const OutPair o = next();
    g.visc_u = Diffuse{cur.u, o.u, visc_a, visc_c_inv};
    g.visc_v = Diffuse{cur.v, o.v, visc_a, visc_c_inv};
    cur = {o.u, o.v};
  }
  g.first_in = cur;
  g.first_out = next();
  cur = {g.first_out.u, g.first_out.v};
  g.advect_in = cur;
  g.advect_out = next();
  g.final_in = {g.advect_out.u, g.advect_out.v};
  g.final_out = OutPair{uo, vo};
  g.scalars = {dens, temp};
  g.dens_diff = Diffuse{dens, X.u, diff_a, diff_c_inv};
  g.temp_diff_args = Diffuse{temp, X.v, temp_a, temp_c_inv};
  if (diff) g.scalars.u = X.u;
  if (temp_diff) g.scalars.v = X.v;
  g.scalars_out = OutPair{dens_o, temp_o};

  const size_t bytes = 2 * sizeof(float) * cells;
  const int rc = allow_smem(step2d_whole_kernel, bytes);
  if (rc) return rc;
  step2d_whole_kernel<<<1, kBlock, bytes, (cudaStream_t)stream>>>(g);
  return tf::launch_status();
}
