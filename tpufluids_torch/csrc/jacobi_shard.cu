// The sharded red-black solve: red-black half-sweeps on one x-slab of the
// sharded step, padded with a deep halo, between halo exchanges.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_rb_shard / _solve_rb_shard_kernel,
//   _solve_rb_shard_pipe_kernel                       -> tf_rb_shard_sweeps,
//                                                        tf_rb_shard_finish
//
// The slab holds c_local owned rows with ``halo`` = 2 fuse pad rows a side,
// in the port's ghosted layout: a (rows, n+2, n+2) float32 field whose
// local row r is global row gx0 + r of the (n+2)^3 grid.  The caller
// fills the pad rows (the neighbours' rows, or at a domain face the
// set_bnd ghost row sx * row 1) before each pass of ``fuse`` iterations;
// a pass is 2 fuse launches, one per half-sweep, in place.  A half-sweep
// updates the cells of its parity in the rows 1 .. rows - 2 whose global
// row is interior: the outermost pad rows and rows outside the grid are
// never written.  A pad row that misses its neighbour's update is stale,
// and the staleness reaches one row further each half-sweep; after 2 fuse
// half-sweeps it has reached the pad's inner edge, never an owned row,
// so the owned rows equal the dense red-black solve's.
//
// Per cell the arithmetic is tf::rb_cell's (jacobi.cuh), so the stitched
// slabs equal the dense lin_solve3d_rb bit for bit: parity by the global
// row, the six neighbours summed in the reference's order, and the ghost
// rule of the dense in-place kernel.  The first half-sweep of a solve
// reads the stored ghosts (y and z from the input, x from the seeded pad
// row at a domain face) or, for a zero initial guess, no neighbours at
// all; every later one takes a ghost tap as the updating cell's own value
// times the face's sign, which is what set_bnd3d left there.  So no face
// flags are needed, and nothing but the pad is refreshed between passes.
// After the last pass tf_rb_shard_finish writes the owned rows out with
// their y and z ghosts.
//
// Not carried over from the TPU kernel: the packed A/B phase arrays, the
// z-ghostless layout and the VMEM window tiling (_stream_tiles, tx).
//
// What bounds it on the H100: device-memory bytes, as the dense
// half-sweep: x and x0 in and x out, 12 B a cell of the padded slab per
// half-sweep, 8 flops a cell.  One thread per active cell, as
// lin_solve3d_rb's kernel; a pass re-sweeps its 4 fuse pad rows too.
#include "jacobi.cuh"

namespace {

// Active cell t of the half-sweep of parity p over local rows r_lo ..
// r_lo + nr - 1 (all globally interior).  As tf::rb_cell, thread t owns
// the pair K = 2q + 1, 2q + 2 of row (r, J), one of them active.
__global__ void rb_shard_kernel(float* x, const float* __restrict__ x0,
                                int n, int r_lo, int nr, int gx0, int p,
                                int first, int x_zero, tf::Signs s, float a,
                                float c_inv) {
  const int half = (n + 1) / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nr * n * half) return;
  const int r = r_lo + t / (n * half);
  const int I = gx0 + r;
  const int J = 1 + (t / half) % n;
  const int q = t % half;
  const int K = 2 * q + 1 + ((p + I + J) & 1);
  if (K > n) return;
  const int N = n + 2;
  const int c = (r * N + J) * N + K;
  if (first) {
    x[c] = tf::jacobi_at<float>(x_zero ? nullptr : x, x0, c, N, a, c_inv);
    return;
  }
  const float own = x[c];
  float nb = tf::add_rn(I == 1 ? tf::mul_rn(s.x, own) : x[c - N * N],
                        I == n ? tf::mul_rn(s.x, own) : x[c + N * N]);
  nb = tf::add_rn(nb, J == 1 ? tf::mul_rn(s.y, own) : x[c - N]);
  nb = tf::add_rn(nb, J == n ? tf::mul_rn(s.y, own) : x[c + N]);
  nb = tf::add_rn(nb, K == 1 ? tf::mul_rn(s.z, own) : x[c - 1]);
  nb = tf::add_rn(nb, K == n ? tf::mul_rn(s.z, own) : x[c + 1]);
  x[c] = tf::mul_rn(c_inv, tf::add_rn(x0[c], tf::mul_rn(a, nb)));
}

// Out cell (r, j, k) of the c_local owned rows: the slab's row halo + r,
// its y and z ghosts by the set_bnd3d(b) closed form.
__global__ void rb_shard_finish_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int c_local,
                                       int halo, int n, int b) {
  const int N = n + 2;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= c_local * N * N) return;
  const int r = idx / (N * N), j = (idx / N) % N, k = idx % N;
  const int cj = tf::clamp_interior(j, n), ck = tf::clamp_interior(k, n);
  const float sign = (b == 2 && cj != j) || (b == 3 && ck != k) ? -1.0f
                                                                  : 1.0f;
  out[idx] = tf::mul_rn(sign, x[((halo + r) * N + cj) * N + ck]);
}

}  // namespace

// ``half_sweeps`` half-sweeps in place on the padded slab x (rows, n+2,
// n+2), parities 0, 1, 0, ...; ``first``: the first is the solve's first
// half-sweep (x_zero: from a zero guess).
extern "C" int tf_rb_shard_sweeps(float* x, const float* x0, int rows,
                                  int gx0, int n, int half_sweeps, int first,
                                  int x_zero, int b, float a, float c_inv,
                                  void* stream) {
  // the rows a half-sweep updates: 1 .. rows - 2, globally 1 .. n
  const int r_lo = 1 - gx0 > 1 ? 1 - gx0 : 1;
  const int r_hi = n - gx0 < rows - 2 ? n - gx0 : rows - 2;
  const int nr = r_hi - r_lo + 1;
  if (nr < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)nr * n * ((n + 1) / 2);
  const tf::Signs s = tf::signs_for(b);
  cudaStream_t st = (cudaStream_t)stream;
  for (int h = 0; h < half_sweeps; ++h) {
    rb_shard_kernel<<<tf::blocks_of(threads), tf::kThreads, 0, st>>>(
        x, x0, n, r_lo, nr, gx0, h & 1, first && h == 0, x_zero, s, a,
        c_inv);
    const int rc = tf::launch_status();
    if (rc) return rc;
  }
  return 0;
}

extern "C" int tf_rb_shard_finish(const float* x, float* out, int c_local,
                                  int halo, int n, int b, void* stream) {
  const long long cells = (long long)c_local * (n + 2) * (n + 2);
  rb_shard_finish_kernel<<<tf::blocks_of(cells), tf::kThreads, 0,
                           (cudaStream_t)stream>>>(x, out, c_local, halo, n,
                                                   b);
  return tf::launch_status();
}
