// The sharded red-black solve: red-black half-sweeps on one x-slab of the
// sharded step, padded with a deep halo, between halo exchanges.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_rb_shard / _solve_rb_shard_kernel,
//   _solve_rb_shard_pipe_kernel                       -> tf_rb_blocked_pass
//                                                        (rb_blocked.cu),
//                                                        tf_rb_shard_finish
//
// The slab holds c_local owned rows with ``halo`` = 2 fuse pad rows a side,
// in the port's ghosted layout: a (rows, n+2, n+2) float32 field whose
// local row r is global row gx0 + r of the (n+2)^3 grid.  The caller
// fills the pad rows (the neighbours' rows, or at a domain face the
// set_bnd ghost row sx * row 1) before each pass of ``fuse`` iterations.
// A pass of 2 fuse half-sweeps is ceil(2 fuse / K) launches of the
// temporally blocked kernel (rb_blocked.cu), out of place between two
// buffers.  A half-sweep updates the cells of its parity in the rows 1 ..
// rows - 2 whose global row is interior: the outermost pad rows and rows
// outside the grid are never written.  A pad row that misses its
// neighbour's update is stale, and the staleness reaches one row further
// each half-sweep; after 2 fuse half-sweeps it has reached the pad's inner
// edge, never an owned row, so the owned rows equal the dense red-black
// solve's.  (A second launch within a pass reads unwritten outer pad rows
// of the buffer; that too reaches no further than the staleness.)
//
// Per cell the arithmetic is tf::cell_update's (jacobi.cuh), so the
// stitched slabs equal the dense lin_solve3d_rb bit for bit: parity by the
// global row, the six neighbours summed in the reference's order, and the
// ghost rule of the dense solve.  The first half-sweep of a solve reads
// the stored ghosts (y and z from the input, x from the seeded pad row at
// a domain face) or, for a zero initial guess, zeros; every later one
// takes a ghost tap as the updating cell's own value times the face's
// sign, which is what set_bnd3d left there.  So no face flags are needed,
// and nothing but the pad is refreshed between passes.  After the last
// pass tf_rb_shard_finish writes the owned rows out with their y and z
// ghosts.
//
// Not carried over from the TPU kernel: the packed A/B phase arrays and
// the z-ghostless layout.
//
// What bounds it on the H100: as the dense solve, device-memory bytes,
// 8 flops a cell a half-sweep.  One launch per half-sweep made one pass
// over the padded slab each (x and x0 in, x out), 1.3x that design's
// floor; the blocked pass reads x and x0 once for up to K half-sweeps
// and writes once (rb_blocked.cu says what bounds it then).
#include "jacobi.cuh"

namespace {

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

extern "C" int tf_rb_shard_finish(const float* x, float* out, int c_local,
                                  int halo, int n, int b, void* stream) {
  const long long cells = (long long)c_local * (n + 2) * (n + 2);
  rb_shard_finish_kernel<<<tf::blocks_of(cells), tf::kThreads, 0,
                           (cudaStream_t)stream>>>(x, out, c_local, halo, n,
                                                   b);
  return tf::launch_status();
}
