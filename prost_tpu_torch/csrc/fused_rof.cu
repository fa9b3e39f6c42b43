// Fused ROF-by-PDHG chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's ROF routes:
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk      -> _rof_chunk_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_multichunk -> _rof_multichunk_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_batched
//                               -> _rof_chunk_kernel_batched
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_halo
//                               -> _rof_chunk_kernel_halo
// whose math is _chunk_core, _rof_update, _shift_ops, _project_dead_dual,
// _hoist_dataterm and adapt_scalars in the same file.  The batched chunk
// also serves rof_fused_chunk_banded_batched, which bands each instance only
// because a TPU core's VMEM cannot hold a large one.  The plain PyTorch
// versions live beside their wrappers in prost_tpu_torch/ops/fused_rof.py.
//
// Layout (the JAX package's): x, f, w are (nx, ny) row-major f32 planes;
// q, g are two such planes back to back, [gx; gy].  A batched launch takes
// B such instances back to back, (B, nx, ny) and (B, 2, nx, ny), with a
// scalar block of S_LEN per instance, and runs them on the z axis of the
// grid (pdhg_chunk.cuh): one launch per half-iteration for all of them.
// A halo launch takes one shard of a row-partitioned plane with `halo`
// rows of each neighbour above and below it (zeros beyond the plane's
// edges), nx = rows + 2 halo, and the row context of pdhg_chunk.cuh in its
// scalars; the whole-plane launches are its special case (0, nx, 0, nx),
// so they run the same arithmetic.
//
// What bounds it on this card.  The TPU kernels hold the whole state in
// VMEM for a chunk.  A 512x512 f32 plane is 1 MiB and one iteration
// touches about 14 planes (primal: x, 2 q, f in, x out; dual: x, 2 q, 2 g
// in, 2 q, 2 g out), far above the 227 KB of shared memory a block can
// use, so the state stays in device memory (and mostly in the 50 MB L2 at
// 512x512) and every kernel is bound by memory traffic and, at this plane
// size, by launch latency: one chunk of ri iterations is 2*ri + 3 launches.
// A batched chunk of 1024 instances of 128x128 streams 10 planes of 64 MiB
// once (x, 2 q, f in; x, 2 q, x_prev, 2 q_prev out), a bound of about 0.2
// ms, but its working set (about 1 GB) is far beyond L2, so every
// half-iteration streams it from device memory: bound by bytes.
//
// Design.  One thread per pixel, 32x8 blocks with threadIdx.x along the
// contiguous y axis, so warps read and write coalesced rows.  The stencil
// neighbours come straight from global memory through L1/L2, no shared
// tiles (tiling with a halo is later work).  The gradient of x is carried
// from one iteration to the next in g (saves 2 of 6 stencils), and every
// kernel updates its planes in place: a pixel reads only its own x in the
// primal step and only its own q and g in the dual step; neighbour reads
// go to the plane the kernel does not write.  The scalars (tau, sigma,
// theta, lmb, radius, adaptation state, converged flag, norms) live in a
// small device buffer `sc`, read by every kernel: the step sizes never
// cross to the host, and a kernel returns at once when sc[CONV] is set, so
// the host can queue a whole multichunk launch sequence without a sync.
// Norms are reduced in two deterministic passes (per-block tree, then one
// block over the partials), with no atomics, so reruns are bit-stable.
//
// Rounding.  The build passes -fmad=false: no multiply-add is contracted
// into an FMA, so each expression rounds in the same places as the plain
// PyTorch version (one op per kernel there).  rsqrtf is approximate (up
// to 2 ulp) and maps 0 to +inf; radius * inf is NaN when radius == 0, so
// the projection guards a zero vector (its projection is itself for every
// radius).  The remaining differences to the plain version are rsqrtf and
// the order of the norm sums.
//
// The scalar slots, the pixel grid, the second norm pass with the
// adaptation (pdhg_finish) and the launch check are shared with the
// multilabel kernels in pdhg_chunk.cuh.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "pdhg_chunk.cuh"

namespace {

// the family's two scalars in the buffer's slots 3 and 4
enum { S_LMB = S_ARG3, S_RADIUS = S_ARG4 };

enum { DT_SQUARE = 0, DT_WSQUARE = 1, DT_ABS = 2 };

constexpr float SQRT_S = 0.7071067811865476f;  // sqrt(Sigma) = sqrt(1/2)
constexpr float SQRT_T = 0.5f;                 // sqrt(Tau)   = sqrt(1/4)

struct Planes {
  float* x;    // (nx, ny) iterate, updated in place
  float* q;    // (2, nx, ny) dual, updated in place
  float* xp;   // x before the chunk's last (aligned) iteration
  float* qp;   // q before the aligned iteration
  float* g;    // grad x carried between iterations
  float* gp;   // grad x_prev
  const float* f;
  const float* w;
  float* sc;
  float* partial;  // 4 per block
  int nx, ny;
  int nxg;  // rows of the global plane of a halo launch; 0: the whole plane
};

// The planes of this block's instance (blockIdx.z) of a batched launch:
// every buffer moved by its per-instance size, with 64-bit offsets.
__device__ __forceinline__ Planes instance_of(Planes b) {
  size_t z = blockIdx.z, n = (size_t)b.nx * b.ny;
  b.x += z * n;
  b.q += 2 * z * n;
  b.xp += z * n;
  b.qp += 2 * z * n;
  b.g += 2 * z * n;
  b.gp += 2 * z * n;
  b.f += z * n;
  b.w += z * n;
  b.sc += z * S_LEN;
  return b;
}

// Adjoint stencil K^T q at (i, j).  Reading the upper neighbour only where
// row i has one (has_above) and the pixel's own q unmasked equals the JAX
// package's masked adjoint because the dead coordinates (q_x's global last
// row, q_y's last column) are zero: rof_seed zeroes them and the dual step
// keeps them zero.  On a shard the upper mask is what keeps global row 0
// from reading the halo rows above it, which are not zero after a dual
// step on an edge shard.
__device__ __forceinline__ float kty_at(const float* q, const RowCtx& r,
                                        int i, int j, int ny, size_t n) {
  size_t p = (size_t)i * ny + j;
  float qx = q[p], qy = q[n + p];
  float lx = has_above(r, i) ? q[p - ny] : 0.f;
  float ly = j > 0 ? q[n + p - 1] : 0.f;
  return (lx - qx) + (ly - qy);
}

// Seed of a launch: g = grad x, and the dead dual coordinates zeroed
// (_project_dead_dual at chunk entry; the dual step keeps them zero).
// Replaces the seed stencils of _chunk_core / _rof_multichunk_kernel.
// Bound: memory, 1 plane read, 2 written.  Runs once per launch.
__global__ void rof_seed(Planes b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j, nx = b.nx, ny = b.ny;
  if (!pixel(nx, ny, i, j)) return;
  RowCtx r = row_ctx(b.sc, nx, b.nxg);
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  float xv = b.x[p];
  b.g[p] = has_below(r, i, nx) ? b.x[p + ny] - xv : 0.f;
  b.g[n + p] = j < ny - 1 ? b.x[p + 1] - xv : 0.f;
  if (dead_row(r, i)) b.q[p] = 0.f;
  if (j == ny - 1) b.q[n + p] = 0.f;
}

// Primal step (_rof_update, first half): x <- prox_g(x - tau/4 K^T q),
// with the data term hoisted as in _hoist_dataterm.
// Bound: memory, 4 planes read (x, q_x, q_y, f; +w for wsquare), 1
// written (2 on the aligned iteration, which also saves x_prev).  The
// q neighbours one row up are reread by the next warp row, so they come
// from L1/L2, not device memory.
__global__ void rof_primal(Planes b, int dataterm, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j, nx = b.nx, ny = b.ny;
  if (!pixel(nx, ny, i, j)) return;
  float* __restrict__ x = b.x;
  const float* __restrict__ q = b.q;
  const float* __restrict__ f = b.f;
  const float* __restrict__ w = b.w;
  const float* __restrict__ sc = b.sc;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  float tau = sc[S_TAU] * 0.25f;  // tau * Tau
  float lmb = sc[S_LMB];
  float kty = kty_at(q, row_ctx(sc, nx, b.nxg), i, j, ny, n);
  float xv = x[p];
  float arg = xv - tau * kty;
  float xn;
  if (dataterm == DT_SQUARE) {
    float dt0 = (tau * lmb) * f[p];
    float dt1 = 1.f / (1.f + tau * lmb);
    xn = (arg + dt0) * dt1;
  } else if (dataterm == DT_WSQUARE) {
    float tw = (tau * lmb) * w[p];
    float dt0 = tw * f[p];
    float dt1 = 1.f / (1.f + tw);
    xn = (arg + dt0) * dt1;
  } else {  // abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
    float t = tau * lmb;
    float d = arg - f[p];
    xn = arg - fminf(fmaxf(d, -t), t);
  }
  if (save_prev) b.xp[p] = xv;
  x[p] = xn;
}

// Dual step (_rof_update, second half): q <- proj_{|.|<=r}(q + sig_p grad
// x_new - sig_t grad x), grad x_new carried into g.
// Bound: memory, 5 planes read (x, q, g), 4 written (8 on the aligned
// iteration, which saves q_prev and grad x_prev).  Carrying g saves the
// two stencils of grad x_old that the extrapolation would need.
__global__ void rof_dual(Planes b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j, nx = b.nx, ny = b.ny;
  if (!pixel(nx, ny, i, j)) return;
  const float* __restrict__ x = b.x;
  float* __restrict__ q = b.q;
  float* __restrict__ g = b.g;
  float* __restrict__ qp = b.qp;
  float* __restrict__ gp = b.gp;
  const float* __restrict__ sc = b.sc;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  float sigma_p = sc[S_SIGMA] * 0.5f;  // sigma * Sigma
  float theta = sc[S_THETA];
  float sig_p = sigma_p * (1.f + theta);
  float sig_t = sigma_p * theta;
  float xv = x[p];
  float gxn = has_below(row_ctx(sc, nx, b.nxg), i, nx) ? x[p + ny] - xv
                                                        : 0.f;
  float gyn = j < ny - 1 ? x[p + 1] - xv : 0.f;
  float qx = q[p], qy = q[n + p], gx = g[p], gy = g[n + p];
  float ax = (qx + sig_p * gxn) - sig_t * gx;
  float ay = (qy + sig_p * gyn) - sig_t * gy;
  float nn = ax * ax + ay * ay;
  float scale = nn > 0.f ? fminf(1.f, sc[S_RADIUS] * rsqrtf(nn)) : 1.f;
  if (save_prev) {
    qp[p] = qx;
    qp[n + p] = qy;
    gp[p] = gx;
    gp[n + p] = gy;
  }
  q[p] = ax * scale;
  q[n + p] = ay * scale;
  g[p] = gxn;
  g[n + p] = gyn;
}

// First pass of the four preconditioned residual norms (_chunk_core after
// the aligned iteration): per-block tree sums of |pd|^2, |z_hat|^2,
// |dd|^2, |w_hat|^2 into partial[4 * block], over the owned rows.
// Bound: memory, 10 planes read once per chunk; the tree sum in shared
// memory replaces the TPU kernel's whole-plane jnp.sum into SMEM.
__global__ void rof_norm_partial(Planes b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  if (pixel(b.nx, b.ny, i, j) && owned_row(r, i)) {
    int ny = b.ny;
    size_t n = (size_t)b.nx * ny, p = (size_t)i * ny + j;
    float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
    float theta = b.sc[S_THETA];
    float inv_s = 1.f / (sigma_raw * SQRT_S);
    float inv_t = 1.f / (tau_raw * SQRT_T);
    float kty2 = kty_at(b.q, r, i, j, ny, n);
    float ktyp = kty_at(b.qp, r, i, j, ny, n);
    float zx = (b.qp[p] - b.q[p]) * inv_s
               + SQRT_S * ((1.f + theta) * b.g[p] - theta * b.gp[p]);
    float zy = (b.qp[n + p] - b.q[n + p]) * inv_s
               + SQRT_S * ((1.f + theta) * b.g[n + p] - theta * b.gp[n + p]);
    float pdx = zx - SQRT_S * b.g[p];
    float pdy = zy - SQRT_S * b.g[n + p];
    float wh = (b.xp[p] - b.x[p]) * inv_t - SQRT_T * ktyp;
    float dd = wh + SQRT_T * kty2;
    v[0] = pdx * pdx + pdy * pdy;
    v[1] = zx * zx + zy * zy;
    v[2] = dd * dd;
    v[3] = wh * wh;
  }
  block_partials(v, b.partial);
}

// One chunk of `count` iterations of `batch` instances without the seed:
// count-1 plain iterations, the aligned iteration saving x_prev / q_prev /
// grad x_prev, and the per-block norm partials.
int chunk_body(const Planes& b, int count, int dataterm, int batch,
               cudaStream_t s) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  for (int k = 0; k < count; ++k) {
    int last = k == count - 1;
    rof_primal<<<grid, block, 0, s>>>(b, dataterm, last);
    LAUNCH_CHECK();
    rof_dual<<<grid, block, 0, s>>>(b, last);
    LAUNCH_CHECK();
  }
  rof_norm_partial<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  return 0;
}

// One chunk of `batch` instances: the seed, the chunk body, and the
// squared norms of every instance into its scalars (one finish block each).
int chunk(const Planes& b, int count, int dataterm, int batch,
          cudaStream_t s) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  rof_seed<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  int rc = chunk_body(b, count, dataterm, batch, s);
  if (rc) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, s>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                    count, 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

Planes planes_of(void* x, void* q, void* xp, void* qp, void* g, void* gp,
                 const void* f, const void* w, void* sc, void* partial,
                 int nx, int ny) {
  Planes b;
  b.x = (float*)x;
  b.q = (float*)q;
  b.xp = (float*)xp;
  b.qp = (float*)qp;
  b.g = (float*)g;
  b.gp = (float*)gp;
  b.f = (const float*)f;
  b.w = (const float*)w;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  return b;
}

}  // namespace

extern "C" {

// Number of per-block norm partials (4 floats each) for an (nx, ny) plane.
int prost_rof_num_blocks(int nx, int ny) {
  dim3 g = grid_of(nx, ny);
  return (int)(g.x * g.y);
}

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rof_fused_chunk: `count` iterations on (x, q) in place, x_prev / q_prev
// of the aligned iteration into (xp, qp), the 4 SQUARED norms into
// sc[S_NORM..].  No-op when sc[S_CONV] is set.
int prost_rof_chunk(void* x, void* q, void* xp, void* qp, void* g, void* gp,
                    const void* f, const void* w, void* sc, void* partial,
                    int nx, int ny, int count, int dataterm, void* stream) {
  Planes b = planes_of(x, q, xp, qp, g, gp, f, w, sc, partial, nx, ny);
  return chunk(b, count, dataterm, 1, (cudaStream_t)stream);
}

// rof_fused_chunk_batched: the same for `batch` instances in one launch
// sequence; sc holds S_LEN scalars per instance, partial 4 per block per
// instance.  An instance whose sc[S_CONV] is set is a no-op.
int prost_rof_chunk_batched(void* x, void* q, void* xp, void* qp, void* g,
                            void* gp, const void* f, const void* w, void* sc,
                            void* partial, int nx, int ny, int count,
                            int dataterm, int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  Planes b = planes_of(x, q, xp, qp, g, gp, f, w, sc, partial, nx, ny);
  return chunk(b, count, dataterm, batch, (cudaStream_t)stream);
}

// rof_fused_chunk_halo: rof_chunk on one halo-extended shard of a plane of
// nx_global rows; sc holds the row context (S_ROW_OFF, S_OWN_LO, S_OWN_HI)
// and the squared norms cover the owned rows only.
int prost_rof_chunk_halo(void* x, void* q, void* xp, void* qp, void* g,
                         void* gp, const void* f, const void* w, void* sc,
                         void* partial, int nx, int ny, int nx_global,
                         int count, int dataterm, void* stream) {
  Planes b = planes_of(x, q, xp, qp, g, gp, f, w, sc, partial, nx, ny);
  b.nxg = nx_global;
  return chunk(b, count, dataterm, 1, (cudaStream_t)stream);
}

// rof_fused_multichunk: up to k_chunks chunks, the gradient carried across
// chunks, adaptation + stopping test on the device after each chunk, and
// every kernel after convergence returning at once (the lax.cond skip).
// sc[S_NORM..] ends with the last executed chunk's sqrt'd norms.
int prost_rof_multichunk(void* x, void* q, void* xp, void* qp, void* g,
                         void* gp, const void* f, const void* w, void* sc,
                         void* partial, int nx, int ny, int count,
                         int k_chunks, int dataterm, int stepsize,
                         float sqrt_nrows, float sqrt_ncols, float arg_delta,
                         float arg_nu, float arb_delta, float arb_tau,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Planes b = planes_of(x, q, xp, qp, g, gp, f, w, sc, partial, nx, ny);
  dim3 grid = grid_of(nx, ny), block(BX, BY);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  rof_seed<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  for (int k = 0; k < k_chunks; ++k) {
    int rc = chunk_body(b, count, dataterm, 1, s);
    if (rc) return rc;
    pdhg_finish<<<1, FIN, 0, s>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                  count, 1, stepsize, c);
    LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
