// Fused ROF-by-PDHG chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's ROF routes:
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk      -> _rof_chunk_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_multichunk -> _rof_multichunk_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_batched
//                               -> _rof_chunk_kernel_batched
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_halo
//                               -> _rof_chunk_kernel_halo
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_banded
//                               -> _rof_banded_kernel, _rof_banded_db_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_multichunk_banded
//                               -> _rof_banded_mc_kernel
//   prost_tpu/ops/fused_rof.py  rof_fused_chunk_banded_batched
//                               -> _rof_banded_kernel on a (B, n_bands) grid
// whose math is _chunk_core, _rof_update, _shift_ops, _project_dead_dual,
// _hoist_dataterm and adapt_scalars in the same file.  The plain PyTorch
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
// VMEM for a chunk.  One iteration touches about 14 planes (primal: x, 2
// q, f in, x out; dual: x, 2 q, 2 g in, 2 q, 2 g out); at 512x512 a plane
// is 1 MiB and a launch of one half-step does about 3 us of work, so a
// chunk streamed through device memory (and the 50 MB L2) is paced by
// launch latency: 2*ri + 3 launches a chunk, 1 + k (2*ri + 2) a multichunk.
// Split over the card's SMs, though, the chunk's state is small: a block
// of one SM holds 4 rows of each plane at 512x512 (58 KB, 68 KB with
// wsquare's w).  So each chunk has three paths, bit-equal to each other:
//   * the grid-resident launch (rof_resident, rof_multichunk_resident,
//     further down): one cooperative launch a chunk (of the whole plane or
//     of a halo band), or a multichunk of k chunks with the adaptation
//     between them, one block per SM holding a band of rows of every plane
//     in shared memory;
//   * the tiled launch (rof_tiled, further down), for planes whose band
//     does not fit in the shared memory a block may opt into (2048x1536
//     and 2048x2048 need 600-800 KB a block, the 2092-row band of a
//     2048-wide plane about 800 KB): one launch a chunk over overlapping
//     2-D windows, each block holding its tile and the chunk's halo; with
//     the instance on blockIdx.z it is also the batched chunk of the
//     instances that no cluster holds (rof_fused_chunk_banded_batched);
//   * the streaming launch sequence (rof_seed, rof_primal, rof_dual,
//     rof_norm_partial, pdhg_finish), for chunks whose halo no window
//     holds and for the comparisons.
// The wrapper's shape rule (ops/fused_rof.py route_of, on the card's SM
// count and opt-in limit) picks the path before the launch.  A batched
// chunk of 1024 instances of 128x128 streams 10 planes of 64 MiB once
// (x, 2 q, f in; x, 2 q, x_prev, 2 q_prev out), a bound of about 0.2 ms;
// its working set (about 1 GB) is far beyond L2, so it holds each
// instance on chip in a thread-block cluster (rof_chunk_cluster below)
// wherever one of at most 8 CTAs holds it, and runs larger instances
// tiled, each block one tile of one instance.
//
// Design of the streaming kernels.  One thread per pixel, 32x8 blocks
// with threadIdx.x along the contiguous y axis, so warps read and write
// coalesced rows.  The stencil neighbours come straight from global memory
// through L1/L2.  The gradient of x is carried from one iteration to the
// next in g (saves 2 of 6 stencils), and every kernel updates its planes
// in place: a pixel reads only its own x in the primal step and only its
// own q and g in the dual step; neighbour reads go to the plane the kernel
// does not write.  The scalars (tau, sigma, theta, lmb, radius, adaptation
// state, converged flag, norms) live in a small device buffer `sc`, read
// by every kernel: the step sizes never cross to the host, and a kernel
// returns at once when sc[CONV] is set, so the host can queue a whole
// multichunk launch sequence without a sync.  Norms are reduced in two
// deterministic passes (per-block tree, then one block over the partials),
// with no atomics, so reruns are bit-stable; the resident launches reduce
// the same 32x8 tiles in the same tree.
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

#include <cooperative_groups.h>

#include "cp_async.cuh"
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
  float* terms;    // the resident launches' scratch, 8 (nx, ny) planes: the
                   // norm terms, then 2 parities of q_x and q_y rows
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

// The primal prox at one pixel (_rof_update, first half, with the data
// term hoisted as in _hoist_dataterm): x_new from x, K^T q and the pixel's
// f and w (w is used for wsquare only), given tl = tau * lmb and, for the
// square data term, dt1 = 1 / (1 + tl) (the same for every pixel: a loop
// forms them once).
__device__ __forceinline__ float primal_at(float xv, float kty, float fv,
                                           float wv, float tau, float tl,
                                           float dt1, int dataterm) {
  float arg = xv - tau * kty;
  if (dataterm == DT_SQUARE) {
    float dt0 = tl * fv;
    return (arg + dt0) * dt1;
  }
  if (dataterm == DT_WSQUARE) {
    float tw = tl * wv;
    float dt0 = tw * fv;
    float dt1w = 1.f / (1.f + tw);
    return (arg + dt0) * dt1w;
  }
  // abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
  float d = arg - fv;
  return arg - fminf(fmaxf(d, -tl), tl);
}

__device__ __forceinline__ float primal_at(float xv, float kty, float fv,
                                           float wv, float tau, float lmb,
                                           int dataterm) {
  const float tl = tau * lmb;
  return primal_at(xv, kty, fv, wv, tau, tl, 1.f / (1.f + tl), dataterm);
}

// The dual step at one pixel (_rof_update, second half): q <- proj_{|.|<=r}
// (q + sig_p grad x_new - sig_t grad x), (gxn, gyn) = grad x_new and
// (gx, gy) the carried grad x.
__device__ __forceinline__ void dual_at(float qx, float qy, float gxn,
                                        float gyn, float gx, float gy,
                                        float sig_p, float sig_t,
                                        float radius, float& qxn,
                                        float& qyn) {
  float ax = (qx + sig_p * gxn) - sig_t * gx;
  float ay = (qy + sig_p * gyn) - sig_t * gy;
  float nn = ax * ax + ay * ay;
  float scale = nn > 0.f ? fminf(1.f, radius * rsqrtf(nn)) : 1.f;
  qxn = ax * scale;
  qyn = ay * scale;
}

// The residual terms of the aligned iteration at one pixel (_chunk_core):
// w_hat from x before (xp) and after (x) it and K^T of the dual before it;
// |pd|^2 and |z_hat|^2 from the dual before (qp) and after (q) it and the
// gradient after (g) and before (gp) it; dd from w_hat and K^T of the new
// dual.
__device__ __forceinline__ float w_hat(float xp, float x, float ktyp,
                                       float inv_t) {
  return (xp - x) * inv_t - SQRT_T * ktyp;
}

__device__ __forceinline__ void dual_terms(float qpx, float qpy, float qx,
                                           float qy, float gx, float gy,
                                           float gpx, float gpy, float inv_s,
                                           float theta, float& pd2,
                                           float& zh2) {
  float zx = (qpx - qx) * inv_s + SQRT_S * ((1.f + theta) * gx - theta * gpx);
  float zy = (qpy - qy) * inv_s + SQRT_S * ((1.f + theta) * gy - theta * gpy);
  float pdx = zx - SQRT_S * gx;
  float pdy = zy - SQRT_S * gy;
  pd2 = pdx * pdx + pdy * pdy;
  zh2 = zx * zx + zy * zy;
}

// Primal step (_rof_update, first half): x <- prox_g(x - tau/4 K^T q).
// Bound: memory, 4 planes read (x, q_x, q_y, f; +w for wsquare), 1
// written (2 on the aligned iteration, which also saves x_prev).  The
// q neighbours one row up are reread by the next warp row, so they come
// from L1/L2, not device memory.
__global__ void rof_primal(Planes b, int dataterm, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j, nx = b.nx, ny = b.ny;
  if (!pixel(nx, ny, i, j)) return;
  const float* __restrict__ sc = b.sc;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  float tau = sc[S_TAU] * 0.25f;  // tau * Tau
  float kty = kty_at(b.q, row_ctx(sc, nx, b.nxg), i, j, ny, n);
  float xv = b.x[p];
  float wv = dataterm == DT_WSQUARE ? b.w[p] : 0.f;
  float xn = primal_at(xv, kty, b.f[p], wv, tau, sc[S_LMB], dataterm);
  if (save_prev) b.xp[p] = xv;
  b.x[p] = xn;
}

// Dual step (_rof_update, second half), grad x_new carried into g.
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
  if (save_prev) {
    b.qp[p] = qx;
    b.qp[n + p] = qy;
    b.gp[p] = gx;
    b.gp[n + p] = gy;
  }
  dual_at(qx, qy, gxn, gyn, gx, gy, sig_p, sig_t, sc[S_RADIUS], q[p],
          q[n + p]);
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
    float inv_s = 1.f / (b.sc[S_SIGMA] * SQRT_S);
    float inv_t = 1.f / (b.sc[S_TAU] * SQRT_T);
    float wh = w_hat(b.xp[p], b.x[p], kty_at(b.qp, r, i, j, ny, n), inv_t);
    float dd = wh + SQRT_T * kty_at(b.q, r, i, j, ny, n);
    dual_terms(b.qp[p], b.qp[n + p], b.q[p], b.q[n + p], b.g[p], b.g[n + p],
               b.gp[p], b.gp[n + p], inv_s, b.sc[S_THETA], v[0], v[1]);
    v[2] = dd * dd;
    v[3] = wh * wh;
  }
  block_partials(v, b.partial);
}

// ---------------------------------------------------------------------------
// The batched chunk with each instance held on chip by a thread-block
// cluster (rof_fused_chunk_batched -> _rof_chunk_kernel_batched, whose TPU
// kernel keeps an instance in VMEM for the whole chunk, grid = (B,)).
//
// What bounds it.  A chunk of B instances reads x, q and f (and w) once and
// writes x2, q2, x_prev and q_prev once: 10 planes per instance, bound by
// bytes.  The streaming launch sequence above moves the whole working set
// through device memory on every half-iteration (2 ri + 3 launches), about
// twenty times the bound at B = 1024 of 128x128.
//
// Design.  One cluster launch per chunk: instance z is the cluster at
// blockIdx.y, and its C CTAs (blockIdx.x, the cluster rank) own bands of
// `rows` rows (a multiple of 8, so that every 32x8 norm tile lies in one
// band; the last band may be shorter or empty).  Each CTA loads its band's
// x, q_x, q_y and f (and w) into dynamic shared memory, seeds the carried
// gradient g there, runs all `count` iterations on it and writes the
// outputs once: g never leaves the chip.  The stencils reach one row into
// a neighbour band, q_x's row above in the primal step and x's row below
// in the dual step (and q_x's row above in the last norm pass).  Each band
// keeps those two rows beside its planes (its slack rows): the warp that
// takes a band's edge tile copies them from the neighbour CTA's shared
// memory (DSMEM, map_shared_rank) into its own, and the same lanes read
// them, so every stencil reads plain shared memory.  Each half-step writes
// one set of planes and reads the other's neighbours, so one cluster
// barrier after each half-step orders every remote read before the
// neighbour's next write of that plane.  A last barrier keeps every CTA
// resident until its neighbours have read it.  C, the smallest of 1, 2, 4
// and 8 whose band and slack rows fit, comes from ops/fused_rof.py
// cluster_size; a shape that no cluster of 8 holds takes the batched tiled
// launch (prost_rof_chunk_batched_tiled), chosen by the wrapper before the
// launch.
//
// The per-pixel arithmetic is that of rof_primal, rof_dual and
// rof_norm_partial (the same device functions), and the norm partials are
// block_partials' tree over the same 32x8 tiles (rows paired as the shared
// tree pairs them, then lanes by shuffles), reduced by the same
// pdhg_finish: every instance is bit-equal to rof_chunk on it alone.
// Warps walk the band's 32x8 tiles, a lane one column of a tile; threads
// outside the plane still reach every barrier.
// ---------------------------------------------------------------------------

constexpr int CL_THREADS = 1024;  // threads of a cluster CTA: 32 warps an SM
constexpr int CL_WARPS = CL_THREADS / BX;
constexpr int CLUSTER_MAX = 8;  // the portable cluster size
// dynamic shared memory one block can opt into on Hopper (227 KB)
constexpr int SMEM_MAX = 232448;

struct Cluster {
  const float *x, *q, *f, *w;  // (B, nx, ny) and (B, 2, nx, ny) inputs
  float *x2, *q2, *xp, *qp;    // outputs
  float* sc;
  float* partial;  // 4 per 32x8 tile per instance
  int nx, ny, rows, count;
};

// Planes a band holds in shared memory: x, q_x, q_y, g_x, g_y, f, and w
// for wsquare (ops/fused_rof.py cluster_planes).
inline int cluster_planes(int dataterm) {
  return dataterm == DT_WSQUARE ? 7 : 6;
}

// Band rows of a CTA of a cluster of `csize` (ops/fused_rof.py
// cluster_band_rows): ceil(nx / csize) rounded up to the 32x8 tiles.
inline int cluster_band_rows(int nx, int csize) {
  int r = (nx + csize - 1) / csize;
  return (r + BY - 1) / BY * BY;
}

// The band's planes and its two slack rows (q_x's row above, x's row
// below), in bytes (ops/fused_rof.py cluster_size).
inline size_t cluster_smem(int nx, int ny, int dataterm, int csize) {
  return ((size_t)cluster_planes(dataterm) * cluster_band_rows(nx, csize) +
          2) * ny * sizeof(float);
}

// block_partials' tree of one 32x8 tile: a lane holds its column's 8 rows,
// paired as the shared-memory tree pairs the tile's warp rows (s = 128, 64,
// 32), then the lanes fold as it folds them (s = 16 .. 1).  Lane 0 ends
// with the tile's sum.
__device__ __forceinline__ float tile_sum(const float (&v)[BY]) {
  float s = ((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]));
  for (int o = BX / 2; o > 0; o >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

template <int DT>
__global__ void __launch_bounds__(CL_THREADS, 1)
    rof_chunk_cluster(Cluster a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float smem[];
  const int nx = a.nx, ny = a.ny, R = a.rows;
  const int rank = (int)cl.block_rank();
  const size_t z = blockIdx.y, n = (size_t)nx * ny;
  const float* __restrict__ sc = a.sc + z * S_LEN;
  const int r0 = rank * R, rows = max(min(R, nx - r0), 0);
  const size_t band = (size_t)rows * ny;
  const size_t o1 = z * n + (size_t)r0 * ny;           // band in x-like
  const size_t o2 = 2 * z * n + (size_t)r0 * ny;       // band in q's q_x

  if (sc[S_CONV] != 0.f) {  // converged: the inputs are the outputs
    for (size_t k = threadIdx.x; k < band; k += CL_THREADS) {
      float xv = a.x[o1 + k], qx = a.q[o2 + k], qy = a.q[o2 + n + k];
      a.x2[o1 + k] = xv;
      a.xp[o1 + k] = xv;
      a.q2[o2 + k] = qx;
      a.qp[o2 + k] = qx;
      a.q2[o2 + n + k] = qy;
      a.qp[o2 + n + k] = qy;
    }
    return;  // every CTA of the cluster returns here: no DSMEM was read
  }

  // q_x with its slack row above (row -1), x with its slack row below
  // (row R), then q_y, g_x, g_y, f and w
  const int P = R * ny;
  float* sqx = smem + ny;
  float* sx = sqx + P;
  float* sqy = sx + P + ny;
  float* sgx = sqy + P;
  float* sgy = sgx + P;
  float* sf = sgy + P;
  float* sw = sf + P;  // wsquare only

  // load the band; the seed (rof_seed): g = grad x, from the inputs, and
  // the dead dual coordinates zeroed
  const float* xin = a.x + z * n;
  for (int k = threadIdx.x; k < (int)band; k += CL_THREADS) {
    int i = r0 + k / ny, j = k % ny;
    size_t p = (size_t)i * ny + j;
    float xv = xin[p];
    sx[k] = xv;
    sgx[k] = i < nx - 1 ? xin[p + ny] - xv : 0.f;
    sgy[k] = j < ny - 1 ? xin[p + 1] - xv : 0.f;
    sqx[k] = i == nx - 1 ? 0.f : a.q[o2 + k];
    sqy[k] = j == ny - 1 ? 0.f : a.q[o2 + n + k];
    sf[k] = a.f[o1 + k];
    if (DT == DT_WSQUARE) sw[k] = a.w[o1 + k];
  }

  // the neighbours' rows that fill the slack rows: q_x's last row of the
  // band above (its row R - 1: only the last band is short), where this
  // band has a global row above it; x's row 0 of the band below, where a
  // global row follows this (full) band
  const bool has_up = rank > 0 && rows > 0;
  const bool has_dn = r0 + R < nx;
  const float* up_qx =
      has_up ? cl.map_shared_rank(sqx, rank - 1) + (R - 1) * ny : sqx;
  const float* dn_x = has_dn ? cl.map_shared_rank(sx, rank + 1) : sx;

  const float tau_raw = sc[S_TAU], sigma_raw = sc[S_SIGMA];
  const float theta = sc[S_THETA], lmb = sc[S_LMB], radius = sc[S_RADIUS];
  const float tau = tau_raw * 0.25f;      // tau * Tau
  const float sigma_p = sigma_raw * 0.5f;  // sigma * Sigma
  const float sig_p = sigma_p * (1.f + theta);
  const float sig_t = sigma_p * theta;
  const float inv_s = 1.f / (sigma_raw * SQRT_S);
  const float inv_t = 1.f / (tau_raw * SQRT_T);

  const int ntx = (ny + BX - 1) / BX;
  const int ntiles = (rows + BY - 1) / BY * ntx;
  const int warp = threadIdx.x / BX, lane = threadIdx.x % BX;
  // this instance's partials; the band's first tile row is r0 / 8
  float* partial = a.partial + z * 4 * (size_t)((nx + BY - 1) / BY * ntx) +
                   (size_t)4 * (r0 / BY) * ntx;

  // K^T q at local pixel lp of local row li (kty_at), q_x's row above the
  // band from the slack row
  auto kty = [&](int li, int j, int lp) {
    float lx = r0 + li > 0 ? sqx[lp - ny] : 0.f;
    float ly = j > 0 ? sqy[lp - 1] : 0.f;
    return (lx - sqx[lp]) + (ly - sqy[lp]);
  };

  cl.sync();  // every band loaded and seeded
  for (int it = 0; it < a.count; ++it) {
    const bool last = it == a.count - 1;
    // primal step; on the aligned iteration x_prev out, w_hat into f's
    // slot (f is not read again) and its tile sums
    for (int t = warp; t < ntiles; t += CL_WARPS) {
      const int ty = t / ntx, j = (t % ntx) * BX + lane;
      if (ty == 0 && has_up && j < ny) sqx[j - ny] = up_qx[j];
      float v3[BY];
#pragma unroll
      for (int rr = 0; rr < BY; ++rr) {
        const int li = ty * BY + rr, lp = li * ny + j;
        v3[rr] = 0.f;
        if (li >= rows || j >= ny) continue;
        const float k = kty(li, j, lp);
        const float xv = sx[lp];
        const float xn = primal_at(xv, k, sf[lp],
                                   DT == DT_WSQUARE ? sw[lp] : 0.f, tau,
                                   lmb, DT);
        if (last) {
          a.xp[o1 + lp] = xv;
          const float wh = w_hat(xv, xn, k, inv_t);
          sf[lp] = wh;
          v3[rr] = wh * wh;
        }
        sx[lp] = xn;
      }
      if (last) {
        const float s3 = tile_sum(v3);
        if (lane == 0) partial[4 * t + 3] = s3;
      }
    }
    cl.sync();  // new x everywhere; the q reads above are done
    // dual step; on the aligned iteration q_prev out and the tile sums of
    // |pd|^2 and |z_hat|^2
    for (int t = warp; t < ntiles; t += CL_WARPS) {
      const int ty = t / ntx, j = (t % ntx) * BX + lane;
      if (ty == R / BY - 1 && has_dn && j < ny) sx[P + j] = dn_x[j];
      float v0[BY], v1[BY];
#pragma unroll
      for (int rr = 0; rr < BY; ++rr) {
        const int li = ty * BY + rr, i = r0 + li, lp = li * ny + j;
        v0[rr] = v1[rr] = 0.f;
        if (li >= rows || j >= ny) continue;
        const float xv = sx[lp];
        const float gxn = i < nx - 1 ? sx[lp + ny] - xv : 0.f;
        const float gyn = j < ny - 1 ? sx[lp + 1] - xv : 0.f;
        const float qx = sqx[lp], qy = sqy[lp];
        const float gx = sgx[lp], gy = sgy[lp];
        float qxn, qyn;
        dual_at(qx, qy, gxn, gyn, gx, gy, sig_p, sig_t, radius, qxn, qyn);
        if (last) {
          a.qp[o2 + lp] = qx;
          a.qp[o2 + n + lp] = qy;
          dual_terms(qx, qy, qxn, qyn, gxn, gyn, gx, gy, inv_s, theta,
                     v0[rr], v1[rr]);
        }
        sqx[lp] = qxn;
        sqy[lp] = qyn;
        sgx[lp] = gxn;
        sgy[lp] = gyn;
      }
      if (last) {
        const float s0 = tile_sum(v0), s1 = tile_sum(v1);
        if (lane == 0) {
          partial[4 * t + 0] = s0;
          partial[4 * t + 1] = s1;
        }
      }
    }
    cl.sync();  // new q everywhere; the x reads above are done
  }
  // the outputs, and the tile sums of dd^2 (K^T of the new dual)
  for (int t = warp; t < ntiles; t += CL_WARPS) {
    const int ty = t / ntx, j = (t % ntx) * BX + lane;
    if (ty == 0 && has_up && j < ny) sqx[j - ny] = up_qx[j];
    float v2[BY];
#pragma unroll
    for (int rr = 0; rr < BY; ++rr) {
      const int li = ty * BY + rr, lp = li * ny + j;
      v2[rr] = 0.f;
      if (li >= rows || j >= ny) continue;
      const float dd = sf[lp] + SQRT_T * kty(li, j, lp);
      v2[rr] = dd * dd;
      a.x2[o1 + lp] = sx[lp];
      a.q2[o2 + lp] = sqx[lp];
      a.q2[o2 + n + lp] = sqy[lp];
    }
    const float s2 = tile_sum(v2);
    if (lane == 0) partial[4 * t + 2] = s2;
  }
  cl.sync();  // no CTA leaves while a neighbour still reads its planes
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

// ---------------------------------------------------------------------------
// The grid-resident chunk and multichunk (rof_fused_chunk ->
// _rof_chunk_kernel, rof_fused_multichunk -> _rof_multichunk_kernel, whose
// TPU kernels hold the plane in VMEM for the whole launch): one
// cooperative launch runs what chunk() runs in 2 count + 3 launches
// (rof_resident) and what prost_rof_multichunk runs in 1 + k_chunks
// (2 count + 2) launches (rof_multichunk_resident: 177 at config 1's 8
// chunks of ri 10).
//
// What bounds it.  At 512x512 a chunk reads x, q and f (and w) once and
// writes x, q, x_prev and q_prev once, 10 planes (3.1 us at the card's
// memory rate); its iterations' operations take about 0.01 ms at the FP32
// peak.  The streaming sequence pays about 2.8 us a launch for each of its
// 23 (177) launches.  Here an iteration costs one grid barrier, the copy
// of three neighbour rows after it, and the pixels of a band: 4 rows of
// 512 at 512x512 over 132 SMs.
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// [lo, hi) = band_of(nx, b, G) and holds them in shared memory (RofRes)
// from the load to the store, with the neighbour rows its stencils reach:
// x, q_y and f (and w) with the row below (row hi), q_x with the row above
// and the row below, and the band's rows of the carried gradient g_x, g_y.
// One grid barrier an iteration: each band takes the primal step of its
// own rows and of row hi too (the first row of the band below, from the
// same values with the same expressions, so the same bits), so that its
// dual step reads grad x_new without an exchange of x.  The dual step
// publishes the rows its neighbours read next, q_x and q_y of row lo (for
// the band above, whose row hi it is) and q_x of row hi - 1 (for the band
// below), into exchange planes that alternate with the iteration's parity
// (a band may write iteration k + 1's rows while its neighbour still
// reads iteration k's: no barrier lies between them); after the grid
// barrier every block copies in those three rows.  The aligned primal step
// writes x_prev and keeps w_hat in f's rows (in a chunk f is not read
// again; row hi keeps f); the aligned dual step writes q_prev and the
// terms of |pd|^2 and |z_hat|^2 (the previous gradient is still in
// registers); after the last exchange K^T q of the new dual completes
// |dd|^2 and |w_hat|^2, and the band is stored once.  The per-pixel
// expressions are rof_seed's, rof_primal's, rof_dual's and
// rof_norm_partial's (the same device functions, in the same order), and
// the norms reduce through the same tiles and finish (coop_tile_partials,
// finish_block): the planes and the norms are bit-equal to the streaming
// sequence.  The body takes the row context (RowCtx) for every row mask,
// dead row and owned row of the norms, so a halo band runs it too
// (prost_rof_chunk_halo_resident: config 1's one-shard band of 556 rows
// holds bands of 5 rows, 71680 bytes a block).
// Barriers: one after the load, one an iteration, two around the tiles.
// The multichunk loads and seeds once, then for each chunk reads the
// scalars anew through a volatile pointer (the last finish adapted them),
// runs `count` iterations, the norms and finish_block's adaptation and
// stopping test in block 0, and after a barrier reads the flag, on which
// the whole grid leaves together; w_hat takes a window of its own (f is
// read again in the next chunk, with the new tau), which the tiles and the
// finish borrow as their reduction array; x_prev and q_prev are written on
// every chunk's aligned iteration and the band stored once after the last
// chunk.
// ---------------------------------------------------------------------------

constexpr int RES_RED = RES_RED_BYTES / (int)sizeof(float);

struct RofRes {
  LWin x, qx, qy, gx, gy, f;
  LWin w;   // wsquare's weights (f again for the other data terms)
  LWin wh;  // w_hat of the aligned primal step: f's rows in a chunk, a
            // window of its own in a multichunk
  float* red;  // RES_RED floats for the tiles and the finish: the start of
               // the windows in a chunk (stored by then), w_hat's window in
               // a multichunk (read by then, rewritten in the next chunk)
};

// Floats of RofRes for bands of at most rmax rows (with w where wsq; with
// `multi`, w_hat's window, at least the reductions' array), mirrored by
// ops/fused_rof.py resident_bytes: x, q_y and f (and w) rmax + 1 rows, q_x
// rmax + 2, g_x and g_y rmax.
__host__ __device__ __forceinline__ size_t rof_resident_floats(int rmax,
                                                               int ny,
                                                               int wsq,
                                                               int multi) {
  size_t floats = ((size_t)(6 + (wsq ? 1 : 0)) * (rmax + 1) - 1) * ny;
  if (multi) {
    size_t wh = (size_t)rmax * ny;
    floats += wh > (size_t)RES_RED ? wh : (size_t)RES_RED;
  }
  return floats;
}

__device__ __forceinline__ RofRes rof_layout(float* smem, int lo, int rmax,
                                             int ny, bool wsq, bool multi) {
  RofRes v;
  float* p = smem;
  v.x = take(p, 1, lo, rmax + 1, ny);
  v.qx = take(p, 1, lo - 1, rmax + 2, ny);
  v.qy = take(p, 1, lo, rmax + 1, ny);
  v.gx = take(p, 1, lo, rmax, ny);
  v.gy = take(p, 1, lo, rmax, ny);
  v.f = take(p, 1, lo, rmax + 1, ny);
  v.w = wsq ? take(p, 1, lo, rmax + 1, ny) : v.f;
  v.wh = multi ? take(p, 1, lo, rmax, ny) : v.f;
  v.red = multi ? v.wh.a : smem;
  return v;
}

// The launch's scalars and the constants the pixel loops share, each the
// same expression of them as in the streaming kernels; read through a
// volatile pointer, since a multichunk's finish in block 0 changes them
// between chunks.
struct RofStep {
  float theta, lmb, radius, tau, sig_p, sig_t, inv_s, inv_t;
};

__device__ __forceinline__ RofStep rof_step(const float* sc) {
  const volatile float* s = sc;
  RofStep k;
  const float tau_raw = s[S_TAU], sigma_raw = s[S_SIGMA];
  k.theta = s[S_THETA];
  k.lmb = s[S_LMB];
  k.radius = s[S_RADIUS];
  k.tau = tau_raw * 0.25f;                 // tau * Tau
  const float sigma_p = sigma_raw * 0.5f;  // sigma * Sigma
  k.sig_p = sigma_p * (1.f + k.theta);
  k.sig_t = sigma_p * k.theta;
  k.inv_s = 1.f / (sigma_raw * SQRT_S);
  k.inv_t = 1.f / (tau_raw * SQRT_T);
  return k;
}

// K^T q at (i, j) from the band's windows (kty_at).
__device__ __forceinline__ float kty_band(const RofRes& v, const RowCtx& r,
                                          int i, int j) {
  float lx = has_above(r, i) ? v.qx.at(0, i - 1, j) : 0.f;
  float ly = j > 0 ? v.qy.at(0, i, j - 1) : 0.f;
  return (lx - v.qx.at(0, i, j)) + (ly - v.qy.at(0, i, j));
}

// The rows of the primal step a band takes: its own and row hi, the first
// row of the band below, where the band has rows and the plane has row hi.
__device__ __forceinline__ int primal_end(int lo, int hi, int nx) {
  return lo < hi && hi < nx ? hi + 1 : hi;
}

// The band's rows of x, q (q_x also the row above), f and w, with row hi,
// into their windows, then rof_seed: the dead duals zeroed (also on the
// neighbour rows), grad x of the band's own rows; a grid barrier.
__device__ __forceinline__ void rof_res_load_seed(
    const Planes& b, const RofRes& v, const RowCtx& r, int lo, int hi,
    bool wsq, cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  load_rows(v.x, b.x, 1, lo, hi + 1, nx);
  load_rows(v.qx, b.q, 1, lo - 1, hi + 1, nx);
  load_rows(v.qy, b.q + (size_t)nx * ny, 1, lo, hi + 1, nx);
  load_rows(v.f, b.f, 1, lo, hi + 1, nx);
  if (wsq) load_rows(v.w, b.w, 1, lo, hi + 1, nx);
  __syncthreads();
  const int top = lo > 0 ? lo - 1 : lo, end = hi < nx ? hi + 1 : hi;
  for (int k = threadIdx.x, i = top + k / ny, j = k % ny; k < (end - top) * ny;
       k += RES_THREADS, next_pixel(i, j, ny)) {
    if (dead_row(r, i)) v.qx.at(0, i, j) = 0.f;
    if (i < lo) continue;
    if (j == ny - 1) v.qy.at(0, i, j) = 0.f;
    if (i == hi) continue;
    const float xv = v.x.at(0, i, j);
    v.gx.at(0, i, j) = has_below(r, i, nx) ? v.x.at(0, i + 1, j) - xv : 0.f;
    v.gy.at(0, i, j) = j < ny - 1 ? v.x.at(0, i, j + 1) - xv : 0.f;
  }
  grid.sync();
}

// One iteration on the band: rof_primal on its rows and row hi, rof_dual
// on its rows, the rows its neighbours read published in the exchange
// planes of the iteration's `parity`, a grid barrier, and the three rows it
// reads copied in.  The aligned (`last`) iteration also writes x_prev,
// q_prev, w_hat and the |pd|^2 and |z_hat|^2 terms.
template <int DT>
__device__ __forceinline__ void rof_res_iteration(
    const Planes& b, const RofRes& v, const RowCtx& r, const RofStep& k,
    int lo, int hi, bool last, int parity,
    cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny;
  // rof_primal
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny;
       t < (primal_end(lo, hi, nx) - lo) * ny;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const float kty = kty_band(v, r, i, j);
    const float xv = v.x.at(0, i, j);
    const float xn = primal_at(xv, kty, v.f.at(0, i, j),
                               DT == DT_WSQUARE ? v.w.at(0, i, j) : 0.f,
                               k.tau, k.lmb, DT);
    if (last && i < hi) {
      b.xp[(size_t)i * ny + j] = xv;
      v.wh.at(0, i, j) = w_hat(xv, xn, kty, k.inv_t);
    }
    v.x.at(0, i, j) = xn;
  }
  __syncthreads();
  // rof_dual
  float* xq = b.terms + (size_t)(4 + 2 * parity) * n;  // q_x, q_y rows
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < (hi - lo) * ny;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    const float xv = v.x.at(0, i, j);
    const float gxn = has_below(r, i, nx) ? v.x.at(0, i + 1, j) - xv : 0.f;
    const float gyn = j < ny - 1 ? v.x.at(0, i, j + 1) - xv : 0.f;
    const float qx = v.qx.at(0, i, j), qy = v.qy.at(0, i, j);
    const float gx = v.gx.at(0, i, j), gy = v.gy.at(0, i, j);
    float qxn, qyn;
    dual_at(qx, qy, gxn, gyn, gx, gy, k.sig_p, k.sig_t, k.radius, qxn, qyn);
    if (last) {  // rof_norm_partial's |pd|^2 and |z_hat|^2 terms
      b.qp[p] = qx;
      b.qp[n + p] = qy;
      float pd2 = 0.f, zh2 = 0.f;
      if (owned_row(r, i))
        dual_terms(qx, qy, qxn, qyn, gxn, gyn, gx, gy, k.inv_s, k.theta, pd2,
                   zh2);
      b.terms[p] = pd2;
      b.terms[n + p] = zh2;
    }
    v.qx.at(0, i, j) = qxn;
    v.qy.at(0, i, j) = qyn;
    v.gx.at(0, i, j) = gxn;
    v.gy.at(0, i, j) = gyn;
    if (i == lo || i == hi - 1) xq[p] = qxn;
    if (i == lo) xq[n + p] = qyn;
  }
  grid.sync();
  load_rows(v.qx, xq, 1, lo - 1, lo, nx);
  if (lo < hi) {
    load_rows(v.qx, xq, 1, hi, hi + 1, nx);
    load_rows(v.qy, xq + n, 1, hi, hi + 1, nx);
  }
  __syncthreads();
}

// After the aligned iteration: the |dd|^2 and |w_hat|^2 terms from K^T q of
// the new dual (rof_norm_partial).
__device__ __forceinline__ void rof_res_terms(const Planes& b,
                                              const RofRes& v,
                                              const RowCtx& r, int lo,
                                              int hi) {
  const int ny = b.ny;
  const size_t n = (size_t)b.nx * ny;
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < (hi - lo) * ny;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    float dd2 = 0.f, wh2 = 0.f;
    if (owned_row(r, i)) {
      const float wh = v.wh.at(0, i, j);
      const float dd = wh + SQRT_T * kty_band(v, r, i, j);
      dd2 = dd * dd;
      wh2 = wh * wh;
    }
    b.terms[2 * n + p] = dd2;
    b.terms[3 * n + p] = wh2;
  }
}

// The band's x and q into device memory.
__device__ __forceinline__ void rof_res_store(const Planes& b,
                                              const RofRes& v, int lo,
                                              int hi) {
  const int ny = b.ny;
  const size_t n = (size_t)b.nx * ny;
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < (hi - lo) * ny;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    b.x[p] = v.x.at(0, i, j);
    b.q[p] = v.qx.at(0, i, j);
    b.q[n + p] = v.qy.at(0, i, j);
  }
}

// The 32x8 tiles' partials of the four terms between two grid barriers,
// so that block 0 may run the finish.
__device__ __forceinline__ void rof_res_tiles(
    const Planes& b, const RofRes& v, cooperative_groups::grid_group& grid) {
  grid.sync();
  coop_tile_partials(b.terms, b.nx, b.ny, b.partial, v.red);
  grid.sync();
}

// The chunk (rof_fused_chunk) grid-resident: load, seed, `count`
// iterations, the norms' terms, the band stored, the tiles and the finish
// in block 0.  Bit-equal to chunk() on one instance.
template <int DT>
__global__ void __launch_bounds__(RES_THREADS, 1)
    rof_resident(Planes b, int count, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const RofRes v = rof_layout(smem, lo, rmax, b.ny, DT == DT_WSQUARE, false);
  rof_res_load_seed(b, v, r, lo, hi, DT == DT_WSQUARE, grid);
  const RofStep k = rof_step(b.sc);
  for (int it = 0; it < count; ++it)
    rof_res_iteration<DT>(b, v, r, k, lo, hi, it == count - 1, it & 1,
                          grid);
  rof_res_terms(b, v, r, lo, hi);
  rof_res_store(b, v, lo, hi);  // before the tiles reuse the windows
  rof_res_tiles(b, v, grid);
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    dim3 g = grid_of(b.nx, b.ny);
    finish_block(reinterpret_cast<float(*)[FIN]>(v.red), b.sc, b.partial,
                 (int)(g.x * g.y), count, 0, STEP_NONE, none);
  }
}

// The multichunk (rof_fused_multichunk) grid-resident: load and seed once,
// then up to k_chunks chunks, each `count` iterations, the norms' terms and
// tiles and, in block 0, finish_block's adaptation and stopping test;
// after a grid barrier every block reads the new scalars and the flag, and
// the grid leaves together once it is set; the band stored at the end.
// Bit-equal to prost_rof_multichunk.
template <int DT>
__global__ void __launch_bounds__(RES_THREADS, 1)
    rof_multichunk_resident(Planes b, int count, int k_chunks, int stepsize,
                            AdaptConsts c, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const RofRes v = rof_layout(smem, lo, rmax, b.ny, DT == DT_WSQUARE, true);
  const dim3 g = grid_of(b.nx, b.ny);
  rof_res_load_seed(b, v, r, lo, hi, DT == DT_WSQUARE, grid);
  for (int ch = 0; ch < k_chunks; ++ch) {
    const RofStep k = rof_step(b.sc);  // as the last finish left them
    for (int it = 0; it < count; ++it)
      rof_res_iteration<DT>(b, v, r, k, lo, hi, it == count - 1,
                            (ch * count + it) & 1, grid);
    rof_res_terms(b, v, r, lo, hi);
    rof_res_tiles(b, v, grid);
    if (blockIdx.x == 0)
      finish_block(reinterpret_cast<float(*)[FIN]>(v.red), b.sc, b.partial,
                   (int)(g.x * g.y), count, 1, stepsize, c);
    grid.sync();
    if (*(volatile float*)&b.sc[S_CONV] != 0.f) break;
  }
  rof_res_store(b, v, lo, hi);
}

using RofResKernel = void (*)(Planes, int, int);
using RofResMultiKernel = void (*)(Planes, int, int, int, AdaptConsts, int);

RofResKernel rof_resident_kernel(int dataterm) {
  return dataterm == DT_SQUARE    ? rof_resident<DT_SQUARE>
         : dataterm == DT_WSQUARE ? rof_resident<DT_WSQUARE>
                                  : rof_resident<DT_ABS>;
}

RofResMultiKernel rof_multichunk_resident_kernel(int dataterm) {
  return dataterm == DT_SQUARE    ? rof_multichunk_resident<DT_SQUARE>
         : dataterm == DT_WSQUARE ? rof_multichunk_resident<DT_WSQUARE>
                                  : rof_multichunk_resident<DT_ABS>;
}

// The dynamic shared memory a block of the resident chunk (with `multi`,
// multichunk) may hold on the current device: the smallest of its three
// data terms' kernels' limits, or minus the error.
int rof_resident_limit(int multi) {
  int limit = -1;
  for (int dt = 0; dt < 3; ++dt) {
    int l = multi ? resident_smem_limit(rof_multichunk_resident_kernel(dt))
                  : resident_smem_limit(rof_resident_kernel(dt));
    if (l < 0) return l;
    limit = limit < 0 || l < limit ? l : limit;
  }
  return limit;
}

// The dynamic shared memory of a resident launch on planes of nx rows:
// RofRes for the largest band (rmax rows), at least the reductions' array;
// or 0 where a block may not hold it on the current device (then `rc`
// holds the error).
size_t resident_smem(int nx, int ny, int dataterm, int multi, int& rmax,
                     int& rc) {
  int sms = 0;
  rc = device_sms(&sms);
  if (rc) return 0;
  rmax = band_rows(nx, sms);
  size_t smem = rof_resident_floats(rmax, ny, dataterm == DT_WSQUARE,
                                    multi) * sizeof(float);
  if (smem < (size_t)RES_RED_BYTES) smem = RES_RED_BYTES;
  int limit = rof_resident_limit(multi);
  if (limit < 0) {
    rc = -limit;
    return 0;
  }
  if (smem > (size_t)limit) {
    rc = (int)cudaErrorInvalidValue;
    return 0;
  }
  return smem;
}

// One resident chunk of `b` (the whole plane, or a halo band where b.nxg
// is set).
int resident_chunk(Planes b, int count, int dataterm, cudaStream_t st) {
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(b.nx, b.ny, dataterm, 0, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &rmax};
  return resident_launch(rof_resident_kernel(dataterm), args, smem, st);
}

// The launch configuration of a chunk of `batch` instances in clusters of
// `csize` CTAs, or the error that refuses it: a cluster size other than 1,
// 2, 4 or 8, a band beyond the shared memory of a block, or a cluster that
// the card cannot hold (cudaOccupancyMaxActiveClusters).
using ClusterKernel = void (*)(Cluster);

ClusterKernel cluster_kernel(int dataterm) {
  return dataterm == DT_SQUARE    ? rof_chunk_cluster<DT_SQUARE>
         : dataterm == DT_WSQUARE ? rof_chunk_cluster<DT_WSQUARE>
                                  : rof_chunk_cluster<DT_ABS>;
}

int cluster_config(int nx, int ny, int dataterm, int csize, int batch,
                   cudaStream_t s, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute& attr, int* clusters) {
  if (csize < 1 || csize > CLUSTER_MAX || (csize & (csize - 1)))
    return (int)cudaErrorInvalidClusterSize;
  size_t smem = cluster_smem(nx, ny, dataterm, csize);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel(dataterm), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(csize, batch);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, cluster_kernel(dataterm),
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters < 1 ? (int)cudaErrorLaunchOutOfResources : 0;
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
  b.terms = nullptr;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  return b;
}


// ---------------------------------------------------------------------------
// The tiled chunk and multichunk (rof_fused_chunk_banded -> _rof_banded_kernel,
// _rof_banded_db_kernel; rof_fused_multichunk_banded -> _rof_banded_mc_kernel),
// for planes whose rows no grid-resident band holds: 2048x1536, 2048x2048
// and the 2092-row halo band of a 2048-wide plane.  The TPU kernels run one
// launch a chunk with the grid over row bands, each band DMAing its
// halo-extended window into VMEM, running every iteration there and
// writing back its owned rows only.
//
// What bounds it.  A chunk at 2048x2048 reads x, q and f (and w) once and
// writes x, q, x_prev and q_prev once: 10 planes of 16.8 MB, 0.050 ms at the
// card's memory rate; the streaming sequence moves about 14 planes an
// iteration through device memory (23 launches a chunk), a working set
// twice the 50 MB L2.  Rows cannot be the unit here: one 2048-wide row of
// the state is 40-48 KB, and a block has at most 227 KB of shared memory.
// Within a block the iterations are bound by instruction issue and shared
// memory, not by device memory (PERF.md: an iteration of a round of
// windows costs several times the window's loads).
//
// Design.  One launch a chunk over overlapping 2-D windows, a block each
// (TL_THREADS threads): block (bi, bj) owns the tile of rows [bi tx, bi tx
// + tx) and columns [bj ty, bj ty + ty) (tx a multiple of 8, ty of 32, so
// every 32x8 norm tile lies in one block) and loads its window, the tile
// with TL_LEAD = count + 1 rows and columns above and left of it and count
// below and right of it (clamped at the plane's edges), into dynamic
// shared memory by cp.async.  The halo is the least that keeps the owned
// pixels exact (tests/test_torch_tiled_rof.py holds the plain twin exact
// with it and not with one less on either side): the primal half-step
// reads q one row up and one column left, the dual half-step the new x
// one row down and one column right, so a window side that is not the
// plane's edge spoils one more pixel of x and q per iteration on each side
// (q_k and x_k are exact from k below a top edge, q_k to k and x_k to k - 1
// above a bottom edge), and the norms' K^T q of the new dual reads one row
// more above.  Each half-step computes only the pixels still exact, so the
// work shrinks from the window toward the tile.
// The thread map is fixed for the launch: the window is cut into blocks of
// 32 columns by TL_K rows, a warp each, and a thread holds one column of
// its warp's block (its strip) in every half-step, masked by the exact
// region, not walked over it.  So a thread meets its own pixels again in
// the next iteration, which lets it carry grad x in registers: the dual
// step of iteration k makes grad x_k at its pixels, and iteration k + 1's
// dual step reads it there as grad x_old, as the streaming sequence
// carries it in g (seeded from the loaded window, as rof_seed seeds g).
// The window then holds one x, updated in place by the primal step (which
// reads only its own pixel's x), q_x, q_y, f and wsquare's w: 4 planes (5
// with w).  Walking a strip downward, the primal step keeps the q_x of the
// row above and the dual step the x of the row below in registers from
// the row before.  A plane's rows lie the map's width apart, 32 CB floats
// (CB, the map's column blocks, a template parameter of rof_tiled), so
// that the offsets of a strip's rows are immediates: a row stride read at
// run time held 13 row offsets in registers across the iterations and
// spilled.  For the same reason the window's place, the row context, the
// scalars and the instance's output planes live in the head of the
// block's shared memory (TShared), and only the loops over a strip, whose
// carry lives in registers, are unrolled.  With the carry's 26 of a
// thread's 64 registers, little else may stay live across a strip: ptxas
// shows no spill for any rof_tiled<DT, CB>.  The aligned step rereads its
// scalars from the head at each pixel, and the planes lie a whole tile's
// window apart, a stride formed from the launch's parameters rather than
// from the window's own rows: neither is needed to keep ptxas from
// spilling, but together they measured 3-8% faster on an H100 at
// 2048x2048, on the halo band, in the multichunk and at B = 4 (PERF.md).
// A window none of whose stencils meets an edge (its sides inside the
// plane, and for a halo band inside the global plane's rows with the dead
// q_x row beyond it: 540 of 640 windows at 2048x2048) runs the stencils
// with no test; in the others each stencil tests one bit of its strip's
// edge mask (TStrip::edges), formed once a launch from the pixel's place
// in the plane (the row context RowCtx of a halo band included) and in
// the window (where the window ends inside the plane the neighbour is
// taken as 0, which only pixels outside the exact region read).  Every
// read of a stencil lies in the block's shared memory, so a neighbour
// beyond the window is read and then dropped by the test.
// The aligned iteration's primal step writes x_prev and q_prev of the
// owned pixels and parks their w_hat in x2, the chunk's output x, which
// the write-out reads back before it writes x there; its dual step puts
// |pd|^2 in f's place and |z_hat|^2 in the carry; then x and q go out,
// |dd|^2 and |w_hat|^2 are formed from K^T q of the new dual, and the
// four terms take the places of f, x, q_x and q_y in shared memory
// (owned rows and pixels tested by the strip's bit masks,
// TStrip::owned), whence each 32x8 tile of the owned pixels is summed in
// block_partials' tree (tile_sum) into the streaming grid's partials,
// which pdhg_finish reduces as before: the norms are the streaming
// sequence's bit for bit, as are the planes.
// Windows overlap, so a launch reads (x, q) and writes (x2, q2): a chunk
// is the tiled launch, pdhg_finish and a copy of (x2, q2) back into (x, q)
// unless the flag was set (rof_tiled_settle); a multichunk alternates the
// two pairs from chunk to chunk, with pdhg_finish's adaptation and
// stopping test between chunks on the device, and copies back only where
// it ran an odd number of chunks.  A launch made after convergence
// returns at once.
// The batched chunk (rof_fused_chunk_banded_batched, and row 4's
// rof_fused_chunk_batched for instances that no cluster of 8 holds) is the
// same launch with the instance on blockIdx.z: each block reads
// its instance's scalars, planes and norm partials, so instance b is the
// single-instance launch on instance b alone, bit for bit; one
// pdhg_finish block an instance, and the copy back gated by each
// instance's flag (rof_tiled_settle, z over the instances), so a flagged
// instance keeps x, q, x_prev and q_prev.  One launch of B instances runs
// B times the tiles in rounds of one block per SM, which the wrapper's tile
// rule counts (ops/fused_rof.py tiled_tile with its batch).
// ---------------------------------------------------------------------------

constexpr int TL_THREADS = 1024;  // a block: 32 warps
constexpr int TL_WARPS = TL_THREADS / BX;
constexpr int TL_K = 13;       // rows of a thread's strip
constexpr int TL_MAX_CB = 6;   // blocks of 32 columns of a window's map
constexpr int TL_HEAD = 40;    // floats of the block's TShared

struct Tiled {
  const float *x, *q;  // the chunk's input: (B, nx, ny), (B, 2, nx, ny)
  float *x2, *q2;      // its output, laid out as the input
  float *xp, *qp;      // x_prev, q_prev of the owned pixels
  const float *f, *w;
  float* sc;       // S_LEN an instance
  float* partial;  // 4 per 32x8 tile of the plane (grid_of) an instance
  int nx, ny;
  int nxg;    // rows of the global plane of a halo band; 0: the whole plane
  int count;  // iterations; the halo is count + 1 before, count after
  int tx, ty;  // the owned tile's rows (a multiple of 8) and columns (32)
};

// Planes of a window in shared memory: x, q_x, q_y, f and wsquare's w.
inline int tiled_planes(int dataterm) {
  return dataterm == DT_WSQUARE ? 5 : 4;
}

// The blocks of 32 columns of the map of a window `cols` wide.
__host__ __device__ constexpr int tiled_cb(int cols) {
  return (cols + BX - 1) / BX;
}

// The dynamic shared memory of a block of the tiled launch (mirrored by
// ops/fused_rof.py tiled_bytes): the block's TShared, then the window's
// planes, each of the tile's rows and 2 count + 1 more, 32 tiled_cb floats
// apart.
inline size_t tiled_smem(int tx, int ty, int count, int dataterm) {
  const int h = 2 * count + 1;
  return ((size_t)tiled_planes(dataterm) * (tx + h) * (BX * tiled_cb(ty + h))
          + TL_HEAD) * sizeof(float);
}

// Whether the thread map of a tx x ty tile's window (the halo of a
// `count`-iteration chunk) fits the block: at most TL_MAX_CB blocks of 32
// columns, and one warp for each block of 32 columns by TL_K rows
// (mirrored by ops/fused_rof.py tiled_map).
inline bool tiled_map_ok(int tx, int ty, int count) {
  const int h = 2 * count + 1, cb = tiled_cb(ty + h);
  return cb <= TL_MAX_CB && cb * ((tx + h + TL_K - 1) / TL_K) <= TL_WARPS;
}

// A window: rows [r0, r0 + wh) and columns [c0, c0 + ww) of the plane,
// whether each side is the plane's edge, the owned tile in window
// coordinates, and whether no stencil of its exact regions meets an edge
// of the plane or of the window (`inner`).
struct TWin {
  int r0, c0, wh, ww;
  bool top, bot, left, right, inner;
  int oi0, oi1, oj0, oj1;
};

__device__ __forceinline__ TWin tiled_window(const Tiled& a,
                                             const RowCtx& r) {
  TWin v;
  const int lead = a.count + 1, trail = a.count;
  const int R0 = blockIdx.y * a.tx, C0 = blockIdx.x * a.ty;
  const int R1 = min(R0 + a.tx, a.nx), C1 = min(C0 + a.ty, a.ny);
  v.r0 = max(R0 - lead, 0);
  v.c0 = max(C0 - lead, 0);
  const int r1 = min(R1 + trail, a.nx), c1 = min(C1 + trail, a.ny);
  v.wh = r1 - v.r0;
  v.ww = c1 - v.c0;
  v.top = v.r0 == 0;
  v.left = v.c0 == 0;
  v.bot = r1 == a.nx;
  v.right = c1 == a.ny;
  // rows r0 + 1 .. r1 - 1, which the exact regions keep to, all have a
  // row above in the plane and rows up to r1 - 2 one below, none is the
  // global last (dead q_x) row; columns likewise
  v.inner = !v.top && !v.bot && !v.left && !v.right && v.r0 + r.off >= 1 &&
            r1 + r.off <= r.nxg - 1;
  v.oi0 = R0 - v.r0;
  v.oi1 = R1 - v.r0;
  v.oj0 = C0 - v.c0;
  v.oj1 = C1 - v.c0;
  return v;
}

// What a block's threads share, in the head of its dynamic shared memory
// (so that no register holds it across the iterations): the window, the
// row context, the launch's scalars and the planes of its instance that
// the aligned iteration writes (x_prev, q_prev, and the chunk's x and q in
// the scratch).
struct TShared {
  TWin v;
  RowCtx r;
  RofStep k;
  float *xp, *qpx, *qpy, *x2, *q2x, *q2y;
};
static_assert(sizeof(TShared) <= TL_HEAD * sizeof(float),
              "TShared outgrows the head of the tiled launch's shared memory");

// The pixels of iteration k's x (q_k with `dual`) that are still exact:
// rows [lo, hi) and columns [clo, chi) of the window.
struct TRegion {
  int lo, hi, clo, chi;
};

__device__ __forceinline__ TRegion exact_region(const TWin& v, int k,
                                                bool dual) {
  const int trail = dual ? k : k - 1;
  return TRegion{v.top ? 0 : k, v.bot ? v.wh : v.wh - trail,
                 v.left ? 0 : k, v.right ? v.ww : v.ww - trail};
}

// A thread's strip of the map of CB column blocks: rows [wr, wr + TL_K)
// of window column wc.  The window's planes x, q_x, q_y, f and w lie m
// floats apart in the block's shared memory from TL_HEAD (so that a
// neighbour one row or column beyond a plane's pixels lies in the shared
// memory before or after it), their rows S = 32 CB floats apart; row k
// of the strip in plane P, column dc right of its own, is at(P, k, dc): a
// 32-bit offset from the strip's first pixel of x, o, and an immediate.
// Rows [k0, k1) of the strip lie in a region (none where its column does
// not).
enum { TP_X = 0, TP_QX = 1, TP_QY = 2, TP_F = 3, TP_W = 4 };

template <int CB>
struct TStrip {
  static constexpr int S = BX * CB;
  int o, m;

  __device__ __forceinline__ explicit TStrip(int m_) : m(m_) {
    o = TL_HEAD + wr() * S + wc();
  }
  __device__ __forceinline__ int wr() const {
    return (int)threadIdx.x / BX / CB * TL_K;
  }
  __device__ __forceinline__ int wc() const {
    return (int)threadIdx.x / BX % CB * BX + (int)threadIdx.x % BX;
  }
  __device__ __forceinline__ float& at(int plane, int k, int dc = 0) const {
    extern __shared__ float smem[];
    return smem[o + plane * m + k * S + dc];
  }
  __device__ __forceinline__ void rows(const TRegion& e, int& k0,
                                       int& k1) const {
    const int r = wr(), c = wc();
    k0 = max(e.lo - r, 0);
    k1 = min(e.hi - r, TL_K);
    if (c < e.clo || c >= e.chi) k1 = 0;
  }
  // The strip's rows in the owned tile, bit k for row k (none where its
  // column is not); with `terms` only those whose norm terms count (a halo
  // band's own rows, owned_row).  The aligned iteration tests these bits,
  // so that no bound of the tile or of the row context holds a register.
  __device__ __forceinline__ unsigned owned(const TShared& sh,
                                            bool terms) const {
    const TWin& v = sh.v;
    const int c = wc();
    if (c < v.oj0 || c >= v.oj1) return 0u;
    int lo = v.oi0, hi = v.oi1;
    if (terms) {
      lo = max(lo, sh.r.own_lo - v.r0);
      hi = min(hi, sh.r.own_hi - v.r0);
    }
    lo = max(lo - wr(), 0);
    hi = min(hi - wr(), TL_K);
    return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
  }
  // The offset of the strip's first pixel in its instance's planes.
  __device__ __forceinline__ size_t first(const TShared& sh, int ny) const {
    return (size_t)(sh.v.r0 + wr()) * ny + sh.v.c0 + wc();
  }
  // For a window whose stencils test their neighbours: which neighbours of
  // the strip's pixels lie in the plane and in the window, by the pixel's
  // place in the plane (a halo band's row context included): bit k, row k
  // has a row above (K^T q reads it); bit TL_K + k, a row below (grad x);
  // bit 2 TL_K, the strip's column has one to its left; bit 2 TL_K + 1,
  // one to its right.  The map is fixed for the launch, so these are
  // formed once, and a stencil tests one bit: no row or column index
  // holds a register across the iterations.
  __device__ __forceinline__ unsigned edges(const TShared& sh, int nx,
                                            int ny) const {
    const TWin& v = sh.v;
    const RowCtx r = sh.r;
    const int c = wc(), j = v.c0 + c;
    unsigned e = 0u;
#pragma unroll
    for (int k = 0; k < TL_K; ++k) {
      const int wi = wr() + k, i = v.r0 + wi;
      if (wi > 0 && has_above(r, i)) e |= 1u << k;
      if (wi < v.wh - 1 && has_below(r, i, nx)) e |= 1u << (TL_K + k);
    }
    if (c > 0 && j > 0) e |= 1u << (2 * TL_K);
    if (c < v.ww - 1 && j < ny - 1) e |= 1u << (2 * TL_K + 1);
    return e;
  }
};
static_assert(2 * TL_K + 2 <= 32, "a strip's edge bits outgrow a word");

// K^T q at row k of a strip from the q_x above it (`up`), as kty_at; with
// EDGE the neighbours above and left taken as 0 where the strip's edge
// bits `e` (TStrip::edges) say that the plane, or the window, has none.
template <bool EDGE, int CB>
__device__ __forceinline__ float kty_tile(const TStrip<CB>& t, unsigned e,
                                          float up, int k) {
  const float lx = !EDGE || (e >> k & 1u) ? up : 0.f;
  const float ly =
      !EDGE || (e >> (2 * TL_K) & 1u) ? t.at(TP_QY, k, -1) : 0.f;
  return (lx - t.at(TP_QX, k)) + (ly - t.at(TP_QY, k));
}

// grad x at row k of a strip from x there (`xc`) and below it (`xb`), as
// rof_dual computes it; with EDGE the neighbours below and right taken as
// 0 where the plane, or the window, has none.
template <bool EDGE, int CB>
__device__ __forceinline__ void grad_tile(const TStrip<CB>& t, unsigned e,
                                          float xc, float xb, int k,
                                          float& gx, float& gy) {
  gx = !EDGE || (e >> (TL_K + k) & 1u) ? xb - xc : 0.f;
  gy = !EDGE || (e >> (2 * TL_K + 1) & 1u) ? t.at(TP_X, k, 1) - xc : 0.f;
}

// grad x of the loaded window at the strip's pixels of iteration 1's dual
// region (rof_seed's g), into the carry.
template <bool EDGE, int CB>
__device__ __forceinline__ void seed_strip(const TShared& sh,
                                           const TStrip<CB>& t, unsigned e,
                                           float (&gx)[TL_K],
                                           float (&gy)[TL_K]) {
  int k0, k1;
  t.rows(exact_region(sh.v, 1, true), k0, k1);
  if (k0 >= k1) return;
#pragma unroll
  for (int k = 0; k < TL_K; ++k) {
    if (k < k0 || k >= k1) continue;
    grad_tile<EDGE>(t, e, t.at(TP_X, k), t.at(TP_X, k + 1), k, gx[k],
                    gy[k]);
  }
}

// rof_primal at the strip's pixels of iteration `it`'s region, x in place;
// with LAST (the aligned step) x_prev and q_prev (the dual before the
// aligned step, which this one reads) out at the owned pixels, and their
// w_hat kept in the chunk's output x (x2), which out_strip reads back
// before it writes x there: so f's place is free for the dual step's
// |pd|^2, which then holds no register across the barrier.
template <int DT, bool EDGE, bool LAST, int CB>
__device__ __forceinline__ void primal_strip(const TShared& sh,
                                             const Tiled& a,
                                             const TStrip<CB>& t, unsigned e,
                                             int it) {
  int k0, k1;
  t.rows(exact_region(sh.v, it, false), k0, k1);
  if (k0 >= k1) return;
  const float tau0 = LAST ? 0.f : sh.k.tau, tl0 = tau0 * sh.k.lmb;
  const float dt10 = DT == DT_SQUARE && !LAST ? 1.f / (1.f + tl0) : 0.f;
  const unsigned own = LAST ? t.owned(sh, false) : 0u;
  const size_t g0 = LAST ? t.first(sh, a.ny) : 0;
  float up = t.at(TP_QX, k0 - 1);  // read, and dropped at window row 0
#pragma unroll
  for (int k = 0; k < TL_K; ++k) {
    if (k < k0 || k >= k1) continue;
    const float tau = LAST ? sh.k.tau : tau0;
    const float tl = LAST ? tau * sh.k.lmb : tl0;
    const float dt1 = LAST && DT == DT_SQUARE ? 1.f / (1.f + tl) : dt10;
    const float kty = kty_tile<EDGE>(t, e, up, k);
    up = t.at(TP_QX, k);
    const float xv = t.at(TP_X, k);
    const float xn = primal_at(xv, kty, t.at(TP_F, k),
                               DT == DT_WSQUARE ? t.at(TP_W, k) : 0.f, tau,
                               tl, dt1, DT);
    if (LAST && (own >> k & 1u)) {
      const size_t g = g0 + (size_t)k * a.ny;
      sh.xp[g] = xv;
      sh.qpx[g] = up;
      sh.qpy[g] = t.at(TP_QY, k);
      sh.x2[g] = w_hat(xv, xn, kty, sh.k.inv_t);
    }
    t.at(TP_X, k) = xn;
  }
}

// rof_dual at the strip's pixels of iteration `it`'s region, q in place,
// grad x_old from the carry and grad x_new into it; with LAST (the aligned
// step) the |pd|^2 and |z_hat|^2 terms of the owned pixels (0 off the
// owned rows) into f's place and into the carry, in place of the
// gradient.
template <bool EDGE, bool LAST, int CB>
__device__ __forceinline__ void dual_strip(const TShared& sh,
                                           const TStrip<CB>& t, unsigned e,
                                           int it, float (&gx)[TL_K],
                                           float (&gy)[TL_K]) {
  int k0, k1;
  t.rows(exact_region(sh.v, it, true), k0, k1);
  if (k0 >= k1) return;
  const float sig_p0 = LAST ? 0.f : sh.k.sig_p;
  const float sig_t0 = LAST ? 0.f : sh.k.sig_t;
  const float radius0 = LAST ? 0.f : sh.k.radius;
  const unsigned term = LAST ? t.owned(sh, true) : 0u;
  float xc = t.at(TP_X, k0);
#pragma unroll
  for (int k = 0; k < TL_K; ++k) {
    if (k < k0 || k >= k1) continue;
    const float xb = t.at(TP_X, k + 1);
    float gxn, gyn, qxn, qyn;
    grad_tile<EDGE>(t, e, xc, xb, k, gxn, gyn);
    xc = xb;
    const float qx = t.at(TP_QX, k), qy = t.at(TP_QY, k);
    dual_at(qx, qy, gxn, gyn, gx[k], gy[k], LAST ? sh.k.sig_p : sig_p0,
            LAST ? sh.k.sig_t : sig_t0, LAST ? sh.k.radius : radius0, qxn,
            qyn);
    t.at(TP_QX, k) = qxn;
    t.at(TP_QY, k) = qyn;
    if (!LAST) {
      gx[k] = gxn;
      gy[k] = gyn;
      continue;
    }
    float pd2 = 0.f, zh2 = 0.f;
    if (term >> k & 1u)
      dual_terms(qx, qy, qxn, qyn, gxn, gyn, gx[k], gy[k], sh.k.inv_s,
                 sh.k.theta, pd2, zh2);
    t.at(TP_F, k) = pd2;
    gy[k] = zh2;
  }
}

// After the aligned step: the owned pixels of x and q out, and their
// |dd|^2 and |w_hat|^2 terms from w_hat (read back from x2 first) and K^T
// q of the new dual (0 off the owned rows); |z_hat|^2 from the carry into
// x's place, the new terms into the carry.
template <bool EDGE, int CB>
__device__ __forceinline__ void out_strip(const TShared& sh, const Tiled& a,
                                          const TStrip<CB>& t, unsigned e,
                                          float (&gx)[TL_K],
                                          float (&gy)[TL_K]) {
  const unsigned own = t.owned(sh, false);
  if (!own) return;
  const unsigned term = t.owned(sh, true);
  const size_t g0 = t.first(sh, a.ny);
#pragma unroll
  for (int k = 0; k < TL_K; ++k) {
    if (!(own >> k & 1u)) continue;
    const size_t g = g0 + (size_t)k * a.ny;
    const float wh = sh.x2[g];
    sh.x2[g] = t.at(TP_X, k);
    sh.q2x[g] = t.at(TP_QX, k);
    sh.q2y[g] = t.at(TP_QY, k);
    float dd2 = 0.f, wh2 = 0.f;
    if (term >> k & 1u) {
      const float dd =
          wh + SQRT_T * kty_tile<EDGE>(t, e, t.at(TP_QX, k - 1), k);
      dd2 = dd * dd;
      wh2 = wh * wh;
    }
    t.at(TP_X, k) = gy[k];
    gx[k] = dd2;
    gy[k] = wh2;
  }
}

// The iterations of a window after its loads: the seed, count - 1
// iterations, the aligned one, then the four norm terms of each owned
// pixel in place of its f (|pd|^2), x (|z_hat|^2), q_x (|dd|^2) and q_y
// (|w_hat|^2) (EDGE: a window whose stencils test their neighbours, by
// the strip's edge bits).  Only the loops over a strip, whose carry lives
// in registers, are unrolled.
template <int DT, bool EDGE, int CB>
__device__ __forceinline__ void tiled_steps(const TShared& sh,
                                            const Tiled& a,
                                            const TStrip<CB>& t) {
  const int c = a.count;
  const unsigned e = EDGE ? t.edges(sh, a.nx, a.ny) : 0u;
  float gx[TL_K], gy[TL_K];
#pragma unroll
  for (int k = 0; k < TL_K; ++k) gx[k] = gy[k] = 0.f;
  seed_strip<EDGE>(sh, t, e, gx, gy);
  __syncthreads();  // the primal step writes x in place
#pragma unroll 1
  for (int it = 1; it < c; ++it) {
    primal_strip<DT, EDGE, false>(sh, a, t, e, it);
    __syncthreads();
    dual_strip<EDGE, false>(sh, t, e, it, gx, gy);
    __syncthreads();
  }
  primal_strip<DT, EDGE, true>(sh, a, t, e, c);
  __syncthreads();
  dual_strip<EDGE, true>(sh, t, e, c, gx, gy);
  __syncthreads();
  out_strip<EDGE>(sh, a, t, e, gx, gy);
  __syncthreads();  // every K^T q of the new dual is read
  const unsigned own = t.owned(sh, false);
#pragma unroll
  for (int k = 0; k < TL_K; ++k) {
    if (!(own >> k & 1u)) continue;
    t.at(TP_QX, k) = gx[k];
    t.at(TP_QY, k) = gy[k];
  }
}

// The 32x8 tiles of the owned region, a warp a tile: fn(wi, wj, rr, in)
// for each of the tile's 8 rows rr of the lane's column, `in` whether the
// pixel lies in the owned region (and so in the plane); then emit(gt) with
// the tile's number in the plane's grid (grid_of).
template <class Px, class Emit>
__device__ __forceinline__ void owned_tiles(const Tiled& a, const TWin& v,
                                            Px fn, Emit emit) {
  const int lane = threadIdx.x % BX, warp = threadIdx.x / BX;
  const int rows = v.oi1 - v.oi0, cols = v.oj1 - v.oj0;
  const int nty = (rows + BY - 1) / BY, ntx = (cols + BX - 1) / BX;
  const int gtx = (a.ny + BX - 1) / BX;
  for (int t = warp; t < nty * ntx; t += TL_WARPS) {
    const int sy = t / ntx, sx = t % ntx;
    const int wj = v.oj0 + sx * BX + lane;
#pragma unroll
    for (int rr = 0; rr < BY; ++rr) {
      const int wi = v.oi0 + sy * BY + rr;
      fn(wi, wj, rr, wi < v.oi1 && wj < v.oj1);
    }
    const int gi = (v.r0 + v.oi0) / BY + sy, gj = (v.c0 + v.oj0) / BX + sx;
    emit(gi * gtx + gj);
  }
}

// The launch on windows of at most 32 CB columns (tiled_launch picks CB).
template <int DT, int CB>
__global__ void __launch_bounds__(TL_THREADS, 1) rof_tiled(Tiled a) {
  constexpr int S = BX * CB;
  const float* sc = a.sc + blockIdx.z * (size_t)S_LEN;
  if (sc[S_CONV] != 0.f) return;
  extern __shared__ float smem[];
  TShared& sh = *reinterpret_cast<TShared*>(smem);
  const int nx = a.nx, ny = a.ny;
  {
    const RowCtx r = row_ctx(sc, nx, a.nxg);
    const TWin v = tiled_window(a, r);
    if (threadIdx.x == 0) {
      const size_t n = (size_t)nx * ny, z = blockIdx.z;
      sh.v = v;
      sh.r = r;
      sh.k = rof_step(sc);
      sh.xp = a.xp + z * n;
      sh.qpx = a.qp + 2 * z * n;
      sh.qpy = sh.qpx + n;
      sh.x2 = a.x2 + z * n;
      sh.q2x = a.q2 + 2 * z * n;
      sh.q2y = sh.q2x + n;
    }
    // the window by the map's strips, the dead duals zeroed (rof_seed)
    const TStrip<CB> t((a.tx + 2 * a.count + 1) * S);
    const int wr = t.wr(), wc = t.wc();
    if (wc < v.ww) {
      const size_t n = (size_t)nx * ny, z1 = blockIdx.z * n, z2 = 2 * z1;
      const int j = v.c0 + wc;
#pragma unroll 1
      for (int k = 0; k < TL_K && wr + k < v.wh; ++k) {
        const size_t g = (size_t)(v.r0 + wr + k) * ny + j;
        cp_async4(&t.at(TP_X, k), a.x + z1 + g);
        cp_async4(&t.at(TP_QX, k), a.q + z2 + g);
        cp_async4(&t.at(TP_QY, k), a.q + z2 + n + g);
        cp_async4(&t.at(TP_F, k), a.f + z1 + g);
        if (DT == DT_WSQUARE) cp_async4(&t.at(TP_W, k), a.w + z1 + g);
      }
      cp_async_wait();
#pragma unroll 1
      for (int k = 0; k < TL_K && wr + k < v.wh; ++k) {
        if (dead_row(r, v.r0 + wr + k)) t.at(TP_QX, k) = 0.f;
        if (j == ny - 1) t.at(TP_QY, k) = 0.f;
      }
    }
  }
  __syncthreads();
  {
    const TStrip<CB> t((a.tx + 2 * a.count + 1) * S);
    if (sh.v.inner)
      tiled_steps<DT, false>(sh, a, t);
    else
      tiled_steps<DT, true>(sh, a, t);
  }
  __syncthreads();

  // the four terms of each owned 32x8 tile in block_partials' tree
  const TWin& v = sh.v;
  const int m = (a.tx + 2 * a.count + 1) * S;
  const float* planes = smem + TL_HEAD;
  const dim3 gt = grid_of(nx, ny);
  float* partial = a.partial + blockIdx.z * 4 * (size_t)gt.x * gt.y;
  const int lane = threadIdx.x % BX;
  float t0[BY], t1[BY], t2[BY], t3[BY];
  owned_tiles(
      a, v,
      [&](int wi, int wj, int rr, bool own) {
        t0[rr] = t1[rr] = t2[rr] = t3[rr] = 0.f;
        if (!own) return;
        const int p = wi * S + wj;
        t0[rr] = planes[p + 3 * m];
        t1[rr] = planes[p];
        t2[rr] = planes[p + m];
        t3[rr] = planes[p + 2 * m];
      },
      [&](int g) {
        const float s0 = tile_sum(t0), s1 = tile_sum(t1);
        const float s2 = tile_sum(t2), s3 = tile_sum(t3);
        if (lane == 0) {
          partial[4 * g + 0] = s0;
          partial[4 * g + 1] = s1;
          partial[4 * g + 2] = s2;
          partial[4 * g + 3] = s3;
        }
      });
}

// (x2, q2) into (x, q) where the chunk left its result there: a chunk
// (multi 0) whose flag was not set at entry, a multichunk (multi 1) that
// ran an odd number of chunks; instance blockIdx.z of a batched chunk by
// its own flag.  T is float4 where every plane is 16-byte aligned (n, the
// pixels of a plane, counted in T).  Bound: memory, 3 planes read and 3
// written.
template <typename T>
__global__ void rof_tiled_settle(const T* __restrict__ x2,
                                 const T* __restrict__ q2,
                                 T* __restrict__ x, T* __restrict__ q,
                                 const float* __restrict__ sc, size_t n,
                                 int multi) {
  const size_t z = blockIdx.z;
  x2 += z * n;
  x += z * n;
  q2 += 2 * z * n;
  q += 2 * z * n;
  sc += z * S_LEN;
  const bool copy =
      multi ? ((int)sc[S_DONE] & 1) != 0 : sc[S_CONV] == 0.f;
  if (!copy) return;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < 3 * n;
       k += (size_t)gridDim.x * blockDim.x) {
    if (k < n)
      x[k] = x2[k];
    else
      q[k - n] = q2[k - n];
  }
}

using TiledKernel = void (*)(Tiled);

template <int DT>
TiledKernel tiled_kernel_of(int cb) {
  switch (cb) {
    case 1: return rof_tiled<DT, 1>;
    case 2: return rof_tiled<DT, 2>;
    case 3: return rof_tiled<DT, 3>;
    case 4: return rof_tiled<DT, 4>;
    case 5: return rof_tiled<DT, 5>;
    default: return rof_tiled<DT, 6>;
  }
}

// The kernel of a data term for windows of at most 32 cb columns.
TiledKernel tiled_kernel(int dataterm, int cb) {
  return dataterm == DT_SQUARE    ? tiled_kernel_of<DT_SQUARE>(cb)
         : dataterm == DT_WSQUARE ? tiled_kernel_of<DT_WSQUARE>(cb)
                                  : tiled_kernel_of<DT_ABS>(cb);
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device: the smallest of its three data terms' limits (the
// kernels hold no static shared memory), or minus the error.
int rof_tiled_limit() {
  int limit = -1;
  for (int dt = 0; dt < 3; ++dt) {
    int l = resident_smem_limit(tiled_kernel(dt, TL_MAX_CB));
    if (l < 0) return l;
    limit = limit < 0 || l < limit ? l : limit;
  }
  return limit;
}

// One tiled launch of `a` over `batch` instances, by the kernel whose map
// holds the widest window; refuses a tile that is not a multiple of the
// 32x8 norm tiles, whose map does not fit a block (tiled_map_ok) or whose
// window does not fit in a block's shared memory, and a batch beyond
// MAX_BATCH.
int tiled_launch(const Tiled& a, int dataterm, cudaStream_t s,
                 int batch = 1) {
  if (int rc = batch_error(batch)) return rc;
  if (a.tx < BY || a.tx % BY || a.ty < BX || a.ty % BX || a.count < 1 ||
      !tiled_map_ok(a.tx, a.ty, a.count))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem(a.tx, a.ty, a.count, dataterm);
  TiledKernel kern =
      tiled_kernel(dataterm, tiled_cb(min(a.ty + 2 * a.count + 1, a.ny)));
  const int limit = resident_smem_limit(kern);
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.ny + a.ty - 1) / a.ty, (a.nx + a.tx - 1) / a.tx, batch);
  kern<<<grid, TL_THREADS, smem, s>>>(a);
  LAUNCH_CHECK();
  return 0;
}

int tiled_settle(const Tiled& a, float* x, float* q, int multi,
                 cudaStream_t s, int batch = 1) {
  const size_t n = (size_t)a.nx * a.ny;
  const bool wide = n % 4 == 0 &&
                    ((size_t)a.x2 | (size_t)a.q2 | (size_t)x | (size_t)q) %
                            sizeof(float4) == 0;
  const size_t m = wide ? n / 4 : n;
  const size_t blocks = (3 * m + 511) / 512;
  const dim3 grid(blocks < 528 ? (int)blocks : 528, 1, batch);
  if (wide)
    rof_tiled_settle<<<grid, 512, 0, s>>>(
        (const float4*)a.x2, (const float4*)a.q2, (float4*)x, (float4*)q,
        a.sc, m, multi);
  else
    rof_tiled_settle<<<grid, 512, 0, s>>>(a.x2, a.q2, x, q, a.sc, m, multi);
  LAUNCH_CHECK();
  return 0;
}

// A chunk of `batch` instances: the tiled launch, the finish (a block an
// instance) and the copy back of each instance whose flag was clear.
int tiled_chunk(const Tiled& a, float* x, float* q, int dataterm, int batch,
                cudaStream_t s) {
  if (int rc = tiled_launch(a, dataterm, s, batch)) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const dim3 g = grid_of(a.nx, a.ny);
  pdhg_finish<<<batch, FIN, 0, s>>>(a.sc, a.partial, (int)(g.x * g.y),
                                    a.count, 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return tiled_settle(a, x, q, 0, s, batch);
}

// The Tiled of `batch` instances; `scratch` holds their (x2, q2) as
// (B, nx, ny) then (B, 2, nx, ny), 3 B planes.
Tiled tiled_of(void* x, void* q, void* xp, void* qp, const void* f,
               const void* w, void* sc, void* partial, void* scratch, int nx,
               int ny, int nx_global, int count, int tx, int ty,
               int batch = 1) {
  const size_t n = (size_t)nx * ny;
  Tiled a;
  a.x = (const float*)x;
  a.q = (const float*)q;
  a.x2 = (float*)scratch;
  a.q2 = (float*)scratch + (size_t)batch * n;
  a.xp = (float*)xp;
  a.qp = (float*)qp;
  a.f = (const float*)f;
  a.w = (const float*)w;
  a.sc = (float*)sc;
  a.partial = (float*)partial;
  a.nx = nx;
  a.ny = ny;
  a.nxg = nx_global;
  a.count = count;
  a.tx = tx;
  a.ty = ty;
  return a;
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

// rof_fused_chunk_batched with each instance held on chip by a cluster of
// `csize` CTAs (ops/fused_rof.py cluster_size): one cluster launch and the
// finish.  Reads x, q, f, w and writes x2, q2, x_prev, q_prev (all
// distinct buffers); an instance whose sc[S_CONV] is set gets its inputs
// as its outputs and keeps zero norms.  Refuses (returns the error of) a
// cluster the card cannot hold.
int prost_rof_chunk_cluster(const void* x, const void* q, const void* f,
                            const void* w, void* x2, void* q2, void* xp,
                            void* qp, void* sc, void* partial, int nx,
                            int ny, int count, int dataterm, int batch,
                            int csize, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  if (int rc = cluster_config(nx, ny, dataterm, csize, batch, s, cfg, attr,
                              &clusters))
    return rc;
  Cluster a = {(const float*)x, (const float*)q, (const float*)f,
               (const float*)w, (float*)x2, (float*)q2, (float*)xp,
               (float*)qp, (float*)sc, (float*)partial, nx, ny,
               cluster_band_rows(nx, csize), count};
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_kernel(dataterm), a);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, s>>>((float*)sc, (const float*)partial,
                                    prost_rof_num_blocks(nx, ny), count, 0,
                                    STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

// The clusters of `csize` that the card holds at once for an (nx, ny)
// chunk (cudaOccupancyMaxActiveClusters), or minus the error that refuses
// the configuration.
int prost_rof_cluster_occupancy(int nx, int ny, int dataterm, int csize) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = cluster_config(nx, ny, dataterm, csize, 1, 0, cfg, attr,
                          &clusters);
  return rc == (int)cudaErrorLaunchOutOfResources ? 0
                                                  : (rc ? -rc : clusters);
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

// rof_fused_chunk as one grid-resident cooperative launch (rof_resident),
// bit-equal to prost_rof_chunk: the same planes and scalars without the
// carried gradient's, `terms` 8 (nx, ny) planes of scratch.  A band that
// does not fit in one block's shared memory is refused
// (cudaErrorInvalidValue or cudaErrorCooperativeLaunchTooLarge).  No-op
// when sc[S_CONV] is set.
int prost_rof_chunk_resident(void* x, void* q, void* xp, void* qp,
                             const void* f, const void* w, void* sc,
                             void* partial, void* terms, int nx, int ny,
                             int count, int dataterm, void* stream) {
  Planes b = planes_of(x, q, xp, qp, nullptr, nullptr, f, w, sc, partial,
                       nx, ny);
  b.terms = (float*)terms;
  return resident_chunk(b, count, dataterm, (cudaStream_t)stream);
}

// rof_fused_chunk_halo as one grid-resident cooperative launch
// (rof_resident on one halo-extended band, the row context in sc as
// prost_rof_chunk_halo takes it), bit-equal to prost_rof_chunk_halo: its
// planes and scalars without the carried gradient's, `terms` 8 (nx, ny)
// planes of scratch.  Refuses a band that does not fit as
// prost_rof_chunk_resident does.  No-op when sc[S_CONV] is set.
int prost_rof_chunk_halo_resident(void* x, void* q, void* xp, void* qp,
                                  const void* f, const void* w, void* sc,
                                  void* partial, void* terms, int nx, int ny,
                                  int nx_global, int count, int dataterm,
                                  void* stream) {
  Planes b = planes_of(x, q, xp, qp, nullptr, nullptr, f, w, sc, partial,
                       nx, ny);
  b.terms = (float*)terms;
  b.nxg = nx_global;
  return resident_chunk(b, count, dataterm, (cudaStream_t)stream);
}

// rof_fused_multichunk as one grid-resident cooperative launch
// (rof_multichunk_resident), bit-equal to prost_rof_multichunk in the
// planes, the previous iterates and sc: its arguments without the carried
// gradient's planes, `terms` 8 (nx, ny) planes of scratch.  Refuses a band
// that does not fit as prost_rof_chunk_resident does.  No-op when
// sc[S_CONV] is set.
int prost_rof_multichunk_resident(void* x, void* q, void* xp, void* qp,
                                  const void* f, const void* w, void* sc,
                                  void* partial, void* terms, int nx, int ny,
                                  int count, int k_chunks, int dataterm,
                                  int stepsize, float sqrt_nrows,
                                  float sqrt_ncols, float arg_delta,
                                  float arg_nu, float arb_delta,
                                  float arb_tau, void* stream) {
  Planes b = planes_of(x, q, xp, qp, nullptr, nullptr, f, w, sc, partial,
                       nx, ny);
  b.terms = (float*)terms;
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(nx, ny, dataterm, 1, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &k_chunks, &stepsize, &c, &rmax};
  return resident_launch(rof_multichunk_resident_kernel(dataterm), args,
                         smem, (cudaStream_t)stream);
}

// The dynamic shared memory a block of rof_resident (with `multi`,
// rof_multichunk_resident) may hold on the current device, or minus the
// error.
int prost_rof_resident_smem(int multi) { return rof_resident_limit(multi); }

// rof_fused_chunk_banded (the whole plane, or with nx_global a halo band
// as prost_rof_chunk_halo takes it) as one tiled launch of tx x ty tiles
// (rof_tiled), the finish and the copy back: (x, q) advance by `count`
// iterations in place, x_prev / q_prev of the aligned iteration into (xp,
// qp), the 4 squared norms into sc[S_NORM..]; `scratch` 3 (nx, ny) planes.
// Bit-equal to prost_rof_chunk (prost_rof_chunk_halo).  Refuses a tile
// that is not a multiple of 8 rows and 32 columns, or whose window does
// not fit in a block's shared memory (cudaErrorInvalidValue).  No-op when
// sc[S_CONV] is set.
int prost_rof_chunk_tiled(void* x, void* q, void* xp, void* qp,
                          const void* f, const void* w, void* sc,
                          void* partial, void* scratch, int nx, int ny,
                          int nx_global, int count, int dataterm, int tx,
                          int ty, void* stream) {
  Tiled a = tiled_of(x, q, xp, qp, f, w, sc, partial, scratch, nx, ny,
                     nx_global, count, tx, ty);
  return tiled_chunk(a, (float*)x, (float*)q, dataterm, 1,
                     (cudaStream_t)stream);
}

// rof_fused_chunk_banded_batched (and rof_fused_chunk_batched for
// instances that no cluster holds) as one tiled launch of `batch`
// instances on blockIdx.z, one finish block an instance and one copy back
// gated by each instance's flag: x, q, xp, qp, f, w (B, nx, ny) and (B, 2,
// nx, ny), sc S_LEN an instance, partial 4 prost_rof_num_blocks(nx, ny)
// an instance, `scratch` 3 B (nx, ny) planes.  Instance b is
// prost_rof_chunk_tiled on instance b alone, bit for bit; an instance
// whose sc[S_CONV] is set keeps its four planes and its norms.  Refuses a
// tile as prost_rof_chunk_tiled does, and a batch beyond MAX_BATCH
// (cudaErrorInvalidValue).
int prost_rof_chunk_batched_tiled(void* x, void* q, void* xp, void* qp,
                                  const void* f, const void* w, void* sc,
                                  void* partial, void* scratch, int nx,
                                  int ny, int count, int dataterm, int batch,
                                  int tx, int ty, void* stream) {
  Tiled a = tiled_of(x, q, xp, qp, f, w, sc, partial, scratch, nx, ny, 0,
                     count, tx, ty, batch);
  return tiled_chunk(a, (float*)x, (float*)q, dataterm, batch,
                     (cudaStream_t)stream);
}

// rof_fused_multichunk_banded as up to k_chunks tiled launches, each
// followed by pdhg_finish's adaptation and stopping test, the chunks
// reading and writing (x, q) and the scratch's (x2, q2) in turn, and the
// copy back where an odd number ran; the arguments of
// prost_rof_multichunk_resident, `scratch` 3 (nx, ny) planes, and the
// tile.  Bit-equal to prost_rof_multichunk in the planes, the previous
// iterates and sc.  Refuses a tile as prost_rof_chunk_tiled does.  No-op
// when sc[S_CONV] is set.
int prost_rof_multichunk_tiled(void* x, void* q, void* xp, void* qp,
                               const void* f, const void* w, void* sc,
                               void* partial, void* scratch, int nx, int ny,
                               int count, int k_chunks, int dataterm,
                               int stepsize, float sqrt_nrows,
                               float sqrt_ncols, float arg_delta,
                               float arg_nu, float arb_delta, float arb_tau,
                               int tx, int ty, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tiled a = tiled_of(x, q, xp, qp, f, w, sc, partial, scratch, nx, ny,
                           0, count, tx, ty);
  Tiled b = a;  // the odd chunks: from the scratch back into (x, q)
  b.x = a.x2;
  b.q = a.q2;
  b.x2 = (float*)x;
  b.q2 = (float*)q;
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  for (int k = 0; k < k_chunks; ++k) {
    if (int rc = tiled_launch(k & 1 ? b : a, dataterm, s)) return rc;
    pdhg_finish<<<1, FIN, 0, s>>>(a.sc, a.partial,
                                  prost_rof_num_blocks(nx, ny), count, 1,
                                  stepsize, c);
    LAUNCH_CHECK();
  }
  return tiled_settle(a, (float*)x, (float*)q, 1, s);
}

// The dynamic shared memory a block of rof_tiled may hold on the current
// device, or minus the error.
int prost_rof_tiled_smem() { return rof_tiled_limit(); }

}  // extern "C"
