// Fused TV-deblurring PDHG chunk kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels on the deblurring paths of the JAX package:
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk -> _deblur_chunk_kernel
//   (whole-plane mode)
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk_batched
//                                  -> _deblur_chunk_kernel_batched
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk_halo
//                                  -> _deblur_chunk_kernel (halo=True)
// whose math is _chunk_core, _conv_ops and _grad_ops in the same file.  It
// also serves the JAX package's banded variant
// (deblur_fused_chunk_banded), which exists only because a TPU core's VMEM
// cannot hold the planes of large images: here the planes stay in device
// memory at every size.  The plain PyTorch versions live beside their
// wrappers in prost_tpu_torch/ops/fused_deblur.py.
//
// Workload: min_u lmb/2 |B u - f|^2 + |grad u|_{2,1}, B a full 2D
// convolution with T <= 96 nonzero taps; primal x (nx, ny), duals yv
// (nx2, ny2) = (nx + kx - 1, ny + ky - 1) and q (2, nx, ny).
//
// Layout.  x and q are the solver's (nx, ny) planes (q = [qx; qy]); yv, the
// blurred data fb and the conv-row preconditioner sv are (nx2, ny2).  The
// JAX kernel embeds x and q in the (nx2, ny2) geometry with zero padding,
// which every update keeps at zero; here a read outside (nx, ny) is that
// zero, so no plane is padded or cropped.  The carried products are bx = B x
// (nx2, ny2) and g = grad x (2, nx, ny).  A batched launch takes B frames
// that share one blur back to back, x (B, nx, ny), q (B, 2, nx, ny) and the
// (nx2, ny2) planes (B, nx2, ny2), with a scalar block of S_LEN per frame,
// on the z axis of both grids (pdhg_chunk.cuh); the taps are one array for
// all frames.
//
// Halo mode (spatial sharding).  The JAX package partitions the rows of
// the embedded (nx2, ny2) grid over the shards, with a halo of
// (2 ri + 2) * reach rows (reach = the blur's largest row shift, at least
// the gradient's 1): each half-step moves information by the conv's row
// reach.  Here a halo launch takes the shard's x, q, yv, fb and sv cut at
// the same global rows of that grid, x (ext, ny), q (2, ext, ny) and the
// others (ext, ny2), ext = rows + 2 halo, zeros beyond the planes (x and q
// have only nx global rows).  The row context of pdhg_chunk.cuh (from the
// scalars) turns every test of "inside (nx, ny)" into one on the global
// row, i + off in [0, nx); a conv or stencil read beyond the local rows is
// zero, which only the halo rows see.  The norms cover the owned rows of
// both grids.  bx and g are not exchanged: the seed recomputes them from x
// at every launch, as the JAX kernel does, and the halo's accounting
// includes that application.  The whole-plane launches are the case
// (0, nx, 0, nx2) of the same arithmetic.
//
// What bounds it on this card.  An iteration streams about 10 (nx, ny)
// planes and 7 (nx2, ny2) planes (primal: x, 2 q, yv in, x out; dual: x, yv,
// bx, fb, sv, 2 q, 2 g in, yv, bx, 2 q, 2 g out) and does about 4T + 35
// operations a pixel, so at T = 7 it is bound by memory traffic, and at
// 512x512 by launch latency: a chunk of ri iterations is 2*ri + 3 launches.
// A batched chunk of 8 frames of 512x512 streams 8 times that per launch
// in 8 times the blocks: about 140 MB an iteration, beyond the 50 MB L2, so
// it is bound by device memory traffic.
//
// Design.  One thread per pixel, 32x8 blocks (pdhg_chunk.cuh): the primal
// step runs on the (nx, ny) grid, the dual step and the norms on the (nx2,
// ny2) grid, whose threads inside (nx, ny) also update q.  Every kernel
// updates its planes in place and reads neighbours only from planes it does
// not write: the primal step writes x and reads yv's and q's neighbours,
// the dual step writes yv, bx, q, g and reads x's.  The taps arrive from
// the wrapper in a small device array, in the order of the JAX package's
// sums, and each block stages them in shared memory.  Nothing is
// canonicalized: the gradient adjoint is masked to the (nx, ny) region, as
// in the JAX kernel, so the dual coordinates outside K^T's reach (q_x's last
// row, q_y's last column) are carried as they come.  The scalars live in
// the device buffer `sc` (pdhg_chunk.cuh), and every kernel returns at once
// once sc[S_CONV] is set.
//
// Rounding.  Built with -fmad=false; sqrt(Sigma_q) and sqrt(Tau) are
// rounded once from double by the wrapper, as the plain version rounds its
// Python constants.  The taps' products are summed by the pairwise tree of
// the JAX package (a binary counter gives the same tree), so the kernel and
// the plain version round the convolutions alike.  The differences to the
// plain version are rsqrtf in the ball projection and the order of the
// norm sums.  A zero dual vector keeps scale 1, where the JAX form gives
// NaN for radius 0.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "pdhg_chunk.cuh"

namespace {

// the family's two scalars in the buffer's slots 3 and 4
enum { S_LMB = S_ARG3, S_RADIUS = S_ARG4 };

constexpr int MAX_TAPS = 96;  // mirrored by ops/fused_deblur.py
constexpr int TREE_LEVELS = 7;  // 2^7 > MAX_TAPS

// The taps of a launch, staged by each block into shared memory from the
// wrapper's (3, n) device array [dx; dy; w], where every thread of a warp
// reads the same entry (a broadcast).
struct Taps {
  int n;
  int dx[MAX_TAPS];
  int dy[MAX_TAPS];
  float w[MAX_TAPS];
};

__device__ __forceinline__ void stage_taps(const float* src, int n,
                                           Taps& t) {
  int tid = threadIdx.y * BX + threadIdx.x;
  if (tid == 0) t.n = n;
  for (int k = tid; k < n; k += NT) {
    t.dx[k] = (int)src[k];
    t.dy[k] = (int)src[n + k];
    t.w[k] = src[2 * n + k];
  }
  __syncthreads();
}

struct DB {
  float* x;    // (nx, ny) iterate, updated in place
  float* yv;   // (nx2, ny2) blur dual, updated in place
  float* q;    // (2, nx, ny) TV dual, updated in place
  float* xp;   // x, yv, q before the chunk's last (aligned) iteration
  float* yvp;
  float* qp;
  float* bx;   // (nx2, ny2) B x carried between iterations
  float* bxp;  // the same of x_prev
  float* g;    // (2, nx, ny) grad x carried between iterations
  float* gp;   // the same of x_prev
  const float* fb;  // (nx2, ny2) blurred data
  const float* sv;  // (nx2, ny2) Sigma of the conv rows
  const float* taps;  // (3, ntaps) [dx; dy; w]
  float* sc;
  float* partial;  // 4 per block of the (nx2, ny2) grid
  int nx, ny, nx2, ny2, ntaps;  // local rows of the x and yv planes
  int nxg;  // image rows of a halo launch; 0: the whole plane
  float sig_q, tau_t;     // Sigma of the gradient rows, Tau
  float sqrt_q, sqrt_t;   // their square roots
};

// The buffers of this block's frame (blockIdx.z) of a batched launch, each
// moved by its per-frame size with 64-bit offsets: (nx, ny) for x, (2, nx,
// ny) for q and g, (nx2, ny2) for yv, bx, fb and sv.  The taps are shared,
// and block_partials places the partials by blockIdx.z itself.
__device__ __forceinline__ DB instance_of(DB b) {
  size_t z = blockIdx.z, n = (size_t)b.nx * b.ny;
  size_t m2 = (size_t)b.nx2 * b.ny2;
  b.x += z * n;
  b.xp += z * n;
  b.q += 2 * z * n;
  b.qp += 2 * z * n;
  b.g += 2 * z * n;
  b.gp += 2 * z * n;
  b.yv += z * m2;
  b.yvp += z * m2;
  b.bx += z * m2;
  b.bxp += z * m2;
  b.fb += z * m2;
  b.sv += z * m2;
  b.sc += z * S_LEN;
  return b;
}

// Pairwise tree sum of a stream of terms: level l holds the sum of the
// last complete block of 2^l terms; a new term carries up like a binary
// counter, and the total adds the partial blocks from the smallest up.
// This is the tree of the JAX package's level-by-level pairing.
struct TreeSum {
  float lev[TREE_LEVELS];
  unsigned mask = 0;

  __device__ __forceinline__ void add(float t) {
#pragma unroll
    for (int l = 0; l < TREE_LEVELS; ++l) {
      if (!(mask & (1u << l))) {
        lev[l] = t;
        mask |= 1u << l;
        return;
      }
      t = lev[l] + t;
      mask &= ~(1u << l);
    }
  }

  __device__ __forceinline__ float total() const {
    float acc = 0.f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < TREE_LEVELS; ++l) {
      if (mask & (1u << l)) {
        acc = have ? lev[l] + acc : lev[l];
        have = true;
      }
    }
    return acc;
  }
};

// Where a launch's rows lie: the whole plane is (0, nx, 0, nx2), the owned
// rows all of the yv grid's; a halo launch reads its row context from sc.
__device__ __forceinline__ RowCtx deblur_rows(const DB& b) {
  if (b.nxg == 0) return RowCtx{0, b.nx, 0, b.nx2};
  return RowCtx{(int)b.sc[S_ROW_OFF], b.nxg, (int)b.sc[S_OWN_LO],
                (int)b.sc[S_OWN_HI]};
}

// Local row i of the x plane is an image row (global row in [0, nx)).
__device__ __forceinline__ bool image_row(const RowCtx& r, int i, int nx) {
  return i < nx && i + r.off >= 0 && i + r.off < r.nxg;
}

// (B u)(i, j) = sum_d w_d u(i - dx_d, j - dy_d) on the yv grid, u an x
// plane read as zero outside the image and beyond its local rows.
__device__ __forceinline__ float conv_fwd(const float* u, const DB& b,
                                          const RowCtx& r, int i, int j,
                                          const Taps& t) {
  TreeSum s;
  for (int k = 0; k < t.n; ++k) {
    int a = i - t.dx[k], c = j - t.dy[k];
    float v = (a >= 0 && image_row(r, a, b.nx) && c >= 0 && c < b.ny)
                  ? u[(size_t)a * b.ny + c]
                  : 0.f;
    s.add(t.w[k] * v);
  }
  return s.total();
}

// (B^T v)(i, j) = sum_d w_d v(i + dx_d, j + dy_d) at an image pixel (i, j);
// on the whole plane every read lies inside v, on a halo band a read below
// its last local row is zero.
__device__ __forceinline__ float conv_adj(const float* v, const DB& b, int i,
                                          int j, const Taps& t) {
  TreeSum s;
  for (int k = 0; k < t.n; ++k) {
    int a = i + t.dx[k];
    s.add(t.w[k] * (a < b.nx2 ? v[(size_t)a * b.ny2 + (j + t.dy[k])] : 0.f));
  }
  return s.total();
}

// K^T y at an image pixel (i, j): B^T yv plus the masked gradient adjoint
// (_grad_ops' dxt, dyt), summed in the JAX package's order.
__device__ __forceinline__ float kty_at(const float* yv, const float* q,
                                        const DB& b, const RowCtx& r, int i,
                                        int j, const Taps& t) {
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  float dxt = (has_above(r, i) ? q[p - b.ny] : 0.f)
              - (has_below(r, i, b.nx) ? q[p] : 0.f);
  float dyt = (j > 0 ? q[n + p - 1] : 0.f) - (j < b.ny - 1 ? q[n + p] : 0.f);
  return (conv_adj(yv, b, i, j, t) + dxt) + dyt;
}

// Seed of a launch: bx = B x on the (nx2, ny2) grid, g = grad x inside.
// Bound: memory, one (nx, ny) plane read (T times through L1), three
// planes written.
__global__ void deblur_seed(DB b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  __shared__ Taps t;
  stage_taps(b.taps, b.ntaps, t);
  int i, j;
  if (!pixel(b.nx2, b.ny2, i, j)) return;
  RowCtx r = deblur_rows(b);
  b.bx[(size_t)i * b.ny2 + j] = conv_fwd(b.x, b, r, i, j, t);
  if (image_row(r, i, b.nx) && j < b.ny) {
    size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
    float xv = b.x[p];
    b.g[p] = has_below(r, i, b.nx) ? b.x[p + b.ny] - xv : 0.f;
    b.g[n + p] = j < b.ny - 1 ? b.x[p + 1] - xv : 0.f;
  }
}

// Primal step (_chunk_core's update, first half): x <- x - tau Tau K^T y.
// Bound: memory, x, yv (T reads through L1), 2 q in, x out (2 x on the
// aligned iteration, which also saves x_prev).
__global__ void deblur_primal(DB b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  __shared__ Taps t;
  stage_taps(b.taps, b.ntaps, t);
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  RowCtx r = deblur_rows(b);
  size_t p = (size_t)i * b.ny + j;
  if (!image_row(r, i, b.nx)) {  // a band's row beyond the image stays
    if (save_prev) b.xp[p] = b.x[p];
    return;
  }
  float tau_s = b.sc[S_TAU] * b.tau_t;  // tau * Tau
  float kty = kty_at(b.yv, b.q, b, r, i, j, t);
  float xv = b.x[p];
  if (save_prev) b.xp[p] = xv;
  b.x[p] = xv - tau_s * kty;
}

// Dual step (second half): bx2 = B x, yv <- prox of the data term's
// conjugate at yv + sigma Sigma_v ((1 + theta) bx2 - theta bx); inside (nx,
// ny) also grad x and q <- the radius ball projection of q + sigma Sigma_q
// ((1 + theta) grad x - theta g).  bx2 and grad x are carried.
// Bound: memory, x (T + 2 reads through L1), yv, bx, fb, sv, 2 q, 2 g in;
// yv, bx, 2 q, 2 g out (twice that on the aligned iteration).
__global__ void deblur_dual(DB b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  __shared__ Taps t;
  stage_taps(b.taps, b.ntaps, t);
  int i, j;
  if (!pixel(b.nx2, b.ny2, i, j)) return;
  float sigma = b.sc[S_SIGMA], theta = b.sc[S_THETA];
  float tp = 1.f + theta;
  size_t p2 = (size_t)i * b.ny2 + j;
  RowCtx r = deblur_rows(b);
  float bx2 = conv_fwd(b.x, b, r, i, j, t);
  float tsv = sigma * b.sv[p2];  // sigma * Sigma_v
  float inv_l = 1.f / b.sc[S_LMB];
  float den = 1.f / (1.f + tsv * inv_l);
  float sh = tsv * b.fb[p2];
  float yvv = b.yv[p2], bxv = b.bx[p2];
  float av = yvv + tsv * (tp * bx2 - theta * bxv);
  if (save_prev) {
    b.yvp[p2] = yvv;
    b.bxp[p2] = bxv;
  }
  b.yv[p2] = (av - sh) * den;
  b.bx[p2] = bx2;
  if (i >= b.nx || j >= b.ny) return;
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  if (!image_row(r, i, b.nx)) {  // a band's row beyond the image stays
    if (save_prev) {
      b.qp[p] = b.q[p];
      b.qp[n + p] = b.q[n + p];
    }
    return;
  }

  float xv = b.x[p];
  float gx2 = has_below(r, i, b.nx) ? b.x[p + b.ny] - xv : 0.f;
  float gy2 = j < b.ny - 1 ? b.x[p + 1] - xv : 0.f;
  float sq = sigma * b.sig_q;  // sigma * Sigma_q
  float sig_p = sq * tp, sig_t = sq * theta;
  float qx = b.q[p], qy = b.q[n + p];
  float gx = b.g[p], gy = b.g[n + p];
  float ax = (qx + sig_p * gx2) - sig_t * gx;
  float ay = (qy + sig_p * gy2) - sig_t * gy;
  float nn = ax * ax + ay * ay;
  float scale = nn > 0.f ? fminf(1.f, b.sc[S_RADIUS] * rsqrtf(nn)) : 1.f;
  if (save_prev) {
    b.qp[p] = qx;
    b.qp[n + p] = qy;
    b.gp[p] = gx;
    b.gp[n + p] = gy;
  }
  b.q[p] = ax * scale;
  b.q[n + p] = ay * scale;
  b.g[p] = gx2;
  b.g[n + p] = gy2;
}

// First pass of the four preconditioned residual norms (_chunk_core after
// the aligned iteration): per pixel of the owned rows of the yv grid the
// terms of |pd|^2, |z_hat|^2 (the yv plane, and inside the image the q
// planes), and inside the image |dd|^2 and |w_hat|^2, then per-block tree
// sums into partial[4 * block].  K^T of the current and previous duals is
// recomputed.
// Bound: memory, once per chunk.
__global__ void deblur_norm_partial(DB b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  __shared__ Taps t;
  stage_taps(b.taps, b.ntaps, t);
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx r = deblur_rows(b);
  if (pixel(b.nx2, b.ny2, i, j) && owned_row(r, i)) {
    float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
    float theta = b.sc[S_THETA];
    float tp = 1.f + theta;
    size_t p2 = (size_t)i * b.ny2 + j;
    float sqrt_sv = sqrtf(b.sv[p2]);
    float inv_v = 1.f / (sigma_raw * sqrt_sv);
    float bx2 = b.bx[p2];
    float zv = (b.yvp[p2] - b.yv[p2]) * inv_v
               + sqrt_sv * (tp * bx2 - theta * b.bxp[p2]);
    float pdv = zv - sqrt_sv * bx2;
    v[0] = pdv * pdv;
    v[1] = zv * zv;
    if (image_row(r, i, b.nx) && j < b.ny) {
      size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
      float inv_q = 1.f / (sigma_raw * b.sqrt_q);
      float inv_t = 1.f / (tau_raw * b.sqrt_t);
      float gx2 = b.g[p], gy2 = b.g[n + p];
      float zx = (b.qp[p] - b.q[p]) * inv_q
                 + b.sqrt_q * (tp * gx2 - theta * b.gp[p]);
      float zy = (b.qp[n + p] - b.q[n + p]) * inv_q
                 + b.sqrt_q * (tp * gy2 - theta * b.gp[n + p]);
      float pdx = zx - b.sqrt_q * gx2;
      float pdy = zy - b.sqrt_q * gy2;
      float kty2 = kty_at(b.yv, b.q, b, r, i, j, t);
      float ktyp = kty_at(b.yvp, b.qp, b, r, i, j, t);
      float wh = (b.xp[p] - b.x[p]) * inv_t - b.sqrt_t * ktyp;
      float dd = wh + b.sqrt_t * kty2;
      v[0] += pdx * pdx + pdy * pdy;
      v[1] += zx * zx + zy * zy;
      v[2] = dd * dd;
      v[3] = wh * wh;
    }
  }
  block_partials(v, b.partial);
}

// One chunk of `batch` frames: the seed, `count` iterations, the norm
// partials on the (nx2, ny2) grid and the squared norms of every frame into
// its scalars (one finish block each).
int chunk(const DB& b, int count, int batch, cudaStream_t st) {
  dim3 block(BX, BY), gfull = grid_of(b.nx2, b.ny2, batch);
  dim3 gimg = grid_of(b.nx, b.ny, batch);
  deblur_seed<<<gfull, block, 0, st>>>(b);
  LAUNCH_CHECK();
  for (int k = 0; k < count; ++k) {
    int last = k == count - 1;
    deblur_primal<<<gimg, block, 0, st>>>(b, last);
    LAUNCH_CHECK();
    deblur_dual<<<gfull, block, 0, st>>>(b, last);
    LAUNCH_CHECK();
  }
  deblur_norm_partial<<<gfull, block, 0, st>>>(b);
  LAUNCH_CHECK();
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, st>>>(b.sc, b.partial,
                                     (int)(gfull.x * gfull.y), count, 0,
                                     STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

DB deblur_of(void* x, void* yv, void* q, void* xp, void* yvp, void* qp,
             void* bx, void* bxp, void* g, void* gp, const void* fb,
             const void* sv, const void* taps, void* sc, void* partial,
             int nx, int ny, int nx2, int ny2, int ntaps, float sig_q,
             float tau_t, float sqrt_q, float sqrt_t) {
  DB b;
  b.x = (float*)x;
  b.yv = (float*)yv;
  b.q = (float*)q;
  b.xp = (float*)xp;
  b.yvp = (float*)yvp;
  b.qp = (float*)qp;
  b.bx = (float*)bx;
  b.bxp = (float*)bxp;
  b.g = (float*)g;
  b.gp = (float*)gp;
  b.fb = (const float*)fb;
  b.sv = (const float*)sv;
  b.taps = (const float*)taps;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.nx = nx;
  b.ny = ny;
  b.nx2 = nx2;
  b.ny2 = ny2;
  b.ntaps = ntaps;
  b.nxg = 0;
  b.sig_q = sig_q;
  b.tau_t = tau_t;
  b.sqrt_q = sqrt_q;
  b.sqrt_t = sqrt_t;
  return b;
}

}  // namespace

extern "C" {

// Number of per-block norm partials (4 floats each) for an (nx2, ny2) grid.
int prost_deblur_num_blocks(int nx2, int ny2) {
  dim3 g = grid_of(nx2, ny2);
  return (int)(g.x * g.y);
}

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// deblur_fused_chunk: `count` iterations on (x, yv, q) in place, the
// previous iterate of the aligned iteration into (xp, yvp, qp), the 4
// SQUARED norms into sc[S_NORM..].  No-op when sc[S_CONV] is set.
int prost_deblur_chunk(void* x, void* yv, void* q, void* xp, void* yvp,
                       void* qp, void* bx, void* bxp, void* g, void* gp,
                       const void* fb, const void* sv, const void* taps,
                       void* sc, void* partial, int nx, int ny, int nx2,
                       int ny2, int ntaps, float sig_q, float tau_t,
                       float sqrt_q, float sqrt_t, int count, void* stream) {
  DB b = deblur_of(x, yv, q, xp, yvp, qp, bx, bxp, g, gp, fb, sv, taps, sc,
                   partial, nx, ny, nx2, ny2, ntaps, sig_q, tau_t, sqrt_q,
                   sqrt_t);
  return chunk(b, count, 1, (cudaStream_t)stream);
}

// deblur_fused_chunk_batched: the same for `batch` frames sharing the taps
// in one launch sequence; sc holds S_LEN scalars per frame, partial 4 per
// block of the (nx2, ny2) grid per frame.  A frame whose sc[S_CONV] is set
// is a no-op.
int prost_deblur_chunk_batched(void* x, void* yv, void* q, void* xp,
                               void* yvp, void* qp, void* bx, void* bxp,
                               void* g, void* gp, const void* fb,
                               const void* sv, const void* taps, void* sc,
                               void* partial, int nx, int ny, int nx2,
                               int ny2, int ntaps, float sig_q, float tau_t,
                               float sqrt_q, float sqrt_t, int count,
                               int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  DB b = deblur_of(x, yv, q, xp, yvp, qp, bx, bxp, g, gp, fb, sv, taps, sc,
                   partial, nx, ny, nx2, ny2, ntaps, sig_q, tau_t, sqrt_q,
                   sqrt_t);
  return chunk(b, count, batch, (cudaStream_t)stream);
}

// deblur_fused_chunk_halo: prost_deblur_chunk on one halo-extended band of
// the yv grid's rows, x and q cut at the same global rows (nx = nx2 = the
// band's rows) of an image of nx_global rows; sc holds the row context
// (S_ROW_OFF, S_OWN_LO, S_OWN_HI) and the squared norms cover the owned rows
// only.
int prost_deblur_chunk_halo(void* x, void* yv, void* q, void* xp, void* yvp,
                            void* qp, void* bx, void* bxp, void* g, void* gp,
                            const void* fb, const void* sv, const void* taps,
                            void* sc, void* partial, int nx, int ny, int nx2,
                            int ny2, int ntaps, float sig_q, float tau_t,
                            float sqrt_q, float sqrt_t, int nx_global,
                            int count, void* stream) {
  DB b = deblur_of(x, yv, q, xp, yvp, qp, bx, bxp, g, gp, fb, sv, taps, sc,
                   partial, nx, ny, nx2, ny2, ntaps, sig_q, tau_t, sqrt_q,
                   sqrt_t);
  b.nxg = nx_global;
  return chunk(b, count, 1, (cudaStream_t)stream);
}

}  // extern "C"
