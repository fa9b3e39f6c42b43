// Fused TV-deblurring PDHG chunk kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels on the deblurring paths of the JAX package:
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk -> _deblur_chunk_kernel
//   (whole-plane mode)
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk_batched
//                                  -> _deblur_chunk_kernel_batched
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk_halo
//                                  -> _deblur_chunk_kernel (halo=True)
//   prost_tpu/ops/fused_deblur.py  deblur_fused_chunk_banded
//                                  -> _deblur_banded_kernel,
//                                     _deblur_banded_db_kernel
// whose math is _chunk_core, _conv_ops and _grad_ops in the same file.  The
// last, the banded route for planes beyond a TPU core's VMEM, becomes the
// tiled chunk (deblur_tiled, further down) for planes whose bands no
// grid-resident launch holds.  The plain PyTorch versions live beside
// their wrappers in prost_tpu_torch/ops/fused_deblur.py.
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
// 512x512 by launch latency: a chunk of ri iterations is 2*ri + 3 launches
// of the streaming sequence (chunk() below).  Where a chunk's planes fit in
// the shared memory of one block per SM (the wrapper's shape rule: config
// 2 at 512x512 and its one-shard halo band, not 2048x2048), the chunk and
// its halo mode run instead as one grid-resident cooperative launch
// (deblur_resident, further down), bit-equal to the sequence; on the card
// that launch is bound by the instructions of its convolutions and by its
// 23 grid barriers, not by bytes.  Where they do not fit but a tile's
// window does (config 2 at 2048x2048), they run as one tiled cooperative
// launch (deblur_tiled), one pass over device memory an iteration,
// bit-equal to the sequence too.
// A batched chunk of 8 frames of 512x512 streams 8 times that per launch
// in 8 times the blocks: about 140 MB an iteration, beyond the 50 MB L2, so
// that sequence is bound by device memory traffic; where one frame's
// planes fit (the same rule on one frame), the batched chunk runs instead
// as one grid-resident launch that takes the frames one after another
// (deblur_resident_batched), each as deblur_resident runs it alone.
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

#include <climits>

#include "cp_async.cuh"
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

// The taps in registers, for a count N known when compiling: the
// convolutions' loops over them, and the binary counter of their pairwise
// tree (TreeSum), unroll completely.
template <int N>
struct TapsN {
  static constexpr int n = N;
  int dx[N];
  int dy[N];
  float w[N];
};

template <int N>
__device__ __forceinline__ TapsN<N> taps_in_registers(const Taps& t) {
  TapsN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    r.dx[k] = t.dx[k];
    r.dy[k] = t.dy[k];
    r.w[k] = t.w[k];
  }
  return r;
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
  float* terms;    // the resident chunk's norm terms, 4 (nx2, ny2) planes
  int nx, ny, nx2, ny2, ntaps;  // local rows of the x and yv planes
  int nxg;  // image rows of a halo launch; 0: the whole plane
  float sig_q, tau_t;     // Sigma of the gradient rows, Tau
  float sqrt_q, sqrt_t;   // their square roots
  // floats from one frame to the next of (x, xp), (yv, yvp) and (q, qp) in
  // a batched launch: n, m2 and 2 n where each buffer holds its frames
  // back to back; a route's flat y = [yv; q] rows give yv and q the
  // stride m2 + 2 n
  long long zx, zyv, zq;
};

// The buffers of frame z of a batched launch, each moved by its per-frame
// stride with 64-bit offsets: zx, zyv and zq for the state and its
// previous iterate, (2, nx, ny) for g, (nx2, ny2) for bx, fb and sv.  The
// taps are shared.
__device__ __forceinline__ DB frame_at(DB b, size_t z) {
  size_t n = (size_t)b.nx * b.ny, m2 = (size_t)b.nx2 * b.ny2;
  b.x += z * b.zx;
  b.xp += z * b.zx;
  b.q += z * b.zq;
  b.qp += z * b.zq;
  b.yv += z * b.zyv;
  b.yvp += z * b.zyv;
  b.g += 2 * z * n;
  b.gp += 2 * z * n;
  b.bx += z * m2;
  b.bxp += z * m2;
  b.fb += z * m2;
  b.sv += z * m2;
  b.sc += z * S_LEN;
  return b;
}

// The buffers of this block's frame (blockIdx.z) of a streaming launch;
// block_partials places the partials by blockIdx.z itself.
__device__ __forceinline__ DB instance_of(const DB& b) {
  return frame_at(b, blockIdx.z);
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

// Row-major planes as the stencils read them: a plane in device memory
// (Glob) or a window of rows [r0, ...) of one in shared memory (Win, the
// grid-resident chunk's); at(i, j) is element (i, j) of the whole plane.
struct Glob {
  const float* a;
  int w;
  __device__ __forceinline__ float at(int i, int j) const {
    return a[(size_t)i * w + j];
  }
};

struct Win {
  float* a;
  int r0, w;
  __device__ __forceinline__ float& at(int i, int j) const {
    return a[(i - r0) * w + j];
  }
};

// (B u)(i, j) = sum_d w_d u(i - dx_d, j - dy_d) on the yv grid, u an x
// plane read as zero outside the image and beyond its local rows.
template <typename P, typename T>
__device__ __forceinline__ float conv_fwd(const P& u, const DB& b,
                                          const RowCtx& r, int i, int j,
                                          const T& t) {
  TreeSum s;
#pragma unroll
  for (int k = 0; k < t.n; ++k) {
    int a = i - t.dx[k], c = j - t.dy[k];
    float v = (a >= 0 && image_row(r, a, b.nx) && c >= 0 && c < b.ny)
                  ? u.at(a, c)
                  : 0.f;
    s.add(t.w[k] * v);
  }
  return s.total();
}

// (B^T v)(i, j) = sum_d w_d v(i + dx_d, j + dy_d) at an image pixel (i, j);
// on the whole plane every read lies inside v, on a halo band a read below
// its last local row is zero.
template <typename P, typename T>
__device__ __forceinline__ float conv_adj(const P& v, const DB& b, int i,
                                          int j, const T& t) {
  TreeSum s;
#pragma unroll
  for (int k = 0; k < t.n; ++k) {
    int a = i + t.dx[k];
    s.add(t.w[k] * (a < b.nx2 ? v.at(a, j + t.dy[k]) : 0.f));
  }
  return s.total();
}

// K^T y at an image pixel (i, j): B^T yv plus the masked gradient adjoint
// (_grad_ops' dxt, dyt), summed in the JAX package's order.
template <typename P, typename Q, typename T>
__device__ __forceinline__ float kty_at(const P& yv, const Q& qx,
                                        const Q& qy, const DB& b,
                                        const RowCtx& r, int i, int j,
                                        const T& t) {
  float dxt = (has_above(r, i) ? qx.at(i - 1, j) : 0.f)
              - (has_below(r, i, b.nx) ? qx.at(i, j) : 0.f);
  float dyt = (j > 0 ? qy.at(i, j - 1) : 0.f)
              - (j < b.ny - 1 ? qy.at(i, j) : 0.f);
  return (conv_adj(yv, b, i, j, t) + dxt) + dyt;
}

// The x-grid planes of a launch in device memory: x and q_x, q_y.
__device__ __forceinline__ Glob xplane(const float* a, const DB& b) {
  return Glob{a, b.ny};
}

__device__ __forceinline__ Glob yplane(const float* a, const DB& b) {
  return Glob{a, b.ny2};
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
  b.bx[(size_t)i * b.ny2 + j] = conv_fwd(xplane(b.x, b), b, r, i, j, t);
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
  size_t n = (size_t)b.nx * b.ny;
  float kty = kty_at(yplane(b.yv, b), xplane(b.q, b), xplane(b.q + n, b), b,
                     r, i, j, t);
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
  float bx2 = conv_fwd(xplane(b.x, b), b, r, i, j, t);
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

// The four terms of the preconditioned residual norms at pixel (i, j) of
// an owned row of the yv grid (_chunk_core after the aligned iteration):
// those of |pd|^2, |z_hat|^2 (the yv plane, and inside the image the q
// planes), and inside the image |dd|^2 and |w_hat|^2, K^T of the current
// and previous duals recomputed.  CARRIED: B x, B x_prev, grad x and
// grad x_prev read from the carried planes; else recomputed from x and
// x_prev by the same expressions, which gives the same bits.
template <bool CARRIED, typename T>
__device__ __forceinline__ void norm_terms(const DB& b, const RowCtx& r,
                                           int i, int j, const T& t,
                                           float v[4]) {
  float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
  float theta = b.sc[S_THETA];
  float tp = 1.f + theta;
  size_t p2 = (size_t)i * b.ny2 + j;
  float sqrt_sv = sqrtf(b.sv[p2]);
  float inv_v = 1.f / (sigma_raw * sqrt_sv);
  float bx2, bxp;
  if constexpr (CARRIED) {
    bx2 = b.bx[p2];
    bxp = b.bxp[p2];
  } else {
    bx2 = conv_fwd(xplane(b.x, b), b, r, i, j, t);
    bxp = conv_fwd(xplane(b.xp, b), b, r, i, j, t);
  }
  float zv = (b.yvp[p2] - b.yv[p2]) * inv_v
             + sqrt_sv * (tp * bx2 - theta * bxp);
  float pdv = zv - sqrt_sv * bx2;
  v[0] = pdv * pdv;
  v[1] = zv * zv;
  if (image_row(r, i, b.nx) && j < b.ny) {
    size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
    float inv_q = 1.f / (sigma_raw * b.sqrt_q);
    float inv_t = 1.f / (tau_raw * b.sqrt_t);
    float gx2, gy2, gpx, gpy;
    if constexpr (CARRIED) {
      gx2 = b.g[p];
      gy2 = b.g[n + p];
      gpx = b.gp[p];
      gpy = b.gp[n + p];
    } else {
      bool below = has_below(r, i, b.nx), right = j < b.ny - 1;
      float xv = b.x[p], xpv = b.xp[p];
      gx2 = below ? b.x[p + b.ny] - xv : 0.f;
      gy2 = right ? b.x[p + 1] - xv : 0.f;
      gpx = below ? b.xp[p + b.ny] - xpv : 0.f;
      gpy = right ? b.xp[p + 1] - xpv : 0.f;
    }
    float zx = (b.qp[p] - b.q[p]) * inv_q
               + b.sqrt_q * (tp * gx2 - theta * gpx);
    float zy = (b.qp[n + p] - b.q[n + p]) * inv_q
               + b.sqrt_q * (tp * gy2 - theta * gpy);
    float pdx = zx - b.sqrt_q * gx2;
    float pdy = zy - b.sqrt_q * gy2;
    float kty2 = kty_at(yplane(b.yv, b), xplane(b.q, b),
                        xplane(b.q + n, b), b, r, i, j, t);
    float ktyp = kty_at(yplane(b.yvp, b), xplane(b.qp, b),
                        xplane(b.qp + n, b), b, r, i, j, t);
    float wh = (b.xp[p] - b.x[p]) * inv_t - b.sqrt_t * ktyp;
    float dd = wh + b.sqrt_t * kty2;
    v[0] += pdx * pdx + pdy * pdy;
    v[1] += zx * zx + zy * zy;
    v[2] = dd * dd;
    v[3] = wh * wh;
  }
}

// First pass of the four preconditioned residual norms: per pixel of the
// owned rows of the yv grid the terms (norm_terms, from the carried
// products), then per-block tree sums into partial[4 * block].
// Bound: memory, once per chunk.
__global__ void deblur_norm_partial(DB b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  __shared__ Taps t;
  stage_taps(b.taps, b.ntaps, t);
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx r = deblur_rows(b);
  if (pixel(b.nx2, b.ny2, i, j) && owned_row(r, i))
    norm_terms<true>(b, r, i, j, t, v);
  block_partials(v, b.partial);
}

// ---------------------------------------------------------------------------
// The grid-resident chunk (deblur_resident): one cooperative launch runs
// what chunk() runs in 2 count + 3 launches, for the whole plane and for a
// halo band alike (the row context of deblur_rows).
//
// What bounds it.  At config 2's shape (512x512, 7 taps, ri 10) the
// streaming sequence passes over the planes in device memory 2 count + 3
// times and pays a launch and a tail for each pass; the state of the chunk
// (x, yv, q, bx, g, fb, sv: about 10 MB) fits in the shared memory of the
// card's SMs, so a half-step can read it on chip.
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// band_of(nx2, b, G) of the yv grid (and the same rows of the x grid) and
// holds them in shared memory (DBRes) from the load to the norms: x with
// the blur's row reach R above and 1 row below, q_x with 1 row above, yv
// with R rows below, and the band's rows of q_y, g, wh, bx, fb and sv.
// Each half-step updates the band in shared memory and writes the planes it
// changed to their device buffers (x after the primal step; yv and q_x
// after the dual step; q_y on the aligned iteration): those buffers are the
// exchange.  After a grid barrier every block copies in the neighbours'
// rows its next half-step reads.  The taps are staged once.  The aligned
// iteration writes x_prev, yv_prev and q_prev to their buffers and keeps
// what the norms need: its primal step's K^T y of the previous duals in
// wh, its dual step's terms of |pd|^2 and |z_hat|^2 in `terms`; after the
// last exchange K^T y of the new duals completes |dd|^2 and |w_hat|^2.
// The per-pixel expressions are deblur_seed's, deblur_primal's,
// deblur_dual's and deblur_norm_partial's (the same stencil functions on
// shared-memory windows), the norms reduce through the same tiles and
// finish (coop_tile_partials, finish_block): the launch is bit-equal to
// the streaming sequence in the planes and the norms.  Barriers: one after
// the load (no block writes a plane another still loads), two an
// iteration, one before the tiles and one before the finish.
// ---------------------------------------------------------------------------

struct DBRes {
  Win x, qx, qy, gx, gy, wh;  // ny wide
  Win yv, bx, fb, sv;          // ny2 wide
};

// Floats of DBRes for bands of at most rmax rows, blur row reach R.
__host__ __device__ __forceinline__ size_t deblur_resident_floats(
    int rmax, int R, int ny, int ny2) {
  return (size_t)(6 * rmax + R + 2) * ny + (size_t)(4 * rmax + R) * ny2;
}

__device__ __forceinline__ Win take(float*& p, int r0, int rows, int w) {
  Win v{p, r0, w};
  p += (size_t)rows * w;
  return v;
}

__device__ __forceinline__ DBRes deblur_layout(float* smem, int lo, int rmax,
                                               int R, int ny, int ny2) {
  DBRes w;
  float* p = smem;
  w.x = take(p, lo - R, rmax + R + 1, ny);
  w.qx = take(p, lo - 1, rmax + 1, ny);
  w.qy = take(p, lo, rmax, ny);
  w.gx = take(p, lo, rmax, ny);
  w.gy = take(p, lo, rmax, ny);
  w.wh = take(p, lo, rmax, ny);
  w.yv = take(p, lo, rmax + R, ny2);
  w.bx = take(p, lo, rmax, ny2);
  w.fb = take(p, lo, rmax, ny2);
  w.sv = take(p, lo, rmax, ny2);
  return w;
}

// Rows [a, e) of the (n, w) device plane `src` that exist into window
// `dst` (its own rows in [0, n)).
__device__ __forceinline__ void load_rows(const Win& dst, const float* src,
                                          int a, int e, int n) {
  a = a < 0 ? 0 : a;
  e = e > n ? n : e;
  const int cnt = (e - a) * dst.w;
  for (int k = threadIdx.x; k < cnt; k += RES_THREADS) {
    int i = a + k / dst.w, j = k % dst.w;
    dst.at(i, j) = src[(size_t)i * dst.w + j];
  }
}

// The body of deblur_resident with the taps `t` (staged in shared memory,
// or in registers for a count known when compiling).
template <typename T>
__device__ __forceinline__ void deblur_resident_body(const DB& b, int count,
                                                     int reach, int rmax,
                                                     const T& t,
                                                     float* smem) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int nx = b.nx, ny = b.ny, nx2 = b.nx2, ny2 = b.ny2;
  const size_t n = (size_t)nx * ny, m2 = (size_t)nx2 * ny2;
  const RowCtx r = deblur_rows(b);
  int lo, hi;
  band_of(nx2, blockIdx.x, gridDim.x, lo, hi);
  const DBRes w = deblur_layout(smem, lo, rmax, reach, ny, ny2);
  const int xhi = hi < nx ? hi : nx;  // the band's rows of the x grid
  const int nyv = (hi - lo) * ny2, nxv = xhi > lo ? (xhi - lo) * ny : 0;

  load_rows(w.x, b.x, lo - reach, hi + 1, nx);
  load_rows(w.qx, b.q, lo - 1, hi, nx);
  load_rows(w.qy, b.q + n, lo, hi, nx);
  load_rows(w.yv, b.yv, lo, hi + reach, nx2);
  load_rows(w.fb, b.fb, lo, hi, nx2);
  load_rows(w.sv, b.sv, lo, hi, nx2);
  __syncthreads();
  for (int k = threadIdx.x, i = lo + k / ny2, j = k % ny2; k < nyv;
       k += RES_THREADS, next_pixel(i, j, ny2)) {  // deblur_seed
    w.bx.at(i, j) = conv_fwd(w.x, b, r, i, j, t);
    if (image_row(r, i, nx) && j < ny) {
      float xv = w.x.at(i, j);
      w.gx.at(i, j) = has_below(r, i, nx) ? w.x.at(i + 1, j) - xv : 0.f;
      w.gy.at(i, j) = j < ny - 1 ? w.x.at(i, j + 1) - xv : 0.f;
    }
  }
  grid.sync();

  // the launch's scalars and the constants the pixel loops share, each
  // the same expression of them as in the streaming kernels
  const float tau_raw = b.sc[S_TAU], sigma = b.sc[S_SIGMA];
  const float theta = b.sc[S_THETA], radius = b.sc[S_RADIUS];
  const float tau_s = tau_raw * b.tau_t;  // tau * Tau
  const float inv_t = 1.f / (tau_raw * b.sqrt_t);
  const float tp = 1.f + theta;
  const float inv_l = 1.f / b.sc[S_LMB];
  const float sq = sigma * b.sig_q;  // sigma * Sigma_q
  const float sig_p = sq * tp, sig_t = sq * theta;
  const float inv_q = 1.f / (sigma * b.sqrt_q);
  for (int it = 0; it < count; ++it) {
    const bool last = it == count - 1;
    // deblur_primal on the band's rows of the x grid
    for (int k = threadIdx.x, i = lo + k / ny, j = k % ny; k < nxv;
         k += RES_THREADS, next_pixel(i, j, ny)) {
      size_t p = (size_t)i * ny + j;
      float xv = w.x.at(i, j);
      if (!image_row(r, i, nx)) {  // a band's row beyond the image stays
        if (last) b.xp[p] = xv;
        continue;
      }
      float kty = kty_at(w.yv, w.qx, w.qy, b, r, i, j, t);
      float xn = xv - tau_s * kty;
      if (last) {
        b.xp[p] = xv;
        w.wh.at(i, j) = (xv - xn) * inv_t - b.sqrt_t * kty;
      }
      w.x.at(i, j) = xn;
      b.x[p] = xn;
    }
    grid.sync();
    load_rows(w.x, b.x, lo - reach, lo, nx);
    load_rows(w.x, b.x, hi, hi + 1, nx);
    __syncthreads();
    // deblur_dual on the band's rows of the yv grid
    for (int k = threadIdx.x, i = lo + k / ny2, j = k % ny2; k < nyv;
         k += RES_THREADS, next_pixel(i, j, ny2)) {
      size_t p2 = (size_t)i * ny2 + j;
      float bx2 = conv_fwd(w.x, b, r, i, j, t);
      float svv = w.sv.at(i, j);
      float tsv = sigma * svv;  // sigma * Sigma_v
      float den = 1.f / (1.f + tsv * inv_l);
      float sh = tsv * w.fb.at(i, j);
      float yvv = w.yv.at(i, j), bxv = w.bx.at(i, j);
      float av = yvv + tsv * (tp * bx2 - theta * bxv);
      float yvn = (av - sh) * den;
      w.yv.at(i, j) = yvn;
      w.bx.at(i, j) = bx2;
      b.yv[p2] = yvn;
      const bool own = last && owned_row(r, i);
      float v0 = 0.f, v1 = 0.f;
      if (last) b.yvp[p2] = yvv;
      if (own) {  // deblur_norm_partial's terms of the yv plane
        float sqrt_sv = sqrtf(svv);
        float inv_v = 1.f / (sigma * sqrt_sv);
        float zv = (yvv - yvn) * inv_v + sqrt_sv * (tp * bx2 - theta * bxv);
        float pdv = zv - sqrt_sv * bx2;
        v0 = pdv * pdv;
        v1 = zv * zv;
      }
      if (i < nx && j < ny) {
        size_t p = (size_t)i * ny + j;
        float qx = w.qx.at(i, j), qy = w.qy.at(i, j);
        if (!image_row(r, i, nx)) {  // a band's row beyond the image stays
          if (last) {
            b.qp[p] = qx;
            b.qp[n + p] = qy;
          }
        } else {
          float xv = w.x.at(i, j);
          float gx2 = has_below(r, i, nx) ? w.x.at(i + 1, j) - xv : 0.f;
          float gy2 = j < ny - 1 ? w.x.at(i, j + 1) - xv : 0.f;
          float gx = w.gx.at(i, j), gy = w.gy.at(i, j);
          float ax = (qx + sig_p * gx2) - sig_t * gx;
          float ay = (qy + sig_p * gy2) - sig_t * gy;
          float nn = ax * ax + ay * ay;
          float scale = nn > 0.f ? fminf(1.f, radius * rsqrtf(nn)) : 1.f;
          float qxn = ax * scale, qyn = ay * scale;
          w.qx.at(i, j) = qxn;
          w.qy.at(i, j) = qyn;
          w.gx.at(i, j) = gx2;
          w.gy.at(i, j) = gy2;
          b.q[p] = qxn;
          if (last) {
            b.q[n + p] = qyn;
            b.qp[p] = qx;
            b.qp[n + p] = qy;
          }
          if (own) {  // deblur_norm_partial's terms of the q planes
            float zx = (qx - qxn) * inv_q
                       + b.sqrt_q * (tp * gx2 - theta * gx);
            float zy = (qy - qyn) * inv_q
                       + b.sqrt_q * (tp * gy2 - theta * gy);
            float pdx = zx - b.sqrt_q * gx2;
            float pdy = zy - b.sqrt_q * gy2;
            v0 += pdx * pdx + pdy * pdy;
            v1 += zx * zx + zy * zy;
          }
        }
      }
      if (last) {
        b.terms[p2] = v0;
        b.terms[m2 + p2] = v1;
      }
    }
    grid.sync();
    load_rows(w.yv, b.yv, hi, hi + reach, nx2);
    load_rows(w.qx, b.q, lo - 1, lo, nx);
    __syncthreads();
  }

  // |dd|^2 and |w_hat|^2: K^T y of the new duals at the image's pixels
  for (int k = threadIdx.x, i = lo + k / ny2, j = k % ny2; k < nyv;
       k += RES_THREADS, next_pixel(i, j, ny2)) {
    size_t p2 = (size_t)i * ny2 + j;
    float v2 = 0.f, v3 = 0.f;
    if (owned_row(r, i) && image_row(r, i, nx) && j < ny) {
      float kty2 = kty_at(w.yv, w.qx, w.qy, b, r, i, j, t);
      float wh = w.wh.at(i, j);
      float dd = wh + b.sqrt_t * kty2;
      v2 = dd * dd;
      v3 = wh * wh;
    }
    b.terms[2 * m2 + p2] = v2;
    b.terms[3 * m2 + p2] = v3;
  }
  grid.sync();
  coop_tile_partials(b.terms, nx2, ny2, b.partial, smem);
  grid.sync();
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    dim3 g = grid_of(nx2, ny2);
    finish_block(reinterpret_cast<float(*)[FIN]>(smem), b.sc, b.partial,
                 (int)(g.x * g.y), count, 0, STEP_NONE, none);
  }
}

// N > 0: a launch of N taps, held in registers; N = 0: any count, read
// from shared memory.
template <int N>
__global__ void __launch_bounds__(RES_THREADS, 1)
    deblur_resident(DB b, int count, int reach, int rmax) {
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  __shared__ Taps ts;
  stage_taps(b.taps, b.ntaps, ts);
  if constexpr (N > 0) {
    const TapsN<N> t = taps_in_registers<N>(ts);
    deblur_resident_body(b, count, reach, rmax, t, smem);
  } else {
    deblur_resident_body(b, count, reach, rmax, ts, smem);
  }
}

// The resident kernel for `ntaps` taps: the taps in registers up to
// RES_REG_TAPS, else read from shared memory.
constexpr int RES_REG_TAPS = 8;
using DBResKernel = void (*)(DB, int, int, int);

DBResKernel deblur_resident_kernel(int ntaps) {
  switch (ntaps) {
    case 1: return deblur_resident<1>;
    case 2: return deblur_resident<2>;
    case 3: return deblur_resident<3>;
    case 4: return deblur_resident<4>;
    case 5: return deblur_resident<5>;
    case 6: return deblur_resident<6>;
    case 7: return deblur_resident<7>;
    case RES_REG_TAPS: return deblur_resident<RES_REG_TAPS>;
    default: return deblur_resident<0>;
  }
}

// The frames of a batched launch, G at a time (the body of
// deblur_resident_batched<N, G>): thread group threadIdx.y of every block
// runs the g-th frame of each set of G whose flags are clear, as
// deblur_resident runs it alone, in its own `smem` and its own 4 planes
// of `terms`; the groups meet at the same barriers.  An odd frame out
// runs in every group, which write the same values to the same places.
template <int G, typename T>
__device__ __forceinline__ void deblur_frames(const DB& b, int count,
                                              int reach, int rmax, int batch,
                                              const T& t, float* smem) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const dim3 g = grid_of(b.nx2, b.ny2);
  const size_t tiles = (size_t)g.x * g.y;
  const size_t m2 = (size_t)b.nx2 * b.ny2;
  bool first = true;
  int set[G];
  int have = 0;
  for (int z = 0; z <= batch; ++z) {
    if (z < batch) {
      if (b.sc[(size_t)z * S_LEN + S_CONV] != 0.f) continue;
      set[have++] = z;
      if (have < G) continue;
    } else if (have == 0) {
      break;
    }
    const int f = set[(int)threadIdx.y < have ? threadIdx.y : 0];
    DB bz = frame_at(b, f);
    bz.partial += (size_t)f * 4 * tiles;
    bz.terms += (size_t)threadIdx.y * 4 * m2;
    if (!first) grid.sync();
    first = false;
    deblur_resident_body(bz, count, reach, rmax, t, smem);
    have = 0;
  }
}

// The batched chunk (deblur_fused_chunk_batched) grid-resident: the frames
// G at a time, each as deblur_resident runs it alone, so each keeps its
// planes in shared memory for its whole chunk (the streaming batched
// sequence passes over all B frames' planes each half-step, about 140 MB
// an iteration at B = 8 of 512x512, beyond the L2).  G = 1: one frame
// after another; G = 2: two frames side by side in a block of two thread
// groups of RES_THREADS, each with `half` floats of the shared memory
// (where two frames' bands fit: half the grid barriers a frame, 32 warps
// an SM to hide the convolutions' latency, at most 64 registers a
// thread).  The taps are staged once a launch.  Every block reads frame
// z's flag before any barrier of z (no chunk writes a flag, so all read
// the same value) and skips a flagged frame whole.  Frame z's norm
// partials lie at z times one frame's tiles; the terms planes are reused,
// written by a set's last iteration only after every block has passed
// the previous set's tiles.  A grid barrier between sets keeps block 0's
// finish of the one off the shared memory the next one loads into.
template <int N, int G>
__global__ void __launch_bounds__(G * RES_THREADS, 1)
    deblur_resident_batched(DB b, int count, int reach, int rmax, int batch,
                            int half) {
  extern __shared__ float smem[];
  __shared__ Taps ts;
  stage_taps(b.taps, b.ntaps, ts);
  float* mine = smem + (size_t)threadIdx.y * half;
  if constexpr (N > 0) {
    const TapsN<N> t = taps_in_registers<N>(ts);
    deblur_frames<G>(b, count, reach, rmax, batch, t, mine);
  } else {
    deblur_frames<G>(b, count, reach, rmax, batch, ts, mine);
  }
}

using DBResBatchedKernel = void (*)(DB, int, int, int, int, int);

template <int G>
DBResBatchedKernel deblur_resident_batched_kernel(int ntaps) {
  switch (ntaps) {
    case 1: return deblur_resident_batched<1, G>;
    case 2: return deblur_resident_batched<2, G>;
    case 3: return deblur_resident_batched<3, G>;
    case 4: return deblur_resident_batched<4, G>;
    case 5: return deblur_resident_batched<5, G>;
    case 6: return deblur_resident_batched<6, G>;
    case 7: return deblur_resident_batched<7, G>;
    case RES_REG_TAPS: return deblur_resident_batched<RES_REG_TAPS, G>;
    default: return deblur_resident_batched<0, G>;
  }
}

// The batched kernel for `ntaps` taps and `groups` (1 or 2) frames a
// block.
DBResBatchedKernel deblur_resident_batched_kernel(int ntaps, int groups) {
  return groups == 2 ? deblur_resident_batched_kernel<2>(ntaps)
                     : deblur_resident_batched_kernel<1>(ntaps);
}

// The dynamic shared memory of a resident launch on a yv grid of nx2 rows
// with `groups` frames a block: DBRes for the largest band, at least the
// reductions' array (`half` floats), for each group; or 0 where `kernel`
// may not hold it on the current device (then `rc` holds the error).
template <typename K>
size_t resident_smem(K kernel, int nx2, int ny, int ny2, int reach,
                     int groups, int& rmax, int& half, int& rc) {
  int sms = 0;
  rc = device_sms(&sms);
  if (rc) return 0;
  rmax = band_rows(nx2, sms);
  size_t one = deblur_resident_floats(rmax, reach, ny, ny2) * sizeof(float);
  if (one < (size_t)RES_RED_BYTES) one = RES_RED_BYTES;
  half = (int)(one / sizeof(float));
  size_t smem = groups * one;
  int limit = resident_smem_limit(kernel);
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

// ---------------------------------------------------------------------------
// The tiled chunk (deblur_fused_chunk_banded -> _deblur_banded_kernel,
// _deblur_banded_db_kernel), for the planes whose bands no grid-resident
// launch holds (config 2 at 2048x2048, and the sharded route's band at
// 2048 rows and above).  The TPU kernel runs one launch a chunk over row
// bands of the yv grid, each band's window with (2 count + 2) reach rows
// of halo DMAed into VMEM and the whole chunk run there.
//
// What bounds it.  An iteration moves information by the blur's reach
// twice (K^T y, then B x), so a window that holds a whole chunk is several
// times its tile (176 rows of halo at ri 10); one iteration needs only
// reach + 1 pixels around a tile.  So each iteration is one pass over
// device memory: x, q_x, q_y (n floats each) and yv (m2) read through the
// windows' overlap, f_b and Sigma_v read at the owned pixels, the four
// state planes written, about 10 plane passes (16.8 MB each at
// 2048x2048): some 0.05 ms at the card's memory rate, where the streaming
// sequence moves about 17 passes in two launches.  Inside the window the
// half-steps are stencils over shared memory: K^T y on the window less a
// border, two convolutions (B x of the new and of the old x) at each owned
// pixel.  On an H100 an iteration at 2048x2048 takes about twice the time
// of its pass at the memory rate (PERF.md, row 19): the window's loads run
// under the stencils, the dual step's stores and convolutions do not.
//
// Design.  One cooperative launch a chunk, one block of tiled_threads on
// each SM, a grid barrier between iterations: iteration t reads slot t
// mod 2 (slot A the caller's x, yv and q, slot B 4 planes of scratch) and
// writes the other, each slot's pointers picked by the iteration's parity
// from the two parameter structs' fields (never a reference chosen at run
// time).  The blocks walk the yv grid's tiles (tx rows, a multiple of 8,
// by ty columns, of 32; the x grid's pixels are owned with the yv grid's
// at the same place), each tile-row's columns rotated by its row so that
// a block's tiles change column from round to round (where the columns
// divide the grid, a block otherwise takes one column's tiles in every
// round, and the blocks of the edge columns, every edge window, set the
// barrier's pace); a tile's window is the tile and h = reach + 1 pixels on
// every side (reach = the taps' largest row or column shift, at least 1;
// ops/fused_deblur.py deblur_tiled_halo: the primal step reads q one pixel
// up and left and yv up to reach pixels down and right, the dual step
// x_new up to reach pixels up and left and one down and right).  Shared
// memory holds x after the primal step and two sets of the window's x,
// q_x, q_y and yv: the next window's cp.async loads (zero outside the
// planes) run under the current window's stencils; where two sets do not
// fit, one, loaded after the stencils.  Each stage is a flat walk of its
// region's pixels by the block's threads:
//   1. the primal step (deblur_primal's) into the x-after plane on the
//      rows [R0 - reach, R1] and columns [C0 - reach, C1] of the tile
//      [R0, R1) x [C0, C1);
//   2. the dual step (deblur_dual's) at the owned pixels into the other
//      slot: B x and grad x of the old x, which the streaming sequence
//      carries in planes, recomputed from the window by the same
//      expressions, which give the same bits; f_b and Sigma_v of a
//      thread's next pixel loaded under its current one; on the chunk's
//      last iteration the old x, yv and q also into the caller's
//      previous-iterate planes.
// A window whose stencils can reach no edge of the image or of the planes
// (its rows within the image's and the x plane's, its columns within the
// image's) runs the stencils with no test, at window offsets dx W + dy of
// its taps (conv_in, kty_in); the others test every read by the pixel's
// place in the planes (the row context of deblur_rows, as the streaming
// kernels decide it; conv_edge, kty_edge), a read outside the planes
// being the zero the load put there.  The taps are a kernel parameter
// (TapsP, with the interior offsets formed by the host), read from the
// constant bank, so no register holds them; their products go through
// TreeSum's pairwise tree (tap_tree), the count known when compiling up
// to 7 taps.  The row context and the scalars sit in shared memory, so
// that no register holds them from one window to the next.
//   The norms.  The last iteration makes what deblur_norm_partial makes
// from the carried planes: at the owned pixels the dual step has B x of
// the new and the old x, their gradients and the old and new duals, so it
// puts the terms of |pd|^2 and |z_hat|^2, in norm_terms' order of the
// sums, in place of the pixel's yv and q_x in the window, and the block
// reduces them over the owned 32x8 tiles; the primal step has K^T of the
// old duals, so it writes w_hat (a plane of the x grid after slot B).
// After the last grid barrier the blocks add K^T of the new duals for
// |dd|^2 and w_hat's for |w_hat|^2 over deblur_norm_partial's 32x8 tiles,
// a warp to a tile (block_partials' tree as a column's sums and shuffles),
// and copy slot B back into the caller's planes after an odd count as
// they read it; pdhg_finish follows.  Planes and norms are the streaming
// sequence's bit for bit.  A launch whose flag is set at entry returns
// before its first barrier.
// ---------------------------------------------------------------------------

// The threads of a block of deblur_tiled<N>: 24 warps of 80 registers
// for a tap count known when compiling, 20 of 96 for one known only at
// run time (whose loops over up to MAX_TAPS taps hold more).
__host__ __device__ constexpr int tiled_threads(int n) {
  return n > 0 ? 768 : 640;
}

// The tap count deblur_tiled is instantiated for: `ntaps` up to
// TILED_KNOWN_TAPS, else 0 (known at run time).
constexpr int TILED_KNOWN_TAPS = 7;

__host__ __device__ constexpr int tiled_n(int ntaps) {
  return ntaps <= TILED_KNOWN_TAPS ? ntaps : 0;
}

template <int N>
constexpr int DT_THREADS = tiled_threads(N);

// the window's planes: x after the primal step, and two sets of x, yv,
// q_x and q_y (the next window's loaded under this one's stencils), or
// one set where two do not fit
constexpr int DT_PLANES_TWO = 9, DT_PLANES_ONE = 5;

// The dynamic shared memory of a block of the tiled launch with one or two
// sets of the window's planes.
inline size_t deblur_tiled_smem(int tx, int ty, int h, bool two) {
  return (size_t)(two ? DT_PLANES_TWO : DT_PLANES_ONE)
         * (tx + 2 * (size_t)h) * (ty + 2 * (size_t)h) * sizeof(float);
}

// The dynamic shared memory the tiled launch takes for a tile of tx x ty
// and a halo of h on a device whose blocks may hold `limit` bytes: two
// sets where they fit, else one (mirrored by ops/fused_deblur.py
// deblur_tiled_bytes).
inline size_t deblur_tiled_bytes(int tx, int ty, int h, int limit) {
  const size_t two = deblur_tiled_smem(tx, ty, h, true);
  return two <= (size_t)limit ? two : deblur_tiled_smem(tx, ty, h, false);
}

// The taps of a tiled launch, passed as a kernel parameter (1540 bytes):
// the stencils' warp-uniform reads of them come from the constant bank
// and no register holds them.  o[k] = dx[k] W + dy[k], the offset of tap k
// in an interior window of row stride W = ty + 2 h.
struct TapsP {
  int n;
  int dx[MAX_TAPS];
  int dy[MAX_TAPS];
  float w[MAX_TAPS];
  int o[MAX_TAPS];
};

// The taps of deblur_tiled<N> as its stencils read them: N of 1 to
// TILED_KNOWN_TAPS taps, a count known when compiling, or N = 0: the
// launch's count, at most MAX_TAPS.
template <int N>
struct TapsK {
  static constexpr int MAXN = N > 0 ? N : MAX_TAPS;
  const TapsP& p;
  __device__ __forceinline__ int n() const { return N > 0 ? N : p.n; }
};

// TreeSum of term(0), ..., term(t.n() - 1) with the levels in registers for
// a count known when compiling (for one known only at run time the
// loop's exit leaves the levels in a 32-byte frame): the k-th term
// carries up by the bits of k, known when compiling in the unrolled loop,
// and the total adds the levels of the count's bits from the smallest up
// (TreeSum's mask after t.n() terms).
template <typename T, typename F>
__device__ __forceinline__ float tap_tree(const T& t, F term) {
  float lev[TREE_LEVELS];
#pragma unroll
  for (int k = 0; k < T::MAXN; ++k) {
    if (k >= t.n()) break;
    float v = term(k);
#pragma unroll
    for (int l = 0; l < TREE_LEVELS; ++l) {
      if (!(k & (1 << l))) {
        lev[l] = v;
        break;
      }
      v = lev[l] + v;
    }
  }
  float acc = 0.f;
  bool have = false;
#pragma unroll
  for (int l = 0; l < TREE_LEVELS; ++l) {
    if (t.n() & (1 << l)) {
      acc = have ? lev[l] + acc : lev[l];
      have = true;
    }
  }
  return acc;
}

// conv_fwd at window index p of an interior window: every read exists.
template <typename T>
__device__ __forceinline__ float conv_in(const float* u, int p, const T& t) {
  return tap_tree(t, [&](int k) { return t.p.w[k] * u[p - t.p.o[k]]; });
}

// kty_at at window index p (row stride W) of an interior window.
template <typename T>
__device__ __forceinline__ float kty_in(const float* yv, const float* qx,
                                        const float* qy, int p, int W,
                                        const T& t) {
  const float dxt = qx[p - W] - qx[p];
  const float dyt = qy[p - 1] - qy[p];
  return (tap_tree(t, [&](int k) { return t.p.w[k] * yv[p + t.p.o[k]]; })
          + dxt) + dyt;
}

// A window of the plane in shared memory with corner (r0, c0) and row
// stride W, read at pixel (i, j) of the whole plane.
struct TWin {
  const float* a;
  int r0, c0, w;
  __device__ __forceinline__ float at(int i, int j) const {
    return a[(i - r0) * w + (j - c0)];
  }
};

// conv_fwd at pixel (i, j) of the yv grid from a window of an x plane,
// every read tested as conv_fwd tests it.
template <typename T>
__device__ __forceinline__ float conv_edge(const TWin& u, const RowCtx& r,
                                           int nx, int ny, int i, int j,
                                           const T& t) {
  return tap_tree(t, [&](int k) {
    const int a = i - t.p.dx[k], c = j - t.p.dy[k];
    const float v = (a >= 0 && image_row(r, a, nx) && c >= 0 && c < ny)
                        ? u.at(a, c)
                        : 0.f;
    return t.p.w[k] * v;
  });
}

// kty_at at an image pixel (i, j) from windows of yv, q_x and q_y or from
// the planes themselves (P: TWin or Glob), every read tested as kty_at
// tests it.
template <typename P, typename T>
__device__ __forceinline__ float kty_edge(const P& yv, const P& qx,
                                          const P& qy, const RowCtx& r,
                                          int nx, int ny, int nx2, int i,
                                          int j, const T& t) {
  const float dxt = (has_above(r, i) ? qx.at(i - 1, j) : 0.f)
                    - (has_below(r, i, nx) ? qx.at(i, j) : 0.f);
  const float dyt = (j > 0 ? qy.at(i, j - 1) : 0.f)
                    - (j < ny - 1 ? qy.at(i, j) : 0.f);
  const float s = tap_tree(t, [&](int k) {
    const int a = i + t.p.dx[k];
    return t.p.w[k] * (a < nx2 ? yv.at(a, j + t.p.dy[k]) : 0.f);
  });
  return (s + dxt) + dyt;
}

// The scalars of a launch as the streaming kernels form them.
struct TiledScal {
  float tau_s, sigma, theta, tp, inv_l, sig_p, sig_t, radius, inv_t, inv_q;
};

__device__ __forceinline__ TiledScal tiled_scal(const DB& b) {
  TiledScal k;
  const float tau_raw = b.sc[S_TAU];
  k.tau_s = tau_raw * b.tau_t;  // tau * Tau
  k.sigma = b.sc[S_SIGMA];
  k.theta = b.sc[S_THETA];
  k.tp = 1.f + k.theta;
  k.inv_l = 1.f / b.sc[S_LMB];
  const float sq = k.sigma * b.sig_q;  // sigma * Sigma_q
  k.sig_p = sq * k.tp;
  k.sig_t = sq * k.theta;
  k.radius = b.sc[S_RADIUS];
  k.inv_t = 1.f / (tau_raw * b.sqrt_t);  // norm_terms'
  k.inv_q = 1.f / (k.sigma * b.sqrt_q);
  return k;
}

// The pixels [0, rows) x [0, cols) of a region walked flat by the block's
// threads, blockDim.x apart: (wi, wj) from threadIdx.x.
struct Walk {
  int wi, wj, di, dj, cols;
  __device__ __forceinline__ Walk(int c) : cols(c) {
    wi = (int)threadIdx.x / c;
    wj = (int)threadIdx.x % c;
    di = (int)blockDim.x / c;
    dj = (int)blockDim.x % c;
  }
  __device__ __forceinline__ void next() {
    wi += di;
    wj += dj;
    if (wj >= cols) {
      wj -= cols;
      ++wi;
    }
  }
};

// The window of the tile with index `tile` of the yv grid's tiles of tx x
// ty (ntc a row): its owned rows [R0, R1) and columns [C0, C1), its corner
// (r0, c0) h pixels above and left, its rows wh and row stride W; tile-row
// tr's columns rotated by tr (the design note above).
struct TGeom {
  int R0, C0, R1, C1, r0, c0, wh, W;
};

__device__ __forceinline__ TGeom tile_geom(int tile, int ntc, int tx, int ty,
                                           int h, int nx2, int ny2) {
  TGeom g;
  const int tr = tile / ntc;
  g.R0 = tr * tx;
  g.C0 = (tile % ntc + tr) % ntc * ty;
  g.R1 = min(g.R0 + tx, nx2);
  g.C1 = min(g.C0 + ty, ny2);
  g.r0 = g.R0 - h;
  g.c0 = g.C0 - h;
  g.wh = g.R1 + h - g.r0;
  g.W = g.C1 + h - g.c0;
  return g;
}

// The window lies within the image's and the x plane's rows and the
// image's columns: no stencil of it reaches an edge.
__device__ __forceinline__ bool tile_inner(const TGeom& g, const RowCtx& r,
                                           int nx, int ny, int h) {
  return g.r0 >= 0 && g.r0 + r.off >= 0 && g.R1 + h <= nx
         && g.R1 + h + r.off <= r.nxg && g.c0 >= 0 && g.C1 + h <= ny;
}

// The window g of x, q_x, q_y and yv from slot (sx, syv, sq) into the
// planes X, YV, QX, QY of `set` (M floats apart) by cp.async, zero outside
// the planes (EDGE: a window that reaches beyond them).
template <bool EDGE>
__device__ __forceinline__ void tiled_load(const TGeom& g, int nx, int ny,
                                           int nx2, int ny2,
                                           const float* __restrict__ sx,
                                           const float* __restrict__ syv,
                                           const float* __restrict__ sq,
                                           float* set, int M) {
  const int n = nx * ny;
  float* X = set;
  float* YV = set + M;
  float* QX = set + 2 * M;
  float* QY = set + 3 * M;
  for (Walk w(g.W); w.wi < g.wh; w.next()) {
    const int i = g.r0 + w.wi, j = g.c0 + w.wj, p = w.wi * g.W + w.wj;
    if (!EDGE || (i >= 0 && i < nx && j >= 0 && j < ny)) {
      const int gi = i * ny + j;
      cp_async4(X + p, sx + gi);
      cp_async4(QX + p, sq + gi);
      cp_async4(QY + p, sq + n + gi);
    } else {
      X[p] = 0.f;
      QX[p] = 0.f;
      QY[p] = 0.f;
    }
    if (!EDGE || (i >= 0 && i < nx2 && j >= 0 && j < ny2))
      cp_async4(YV + p, syv + i * ny2 + j);
    else
      YV[p] = 0.f;
  }
}

// block_partials' tree for one 32x8 tile of K of the norm terms, a warp to
// the tile: lane l sums its column's eight rows as the tree pairs them
// (rows r and r + 4, then r and r + 2, then 0 and 1; two rows at a time,
// so that few values are live), then the lanes by shuffles (16, 8, 4, 2,
// 1): the same additions in the same order as the tree's.  terms(r, v)
// puts the K terms of the lane's column in the tile's row r into v
// (zeros where it has none); lane 0 gets the sums in s.
template <int K, typename F>
__device__ __forceinline__ void warp_tile_sums(F terms, float (&s)[K]) {
  float b0[K];
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float bq[K];
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {  // rows r and r + 4, r = half + 2 q
      float v[K], w[K];
#pragma unroll
      for (int c = 0; c < K; ++c) v[c] = w[c] = 0.f;
      terms(half + 2 * q, v);
      terms(half + 2 * q + 4, w);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float sum = v[c] + w[c];
        bq[c] = q == 0 ? sum : bq[c] + sum;
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (half == 0)
        b0[c] = bq[c];
      else
        s[c] = b0[c] + bq[c];
    }
  }
#pragma unroll
  for (int o = BX / 2; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < K; ++c)
      s[c] += __shfl_down_sync(0xffffffffu, s[c], o);
}

// One iteration on the window g, its state loaded into the planes of `set`
// (X, YV, QX, QY, M floats apart), the primal step into XN: the owned
// pixels into slot (ox, oyv, oq); with `last` the old values also into the
// previous-iterate planes (a's xp, yvp, qp), w_hat into a.terms (at the x
// grid's pixels), and the terms of |pd|^2 and |z_hat|^2 in place of the
// owned pixels' yv and q_x in the window, whose 32x8 tiles then reduce
// into their partials.  EDGE: a window whose stencils can reach an edge of
// the image or of the planes, every read tested; else none.  `a` holds the
// read-only planes and the shapes.
template <bool EDGE, int N>
__device__ __forceinline__ void tiled_window(
    const DB& a, const RowCtx& r, const TiledScal& k, const TGeom& g,
    float* __restrict__ ox, float* __restrict__ oyv, float* __restrict__ oq,
    int h, bool last, const TapsK<N>& t, float* set, float* XN, int M) {
  const int nx = a.nx, ny = a.ny, nx2 = a.nx2, ny2 = a.ny2;
  const int n = nx * ny;  // below 2^30 (tiled_chunk)
  const int R0 = g.R0, C0 = g.C0, R1 = g.R1, C1 = g.C1;
  const int r0 = g.r0, c0 = g.c0, wh = g.wh, W = g.W;
  const float* X = set;
  float* YV = set + M;
  float* QX = set + 2 * M;
  const float* QY = set + 3 * M;
  float* const WH = a.terms;  // w_hat (x grid)

  // 2. deblur_primal on rows [R0 - reach, R1], columns [C0 - reach, C1]
  {
    const int pr = wh - h, pc = W - h;
    for (Walk w(pc); w.wi < pr; w.next()) {
      const int i = r0 + 1 + w.wi, j = c0 + 1 + w.wj;
      const int p = (w.wi + 1) * W + w.wj + 1;
      const float xv = X[p];
      float xn = xv;  // beyond the image x stays (and is not read)
      float kty = 0.f;
      bool image = true;
      if (EDGE) {
        image = i >= 0 && image_row(r, i, nx) && j >= 0 && j < ny;
        if (image)
          kty = kty_edge(TWin{YV, r0, c0, W}, TWin{QX, r0, c0, W},
                         TWin{QY, r0, c0, W}, r, nx, ny, nx2, i, j, t);
      } else {
        kty = kty_in(YV, QX, QY, p, W, t);
      }
      if (image) xn = xv - k.tau_s * kty;
      XN[p] = xn;
      if (last && image && i >= R0 && j >= C0 && i < R1 && j < C1)
        WH[i * ny + j] = (xv - xn) * k.inv_t - a.sqrt_t * kty;
    }
  }
  __syncthreads();

  // 3. deblur_dual at the owned pixels, into slot (ox, oyv, oq); a
  // thread's f_b and Sigma_v of its next pixel are loaded under the
  // stencils of this one
  const TWin XW{X, r0, c0, W}, XNW{XN, r0, c0, W};
  const int orows = R1 - R0;
  Walk w(C1 - C0);
  float svn = 0.f, fbn = 0.f;
  if (w.wi < orows) {
    const int g = (R0 + w.wi) * ny2 + C0 + w.wj;
    svn = __ldg(a.sv + g);
    fbn = __ldg(a.fb + g);
  }
  while (w.wi < orows) {
    const int i = R0 + w.wi, j = C0 + w.wj;
    const int p = (w.wi + h) * W + w.wj + h;
    const int p2 = i * ny2 + j;
    const float svv = svn, fbv = fbn;
    w.next();
    if (w.wi < orows) {
      const int g = (R0 + w.wi) * ny2 + C0 + w.wj;
      svn = __ldg(a.sv + g);
      fbn = __ldg(a.fb + g);
    }
    float bx2, bxv;  // B x of the new and (the carried B x) of the old x
    if (EDGE) {
      bx2 = conv_edge(XNW, r, nx, ny, i, j, t);
      bxv = conv_edge(XW, r, nx, ny, i, j, t);
    } else {
      bx2 = conv_in(XN, p, t);
      bxv = conv_in(X, p, t);
    }
    const float tsv = k.sigma * svv;  // sigma * Sigma_v
    const float den = 1.f / (1.f + tsv * k.inv_l);
    const float sh = tsv * fbv;
    const float yvv = YV[p];
    const float av = yvv + tsv * (k.tp * bx2 - k.theta * bxv);
    const float yvn = (av - sh) * den;
    oyv[p2] = yvn;
    float v0 = 0.f, v1 = 0.f;  // norm_terms' of the yv plane
    if (last) {
      a.yvp[p2] = yvv;
      const float sqrt_sv = sqrtf(svv);
      const float inv_v = 1.f / (k.sigma * sqrt_sv);
      const float zv = (yvv - yvn) * inv_v
                       + sqrt_sv * (k.tp * bx2 - k.theta * bxv);
      const float pdv = zv - sqrt_sv * bx2;
      v0 = pdv * pdv;
      v1 = zv * zv;
    }
    if (!EDGE || (i < nx && j < ny)) {
      const int p1 = i * ny + j;
      const float xo = X[p], qx = QX[p], qy = QY[p];
      if (last) {
        a.xp[p1] = xo;
        a.qp[p1] = qx;
        a.qp[n + p1] = qy;
      }
      if (EDGE && !image_row(r, i, nx)) {  // a band's row beyond the image
        ox[p1] = xo;
        oq[p1] = qx;
        oq[n + p1] = qy;
      } else {
        const float xv = XN[p];
        const bool below = !EDGE || has_below(r, i, nx);
        const bool right = !EDGE || j < ny - 1;
        const float gx2 = below ? XN[p + W] - xv : 0.f;
        const float gy2 = right ? XN[p + 1] - xv : 0.f;
        const float gx = below ? X[p + W] - xo : 0.f;  // the carried g
        const float gy = right ? X[p + 1] - xo : 0.f;
        const float ax = (qx + k.sig_p * gx2) - k.sig_t * gx;
        const float ay = (qy + k.sig_p * gy2) - k.sig_t * gy;
        const float nn = ax * ax + ay * ay;
        const float scale =
            nn > 0.f ? fminf(1.f, k.radius * rsqrtf(nn)) : 1.f;
        const float qxn = ax * scale, qyn = ay * scale;
        ox[p1] = xv;
        oq[p1] = qxn;
        oq[n + p1] = qyn;
        if (last) {  // norm_terms' of the q planes
          const float sqrt_q = a.sqrt_q;
          const float zx = (qx - qxn) * k.inv_q
                           + sqrt_q * (k.tp * gx2 - k.theta * gx);
          const float zy = (qy - qyn) * k.inv_q
                           + sqrt_q * (k.tp * gy2 - k.theta * gy);
          const float pdx = zx - sqrt_q * gx2;
          const float pdy = zy - sqrt_q * gy2;
          v0 += pdx * pdx + pdy * pdy;
          v1 += zx * zx + zy * zy;
        }
      }
    }
    if (last) {  // the pixel's yv and q_x are read
      YV[p] = v0;
      QX[p] = v1;
    }
  }
  if (!last) return;

  // deblur_norm_partial's terms of |pd|^2 and |z_hat|^2 reduced over the
  // owned 32x8 tiles (the tile is made of whole ones), a warp to a tile
  __syncthreads();  // every owned pixel's terms are in
  const int ntx = (ny2 + BX - 1) / BX, cols = (C1 - C0 + BX - 1) / BX;
  const int lane = (int)threadIdx.x % BX;
  for (int nt = (int)threadIdx.x / BX; nt < (R1 - R0 + BY - 1) / BY * cols;
       nt += (int)blockDim.x / BX) {
    const int i0 = R0 + nt / cols * BY, j0 = C0 + nt % cols * BX;
    const int j = j0 + lane;
    float sum[2];
    warp_tile_sums<2>([&](int row, float v[2]) {
      const int i = i0 + row;
      if (i < R1 && j < C1 && owned_row(r, i)) {
        const int p = (i - r0) * W + j - c0;
        v[0] = YV[p];
        v[1] = QX[p];
      }
    }, sum);
    if (lane == 0) {
      const int tile = i0 / BY * ntx + j0 / BX;
      a.partial[4 * tile] = sum[0];
      a.partial[4 * tile + 1] = sum[1];
    }
  }
}

// The body of deblur_tiled<N>: `count` iterations from slot A (a) through
// slot B (b), then deblur_norm_partial's tiles of the slot written last
// from the last iteration's terms, slot B copied back into a's planes after
// an odd count.
template <int N>
__device__ __forceinline__ void deblur_tiled_body(const DB& a, const DB& b,
                                                  int count, int h, int tx,
                                                  int ty, bool two,
                                                  const TapsK<N>& t,
                                                  float* smem) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // the row context and the scalars in shared memory, read where a stage
  // uses them: no register holds them from one window to the next
  __shared__ RowCtx r;
  __shared__ TiledScal k;
  if (threadIdx.x == 0) {
    r = deblur_rows(a);
    k = tiled_scal(a);
  }
  __syncthreads();
  const int nx = a.nx, ny = a.ny, nx2 = a.nx2, ny2 = a.ny2;
  const int ntc = (ny2 + ty - 1) / ty;
  const int ntiles = (nx2 + tx - 1) / tx * ntc;
  const int M = (tx + 2 * h) * (ty + 2 * h);  // a plane: the largest window
  for (int it = 0; it < count; ++it) {
    const bool odd = (it & 1) != 0, last = it == count - 1;
    const float* sx = odd ? b.x : a.x;
    const float* syv = odd ? b.yv : a.yv;
    const float* sq = odd ? b.q : a.q;
    float* ox = odd ? a.x : b.x;
    float* oyv = odd ? a.yv : b.yv;
    float* oq = odd ? a.q : b.q;
    // the block's first window of the iteration into set 0; then each
    // window's compute with the next one's loads in flight into the other
    // set (a window's state is read from slot src only, which no block
    // writes this iteration), or with one set after it
    auto load = [&](int tl, float* set) {
      const TGeom g = tile_geom(tl, ntc, tx, ty, h, nx2, ny2);
      if (tile_inner(g, r, nx, ny, h))
        tiled_load<false>(g, nx, ny, nx2, ny2, sx, syv, sq, set, M);
      else
        tiled_load<true>(g, nx, ny, nx2, ny2, sx, syv, sq, set, M);
    };
    int set = 0;
    if (blockIdx.x < ntiles) load(blockIdx.x, smem + M);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      cp_async_wait();
      __syncthreads();  // this window's planes are in; the last one's done
      const int next = tile + gridDim.x;
      if (two && next < ntiles) load(next, smem + M + (set ^ 1) * 4 * M);
      const TGeom g = tile_geom(tile, ntc, tx, ty, h, nx2, ny2);
      float* cur = smem + M + set * 4 * M;
      if (tile_inner(g, r, nx, ny, h))
        tiled_window<false, N>(a, r, k, g, ox, oyv, oq, h, last, t, cur,
                               smem, M);
      else
        tiled_window<true, N>(a, r, k, g, ox, oyv, oq, h, last, t, cur, smem,
                              M);
      if (two) {
        set ^= 1;
      } else if (next < ntiles) {
        __syncthreads();  // every thread is done with the set
        load(next, smem + M);
      }
    }
    grid.sync();
  }

  // the terms of |dd|^2 and |w_hat|^2 (K^T y of the new duals and the last
  // iteration's w_hat) reduced over deblur_norm_partial's 32x8 tiles of
  // the yv grid, a warp to a tile; slot B copied back as it is read after
  // an odd count
  const bool back = (count & 1) != 0;
  const float* fyv = back ? b.yv : a.yv;
  const float* fq = back ? b.q : a.q;
  const int n = nx * ny;
  const int warps = (int)blockDim.x / BX;
  const int ntx = (ny2 + BX - 1) / BX;
  const int nnorm = (nx2 + BY - 1) / BY * ntx;
  const int lane = (int)threadIdx.x % BX;
  for (int tile = blockIdx.x * warps + (int)threadIdx.x / BX; tile < nnorm;
       tile += gridDim.x * warps) {
    const int i0 = tile / ntx * BY, j = tile % ntx * BX + lane;
    float sum[2];
    warp_tile_sums<2>([&](int row, float v[2]) {
      const int i = i0 + row;
      if (i >= nx2 || j >= ny2) return;
      const int p2 = i * ny2 + j, p = i * ny + j;
      if (owned_row(r, i) && image_row(r, i, nx) && j < ny) {
        const float kty2 = kty_edge(Glob{fyv, ny2}, Glob{fq, ny},
                                    Glob{fq + n, ny}, r, nx, ny, nx2, i, j,
                                    t);
        const float wh = a.terms[p];
        const float dd = wh + a.sqrt_t * kty2;
        v[0] = dd * dd;
        v[1] = wh * wh;
      }
      if (back) {
        a.yv[p2] = b.yv[p2];
        if (i < nx && j < ny) {
          a.x[p] = b.x[p];
          a.q[p] = b.q[p];
          a.q[n + p] = b.q[n + p];
        }
      }
    }, sum);
    if (lane == 0) {
      a.partial[4 * tile + 2] = sum[0];
      a.partial[4 * tile + 3] = sum[1];
    }
  }
}

// N of 1 to TILED_KNOWN_TAPS: a launch of N taps; N = 0: any count.
template <int N>
__global__ void __launch_bounds__(DT_THREADS<N>, 1)
    deblur_tiled(DB a, DB b, TapsP tp, int count, int h, int tx, int ty,
                 int two) {
  if (a.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  deblur_tiled_body<N>(a, b, count, h, tx, ty, two != 0, TapsK<N>{tp},
                       smem);
}

using DBTiledKernel = void (*)(DB, DB, TapsP, int, int, int, int, int);

// The kernel for `ntaps` taps (deblur_tiled<tiled_n(ntaps)>).

DBTiledKernel deblur_tiled_kernel(int ntaps) {
  switch (tiled_n(ntaps)) {
    case 1: return deblur_tiled<1>;
    case 2: return deblur_tiled<2>;
    case 3: return deblur_tiled<3>;
    case 4: return deblur_tiled<4>;
    case 5: return deblur_tiled<5>;
    case 6: return deblur_tiled<6>;
    case 7: return deblur_tiled<7>;
    default: return deblur_tiled<0>;
  }
}

// One tiled chunk: the cooperative launch (one block of tiled_threads on
// each SM) and pdhg_finish; slot B's x, yv and q in `scratch` (n, m2 and 2 n
// floats), the last iteration's w_hat after them (n).  A
// tile that is not a multiple of the 32x8 norm tiles or whose window does
// not fit in a block's shared memory is refused with
// cudaErrorInvalidValue, a grid the card cannot hold at once by the card
// (cudaErrorCooperativeLaunchTooLarge).
int tiled_chunk(DB& a, void* scratch, const float* taps, int count, int h,
                int tx, int ty, cudaStream_t st) {
  if (tx < BY || tx % BY || ty < BX || ty % BX || h < 2 || count < 1
      || a.ntaps < 1 || a.ntaps > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  TapsP tp = {};
  tp.n = a.ntaps;
  for (int k = 0; k < tp.n; ++k) {
    tp.dx[k] = (int)taps[k];
    tp.dy[k] = (int)taps[tp.n + k];
    tp.w[k] = taps[2 * tp.n + k];
    tp.o[k] = tp.dx[k] * (ty + 2 * h) + tp.dy[k];
  }
  const size_t n = (size_t)a.nx * a.ny, m2 = (size_t)a.nx2 * a.ny2;
  if (2 * n > (size_t)INT_MAX || m2 > (size_t)INT_MAX)  // int offsets
    return (int)cudaErrorInvalidValue;
  DB b = a;
  b.x = (float*)scratch;
  b.yv = b.x + n;
  b.q = b.yv + m2;
  a.terms = b.q + 2 * n;
  b.terms = a.terms;
  DBTiledKernel kernel = deblur_tiled_kernel(a.ntaps);
  const int threads = tiled_threads(tiled_n(a.ntaps));
  const int limit = resident_smem_limit(kernel);
  if (limit < 0) return -limit;
  const size_t smem = deblur_tiled_bytes(tx, ty, h, limit);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  int two = smem == deblur_tiled_smem(tx, ty, h, true);
  int sms = 0, per_sm = 0;
  if (int rc = device_sms(&sms)) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &tp, &count, &h, &tx, &ty, &two};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(threads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const dim3 g = grid_of(a.nx2, a.ny2);
  pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
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
  b.terms = nullptr;
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
  b.zx = (long long)nx * ny;
  b.zyv = (long long)nx2 * ny2;
  b.zq = 2 * b.zx;
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
// block of the (nx2, ny2) grid per frame; frame z of (x, xp), (yv, yvp)
// and (q, qp) lies zx, zyv and zq floats after frame z - 1 (fb, sv and the
// carried planes back to back).  A frame whose sc[S_CONV] is set is a
// no-op.
int prost_deblur_chunk_batched(void* x, void* yv, void* q, void* xp,
                               void* yvp, void* qp, void* bx, void* bxp,
                               void* g, void* gp, const void* fb,
                               const void* sv, const void* taps, void* sc,
                               void* partial, int nx, int ny, int nx2,
                               int ny2, int ntaps, float sig_q, float tau_t,
                               float sqrt_q, float sqrt_t, long long zx,
                               long long zyv, long long zq, int count,
                               int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  DB b = deblur_of(x, yv, q, xp, yvp, qp, bx, bxp, g, gp, fb, sv, taps, sc,
                   partial, nx, ny, nx2, ny2, ntaps, sig_q, tau_t, sqrt_q,
                   sqrt_t);
  b.zx = zx;
  b.zyv = zyv;
  b.zq = zq;
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

// deblur_fused_chunk and deblur_fused_chunk_halo as one grid-resident
// cooperative launch (deblur_resident): the whole plane with nx_global = 0,
// else one halo-extended band as prost_deblur_chunk_halo takes it; the
// previous iterate into (xp, yvp, qp), the 4 SQUARED norms into
// sc[S_NORM..]; `terms` holds 4 (nx2, ny2) planes of scratch and `reach`
// is the taps' largest row shift.  A band's planes that do not fit in one
// block's shared memory are refused (cudaErrorCooperativeLaunchTooLarge or
// cudaErrorInvalidValue).  No-op when sc[S_CONV] is set.
int prost_deblur_chunk_resident(void* x, void* yv, void* q, void* xp,
                                void* yvp, void* qp, const void* fb,
                                const void* sv, const void* taps, void* sc,
                                void* partial, void* terms, int nx, int ny,
                                int nx2, int ny2, int ntaps, int reach,
                                float sig_q, float tau_t, float sqrt_q,
                                float sqrt_t, int nx_global, int count,
                                void* stream) {
  DB b = deblur_of(x, yv, q, xp, yvp, qp, nullptr, nullptr, nullptr,
                   nullptr, fb, sv, taps, sc, partial, nx, ny, nx2, ny2,
                   ntaps, sig_q, tau_t, sqrt_q, sqrt_t);
  b.terms = (float*)terms;
  b.nxg = nx_global;
  DBResKernel kernel = deblur_resident_kernel(ntaps);
  int rmax = 0, half = 0, rc = 0;
  size_t smem = resident_smem(kernel, nx2, ny, ny2, reach, 1, rmax, half, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &reach, &rmax};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// deblur_fused_chunk and deblur_fused_chunk_halo for the planes no
// grid-resident band holds (deblur_fused_chunk_banded's): one tiled
// cooperative launch (deblur_tiled) and the finish.  The arguments of
// prost_deblur_chunk_resident with `scratch` (4 nx ny + nx2 ny2 floats:
// slot B and the last iteration's w_hat) for `terms`, the window's halo h for `reach`
// (ops/fused_deblur.py deblur_tiled_halo), and the owned tile (tx rows, a
// multiple of 8; ty columns, of 32).  Bit-equal to prost_deblur_chunk
// (prost_deblur_chunk_halo) in the planes and the 4 squared norms.  No-op
// when sc[S_CONV] is set.  A tile the launch cannot take is refused
// (cudaErrorInvalidValue, or the card's refusal of the cooperative
// launch).  `host_taps` holds the taps on the host as `taps` holds them on
// the device ((3, ntaps) floats [dx; dy; w]): the kernel takes them as a
// parameter.
int prost_deblur_chunk_tiled(void* x, void* yv, void* q, void* xp,
                             void* yvp, void* qp, const void* fb,
                             const void* sv, const void* taps, void* sc,
                             void* partial, void* scratch, int nx, int ny,
                             int nx2, int ny2, int ntaps, int halo,
                             float sig_q, float tau_t, float sqrt_q,
                             float sqrt_t, int nx_global, int count, int tx,
                             int ty, const void* host_taps, void* stream) {
  DB a = deblur_of(x, yv, q, xp, yvp, qp, nullptr, nullptr, nullptr,
                   nullptr, fb, sv, taps, sc, partial, nx, ny, nx2, ny2,
                   ntaps, sig_q, tau_t, sqrt_q, sqrt_t);
  a.nxg = nx_global;
  return tiled_chunk(a, scratch, (const float*)host_taps, count, halo, tx, ty,
                     (cudaStream_t)stream);
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device (the same for every tap count), or minus the error.
int prost_deblur_tiled_smem() {
  return resident_smem_limit(deblur_tiled_kernel(0));
}

// The dynamic shared memory a block of the tiled launch takes for a tile
// of tx x ty and a halo of h (ops/fused_deblur.py deblur_tiled_bytes
// mirrors it).
int prost_deblur_tiled_bytes(int tx, int ty, int h) {
  const int limit = prost_deblur_tiled_smem();
  return limit < 0 ? limit : (int)deblur_tiled_bytes(tx, ty, h, limit);
}

// deblur_fused_chunk_batched as one grid-resident cooperative launch
// (deblur_resident_batched): the frames one after another, or with `pairs`
// two at a time side by side, each bit-equal to
// prost_deblur_chunk_resident on it alone; buffers, strides and flags as
// prost_deblur_chunk_batched takes them, `terms` 4 (nx2, ny2) planes of
// scratch shared by the frames (8 with `pairs`).  Refused as
// prost_deblur_chunk_resident is.
int prost_deblur_chunk_batched_resident(
    void* x, void* yv, void* q, void* xp, void* yvp, void* qp,
    const void* fb, const void* sv, const void* taps, void* sc,
    void* partial, void* terms, int nx, int ny, int nx2, int ny2, int ntaps,
    int reach, float sig_q, float tau_t, float sqrt_q, float sqrt_t,
    long long zx, long long zyv, long long zq, int pairs, int count,
    int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  DB b = deblur_of(x, yv, q, xp, yvp, qp, nullptr, nullptr, nullptr,
                   nullptr, fb, sv, taps, sc, partial, nx, ny, nx2, ny2,
                   ntaps, sig_q, tau_t, sqrt_q, sqrt_t);
  b.terms = (float*)terms;
  b.zx = zx;
  b.zyv = zyv;
  b.zq = zq;
  const int groups = pairs ? 2 : 1;
  DBResBatchedKernel kernel = deblur_resident_batched_kernel(ntaps, groups);
  int rmax = 0, half = 0, rc = 0;
  size_t smem = resident_smem(kernel, nx2, ny, ny2, reach, groups, rmax,
                              half, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &reach, &rmax, &batch, &half};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream, groups);
}

// The dynamic shared memory a block of deblur_resident (kind 0) or of
// deblur_resident_batched with one (1) or two (2) frames a block may hold
// on the current device (the same for every tap count), or minus the
// error.
int prost_deblur_resident_smem(int kind) {
  if (kind == 0) return resident_smem_limit(deblur_resident_kernel(0));
  return resident_smem_limit(deblur_resident_batched_kernel(0, kind));
}

}  // extern "C"
