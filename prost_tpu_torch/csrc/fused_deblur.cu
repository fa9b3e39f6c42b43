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
// pixel.
//
// Design.  One cooperative launch a chunk, one block of DT_THREADS on each
// SM (32 rows of 32 threads), a grid barrier between iterations: iteration
// t reads slot t mod 2 (slot A the caller's x, yv and q, slot B 4 planes of
// scratch) and writes the other.  The blocks walk the yv grid's tiles (tx
// rows, a multiple of 8, by ty columns, of 32; the x grid's pixels are
// owned with the yv grid's at the same place); a tile's window is the tile
// and h = reach + 1 pixels on every side (reach = the taps' largest row or
// column shift, at least 1; ops/fused_deblur.py deblur_tiled_halo: the
// primal step reads q one pixel up and left and yv up to reach pixels down
// and right, the dual step x_new up to reach pixels up and left and one
// down and right).  In shared memory five planes of the window:
//   1. cp.async loads of x, q_x, q_y and yv, zero outside the planes;
//   2. the primal step (deblur_primal's) into a second x plane on the rows
//      [R0 - reach, R1] and columns [C0 - reach, C1] of the tile
//      [R0, R1) x [C0, C1);
//   3. the dual step (deblur_dual's) at the owned pixels into the other
//      slot: B x and grad x of the old x, which the streaming sequence
//      carries in planes, recomputed from the window by the same functions
//      (conv_fwd, the forward differences), which give the same bits; on
//      the chunk's last iteration the old x, yv and q also into the
//      caller's previous-iterate planes.
// Every mask is decided by the pixel's place in the planes (the row
// context of deblur_rows, as the streaming kernels decide it); a read
// outside the planes is the zero the load put there.  After the last
// iteration and a grid barrier the blocks reduce deblur_norm_partial's
// 32x8 tiles from the written slot (norm_terms, the products recomputed;
// four tiles at a time in block_partials' tree), copying slot B back into
// the caller's planes after an odd count as they read it; pdhg_finish
// follows.  Planes and norms are the streaming sequence's bit for bit.  A
// launch whose flag is set at entry returns before its first barrier.
// ---------------------------------------------------------------------------

constexpr int DT_THREADS = 1024;  // a block: 32 rows of 32 threads
constexpr int DT_ROWS = DT_THREADS / BX;
constexpr int DT_PLANES = 5;      // x, x after the primal step, yv, q_x, q_y
constexpr int DT_RED = (DT_THREADS / NT) * 4 * NT;  // the norm pass's trees

// The dynamic shared memory of a block of the tiled launch (mirrored by
// ops/fused_deblur.py deblur_tiled_bytes).
inline size_t deblur_tiled_smem(int tx, int ty, int h) {
  const size_t planes =
      (size_t)DT_PLANES * (tx + 2 * (size_t)h) * (ty + 2 * (size_t)h);
  return (planes > (size_t)DT_RED ? planes : (size_t)DT_RED) * sizeof(float);
}

// A window of a plane in shared memory: at(i, j) is element (i, j) of the
// whole plane, the window's corner (r0, c0), its rows w floats apart.
struct TWin {
  float* a;
  int r0, c0, w;
  __device__ __forceinline__ float& at(int i, int j) const {
    return a[(i - r0) * w + (j - c0)];
  }
};

// The scalars of a launch as the streaming kernels form them.
struct TiledScal {
  float tau_s, sigma, theta, tp, inv_l, sig_p, sig_t, radius;
};

__device__ __forceinline__ TiledScal tiled_scal(const DB& b) {
  TiledScal k;
  k.tau_s = b.sc[S_TAU] * b.tau_t;  // tau * Tau
  k.sigma = b.sc[S_SIGMA];
  k.theta = b.sc[S_THETA];
  k.tp = 1.f + k.theta;
  k.inv_l = 1.f / b.sc[S_LMB];
  const float sq = k.sigma * b.sig_q;  // sigma * Sigma_q
  k.sig_p = sq * k.tp;
  k.sig_t = sq * k.theta;
  k.radius = b.sc[S_RADIUS];
  return k;
}

// One iteration on tile `tile` of the tiles of tx x ty: the window from
// slot `src`, the owned pixels into slot `dst`; with `last` the old values
// also into the previous-iterate planes (a's xp, yvp, qp).  `a` holds the
// read-only planes and the shapes.
template <typename T>
__device__ __forceinline__ void tiled_iteration(
    const DB& src, const DB& dst, const DB& a, const RowCtx& r,
    const TiledScal& k, int tile, int tx, int ty, int h, bool last,
    const T& t, float* smem) {
  const int nx = a.nx, ny = a.ny, nx2 = a.nx2, ny2 = a.ny2;
  const size_t n = (size_t)nx * ny;
  const int ntc = (ny2 + ty - 1) / ty;
  const int R0 = tile / ntc * tx, C0 = tile % ntc * ty;
  const int R1 = min(R0 + tx, nx2), C1 = min(C0 + ty, ny2);
  const int r0 = R0 - h, c0 = C0 - h;
  const int wh = R1 + h - r0, ww = C1 + h - c0, m = wh * ww;
  const TWin X{smem, r0, c0, ww}, XN{smem + m, r0, c0, ww};
  const TWin YV{smem + 2 * m, r0, c0, ww}, QX{smem + 3 * m, r0, c0, ww};
  const TWin QY{smem + 4 * m, r0, c0, ww};
  const int lane = threadIdx.x % BX, row = threadIdx.x / BX;

  // 1. the window of the state, zero outside the planes
  for (int wi = row; wi < wh; wi += DT_ROWS) {
    const int i = r0 + wi;
    for (int wj = lane; wj < ww; wj += BX) {
      const int j = c0 + wj, p = wi * ww + wj;
      if (i >= 0 && i < nx && j >= 0 && j < ny) {
        const size_t g = (size_t)i * ny + j;
        cp_async4(X.a + p, src.x + g);
        cp_async4(QX.a + p, src.q + g);
        cp_async4(QY.a + p, src.q + n + g);
      } else {
        X.a[p] = 0.f;
        QX.a[p] = 0.f;
        QY.a[p] = 0.f;
      }
      if (i >= 0 && i < nx2 && j >= 0 && j < ny2)
        cp_async4(YV.a + p, src.yv + (size_t)i * ny2 + j);
      else
        YV.a[p] = 0.f;
    }
  }
  cp_async_wait();
  __syncthreads();

  // 2. deblur_primal on rows [R0 - reach, R1], columns [C0 - reach, C1]
  for (int i = r0 + 1 + row; i <= R1; i += DT_ROWS)
    for (int j = c0 + 1 + lane; j <= C1; j += BX) {
      const float xv = X.at(i, j);
      float xn = xv;  // beyond the image x stays (and is not read)
      if (i >= 0 && image_row(r, i, nx) && j >= 0 && j < ny)
        xn = xv - k.tau_s * kty_at(YV, QX, QY, a, r, i, j, t);
      XN.at(i, j) = xn;
    }
  __syncthreads();

  // 3. deblur_dual at the owned pixels, into slot dst
  for (int i = R0 + row; i < R1; i += DT_ROWS)
    for (int j = C0 + lane; j < C1; j += BX) {
      const size_t p2 = (size_t)i * ny2 + j;
      const float bx2 = conv_fwd(XN, a, r, i, j, t);
      const float bxv = conv_fwd(X, a, r, i, j, t);  // the carried B x
      const float tsv = k.sigma * a.sv[p2];  // sigma * Sigma_v
      const float den = 1.f / (1.f + tsv * k.inv_l);
      const float sh = tsv * a.fb[p2];
      const float yvv = YV.at(i, j);
      const float av = yvv + tsv * (k.tp * bx2 - k.theta * bxv);
      dst.yv[p2] = (av - sh) * den;
      if (last) a.yvp[p2] = yvv;
      if (i >= nx || j >= ny) continue;
      const size_t p = (size_t)i * ny + j;
      const float xo = X.at(i, j), qx = QX.at(i, j), qy = QY.at(i, j);
      if (last) {
        a.xp[p] = xo;
        a.qp[p] = qx;
        a.qp[n + p] = qy;
      }
      if (!image_row(r, i, nx)) {  // a band's row beyond the image stays
        dst.x[p] = xo;
        dst.q[p] = qx;
        dst.q[n + p] = qy;
        continue;
      }
      const float xv = XN.at(i, j);
      const bool below = has_below(r, i, nx), right = j < ny - 1;
      const float gx2 = below ? XN.at(i + 1, j) - xv : 0.f;
      const float gy2 = right ? XN.at(i, j + 1) - xv : 0.f;
      const float gx = below ? X.at(i + 1, j) - xo : 0.f;  // the carried g
      const float gy = right ? X.at(i, j + 1) - xo : 0.f;
      const float ax = (qx + k.sig_p * gx2) - k.sig_t * gx;
      const float ay = (qy + k.sig_p * gy2) - k.sig_t * gy;
      const float nn = ax * ax + ay * ay;
      const float scale = nn > 0.f ? fminf(1.f, k.radius * rsqrtf(nn)) : 1.f;
      dst.x[p] = xv;
      dst.q[p] = ax * scale;
      dst.q[n + p] = ay * scale;
    }
}

// The body of deblur_tiled with the taps `t`: `count` iterations from slot
// A (a) through slot B (b), then deblur_norm_partial's tiles of the slot
// written last, slot B copied back into a's planes after an odd count.
template <typename T>
__device__ __forceinline__ void deblur_tiled_body(const DB& a, const DB& b,
                                                  int count, int h, int tx,
                                                  int ty, const T& t,
                                                  float* smem) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const RowCtx r = deblur_rows(a);
  const TiledScal k = tiled_scal(a);
  const int nx2 = a.nx2, ny2 = a.ny2;
  const int ntiles = ((nx2 + tx - 1) / tx) * ((ny2 + ty - 1) / ty);
  for (int it = 0; it < count; ++it) {
    const DB& src = (it & 1) ? b : a;
    const DB& dst = (it & 1) ? a : b;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tiled_iteration(src, dst, a, r, k, tile, tx, ty, h, it == count - 1,
                      t, smem);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }

  // deblur_norm_partial's tiles, four at a time (block_partials' tree),
  // slot B copied back as it is read after an odd count
  const bool back = (count & 1) != 0;
  const DB& fin = back ? b : a;
  const size_t n = (size_t)a.nx * a.ny;
  tiled_tile_partials<DT_THREADS>(nx2, ny2, a.partial, smem,
                                  [&](int i, int j, float v[4]) {
    if (owned_row(r, i)) norm_terms<false>(fin, r, i, j, t, v);
    if (back) {
      const size_t p2 = (size_t)i * ny2 + j, p = (size_t)i * a.ny + j;
      a.yv[p2] = b.yv[p2];
      if (i < a.nx && j < a.ny) {
        a.x[p] = b.x[p];
        a.q[p] = b.q[p];
        a.q[n + p] = b.q[n + p];
      }
    }
  });
}

// N > 0: a launch of N taps, held in registers; N = 0: any count, read
// from shared memory.
template <int N>
__global__ void __launch_bounds__(DT_THREADS, 1)
    deblur_tiled(DB a, DB b, int count, int h, int tx, int ty) {
  if (a.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  __shared__ Taps ts;
  stage_taps(a.taps, a.ntaps, ts);
  if constexpr (N > 0) {
    const TapsN<N> t = taps_in_registers<N>(ts);
    deblur_tiled_body(a, b, count, h, tx, ty, t, smem);
  } else {
    deblur_tiled_body(a, b, count, h, tx, ty, ts, smem);
  }
}

using DBTiledKernel = void (*)(DB, DB, int, int, int, int);

// The tiled kernel for `ntaps` taps: the taps in registers up to
// RES_REG_TAPS, else read from shared memory.
DBTiledKernel deblur_tiled_kernel(int ntaps) {
  switch (ntaps) {
    case 1: return deblur_tiled<1>;
    case 2: return deblur_tiled<2>;
    case 3: return deblur_tiled<3>;
    case 4: return deblur_tiled<4>;
    case 5: return deblur_tiled<5>;
    case 6: return deblur_tiled<6>;
    case 7: return deblur_tiled<7>;
    case RES_REG_TAPS: return deblur_tiled<RES_REG_TAPS>;
    default: return deblur_tiled<0>;
  }
}

// One tiled chunk: the cooperative launch (one block of DT_THREADS on each
// SM) and pdhg_finish; slot B's x, yv and q in `scratch` (n, m2 and 2 n
// floats).  A tile that is not a multiple of the 32x8 norm tiles or whose
// window does not fit in a block's shared memory is refused with
// cudaErrorInvalidValue, a grid the card cannot hold at once by the card
// (cudaErrorCooperativeLaunchTooLarge).
int tiled_chunk(DB& a, void* scratch, int count, int h, int tx, int ty,
                cudaStream_t st) {
  if (tx < BY || tx % BY || ty < BX || ty % BX || h < 2 || count < 1)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)a.nx * a.ny, m2 = (size_t)a.nx2 * a.ny2;
  DB b = a;
  b.x = (float*)scratch;
  b.yv = b.x + n;
  b.q = b.yv + m2;
  DBTiledKernel kernel = deblur_tiled_kernel(a.ntaps);
  const size_t smem = deblur_tiled_smem(tx, ty, h);
  const int limit = resident_smem_limit(kernel);
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  if (int rc = device_sms(&sms)) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      DT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &count, &h, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(DT_THREADS), args, smem, st);
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
// prost_deblur_chunk_resident with `scratch` (3 nx ny + nx2 ny2 floats,
// slot B) for `terms`, the window's halo h for `reach`
// (ops/fused_deblur.py deblur_tiled_halo), and the owned tile (tx rows, a
// multiple of 8; ty columns, of 32).  Bit-equal to prost_deblur_chunk
// (prost_deblur_chunk_halo) in the planes and the 4 squared norms.  No-op
// when sc[S_CONV] is set.  A tile the launch cannot take is refused
// (cudaErrorInvalidValue, or the card's refusal of the cooperative
// launch).
int prost_deblur_chunk_tiled(void* x, void* yv, void* q, void* xp,
                             void* yvp, void* qp, const void* fb,
                             const void* sv, const void* taps, void* sc,
                             void* partial, void* scratch, int nx, int ny,
                             int nx2, int ny2, int ntaps, int halo,
                             float sig_q, float tau_t, float sqrt_q,
                             float sqrt_t, int nx_global, int count, int tx,
                             int ty, void* stream) {
  DB a = deblur_of(x, yv, q, xp, yvp, qp, nullptr, nullptr, nullptr,
                   nullptr, fb, sv, taps, sc, partial, nx, ny, nx2, ny2,
                   ntaps, sig_q, tau_t, sqrt_q, sqrt_t);
  a.nxg = nx_global;
  return tiled_chunk(a, scratch, count, halo, tx, ty, (cudaStream_t)stream);
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device (the same for every tap count), or minus the error.
int prost_deblur_tiled_smem() {
  return resident_smem_limit(deblur_tiled_kernel(0));
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
