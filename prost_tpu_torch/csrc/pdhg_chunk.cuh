// Pieces shared by the PDHG chunk kernels for NVIDIA Hopper (sm_90a):
// csrc/fused_rof.cu (ROF), csrc/fused_multilabel.cu (fast multilabel),
// csrc/fused_deblur.cu, csrc/fused_tight.cu and csrc/fused_vol.cu.
//
// * the slots of the device scalar buffer `sc` that every kernel of a
//   launch reads (step sizes, the family's two scalars, the adaptation
//   state, the tolerances, the converged flag, the chunk count, the norms);
// * the pixel grid: one thread per pixel, 32x8 blocks with threadIdx.x
//   along the contiguous y axis;
// * the instance axis of a batched launch (the JAX package's gridded batch
//   kernels, grid = (B,)): one instance per blockIdx.z of the pixel grid,
//   each with its own S_LEN scalars in `sc` and its own norm partials, its
//   buffers at 64-bit offsets of z times its per-instance size (a family's
//   instance_of).  A pixel block reads and writes only its own instance,
//   and every instance is reduced exactly as a single-instance launch
//   reduces its plane, so instance b of a batched launch is bit-equal to a
//   single-instance launch on instance b alone;
// * the rows of a launch within the global plane (RowCtx): the whole plane,
//   or one halo-extended shard of a row-partitioned plane (the halo chunks
//   of spatial sharding, the JAX package's *_chunk_halo kernels), whose
//   row masks use global rows and whose norms cover the owned rows only;
// * pdhg_finish, the second pass of the four residual norms (one block per
//   instance) and, in a multichunk launch, the boyd/goldstein adaptation
//   and the stopping test (adapt_scalars of prost_tpu/ops/fused_rof.py,
//   which both JAX multichunk kernels share);
// * the pieces of a grid-resident chunk (one cooperative launch, one block
//   of RES_THREADS on each SM, each block holding a band of rows of every
//   plane in shared memory): the bands (band_of), the windows of label
//   planes' rows in shared memory (LWin, take), the walk over a band's
//   pixels (next_pixel) and the row copies into a window (load_rows), a
//   tiled chunk's window (MWin), the per-tile norm partials from per-pixel
//   terms (coop_tile_partials, the tree of block_partials;
//   tiled_tile_partials, the tiled chunks' norm pass) and the launch
//   itself (resident_launch);
// * LAUNCH_CHECK, which returns a launch's error from the C entry point.
//
// Every source that includes this header is its own library with a plain C
// interface; the build hashes this header with each of them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// scalar buffer slots, mirrored by prost_tpu_torch/ops/pdhg_chunk.py
enum {
  S_TAU = 0, S_SIGMA = 1, S_THETA = 2,
  S_ARG3 = 3, S_ARG4 = 4,  // the family's two scalars
  S_ARG_ALPHA = 5, S_ARB_L = 6, S_ARB_U = 7, S_IT = 8,
  S_TOL_RP = 9, S_TOL_RD = 10, S_TOL_AP = 11, S_TOL_AD = 12,
  S_CONV = 13, S_DONE = 14, S_NORM = 15,  // S_NORM .. S_NORM + 3
  S_LEN = 19,  // scalars of one instance
};

// A halo chunk's row context in the slots of the multichunk's adaptation
// state, which a chunk launch does not use: [tau, sigma, theta, arg3, arg4,
// row_offset, own_lo, own_hi] is the JAX package's scal8 (integers as
// floats, exact below 2^24).
enum { S_ROW_OFF = 5, S_OWN_LO = 6, S_OWN_HI = 7 };

enum { STEP_NONE = 0, STEP_GOLDSTEIN = 1, STEP_BOYD = 2 };

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 512;  // threads of the final reduction
constexpr int MAX_BATCH = 65535;  // instances of a launch: gridDim.z's limit

__device__ __forceinline__ bool pixel(int nx, int ny, int& i, int& j) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  return i < nx && j < ny;
}

// Where the nx rows of a launch lie in the global plane: local row i is
// global row i + off of nxg; the norms sum local rows [own_lo, own_hi).
// The whole plane is (0, nx, 0, nx).  A halo-extended shard (nxg > 0, the
// halo entry points) reads its offset and owned rows from `sc`: its row
// masks use global rows, so the Neumann boundary lies at global rows 0 and
// nxg - 1 and not at the shard's edges, and a neighbour row is read only
// where both the local and the global row have one.  The rows beyond the
// global plane (an edge shard's halo) and the halo rows next to a local
// edge compute values that no owned row reads within a chunk of at most
// (halo - 2) / 2 iterations: information moves one row per half-step.
struct RowCtx {
  int off, nxg, own_lo, own_hi;
};

__device__ __forceinline__ RowCtx row_ctx(const float* sc, int nx,
                                          int nxg) {
  if (nxg == 0) return RowCtx{0, nx, 0, nx};
  return RowCtx{(int)sc[S_ROW_OFF], nxg, (int)sc[S_OWN_LO],
                (int)sc[S_OWN_HI]};
}

// The forward difference of row i reads row i + 1.
__device__ __forceinline__ bool has_below(const RowCtx& r, int i, int nx) {
  return i < nx - 1 && i + r.off < r.nxg - 1;
}

// The adjoint of row i reads row i - 1.
__device__ __forceinline__ bool has_above(const RowCtx& r, int i) {
  return i > 0 && i + r.off > 0;
}

// Row i is the global last row, where q_x is a dead coordinate.
__device__ __forceinline__ bool dead_row(const RowCtx& r, int i) {
  return i + r.off == r.nxg - 1;
}

__device__ __forceinline__ bool owned_row(const RowCtx& r, int i) {
  return i >= r.own_lo && i < r.own_hi;
}

// The pixel grid of `batch` instances of an (nx, ny) plane.
__host__ __device__ __forceinline__ dim3 grid_of(int nx, int ny,
                                                 int batch = 1) {
  return dim3((ny + BX - 1) / BX, (nx + BY - 1) / BY, batch);
}

// Per-block tree sum of the four norm terms v[0..3] into the partials of
// the block's instance, partial[4 * block] there (the first pass;
// pdhg_finish is the second).  Every thread of the block calls it, also
// those outside the plane (with zeros).
__device__ __forceinline__ void block_partials(const float v[4],
                                               float* __restrict__ partial) {
  __shared__ float red[4][NT];
  partial += (size_t)blockIdx.z * 4 * gridDim.x * gridDim.y;
  int t = threadIdx.y * BX + threadIdx.x;
  for (int k = 0; k < 4; ++k) red[k][t] = v[k];
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < 4; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t == 0) {
    int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int k = 0; k < 4; ++k) partial[4 * blk + k] = red[k][0];
  }
}

struct AdaptConsts {
  float sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta, arb_tau;
};

// Second pass (pdhg_finish, one block per instance, blockIdx.x; its body
// finish_block, run by the FIN threads of a block on the reduction array
// `red`): the instance's four
// squared norms from its `nblocks` partials in a fixed order.  With `adapt`
// set (multichunk) thread 0 then runs adapt_scalars: the same f32
// operations in the same order as the JAX package's, with the iteration
// counter as f32 (exact below 2^24), and advances the chunk counters.
// Bound: launch latency (a few KB of partials per instance); it is what
// lets the multichunk keep its step sizes and stopping test on the device,
// where the TPU kernel ran them on SMEM scalars between chunks.
__device__ __forceinline__ void finish_block(float (*red)[FIN],
                                             float* __restrict__ sc,
                                             const float* __restrict__ partial,
                                             int nblocks, int count,
                                             int adapt, int stepsize,
                                             AdaptConsts c) {
  if (sc[S_CONV] != 0.f) return;
  int t = threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int blk = t; blk < nblocks; blk += FIN)
    for (int k = 0; k < 4; ++k) acc[k] += partial[4 * blk + k];
  for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < 4; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t != 0) return;
  if (!adapt) {  // chunk: squared norms out, adaptation on the host side
    for (int k = 0; k < 4; ++k) sc[S_NORM + k] = red[k][0];
    return;
  }
  float pr = sqrtf(red[0][0]), pn = sqrtf(red[1][0]);
  float dr = sqrtf(red[2][0]), dn = sqrtf(red[3][0]);
  float it = sc[S_IT] + (float)(count - 1);  // pre-increment counter
  float eps_pri = c.sqrt_nrows * sc[S_TOL_AP] + sc[S_TOL_RP] * pn;
  float eps_dua = c.sqrt_ncols * sc[S_TOL_AD] + sc[S_TOL_RD] * dn;
  bool conv = (pr < eps_pri) && (dr < eps_dua);
  float tau = sc[S_TAU], sigma = sc[S_SIGMA], aa = sc[S_ARG_ALPHA];
  float al = sc[S_ARB_L], au = sc[S_ARB_U];
  if (stepsize == STEP_GOLDSTEIN) {
    float scale = eps_dua / eps_pri;
    bool up = dr > scale * pr * c.arg_delta;
    bool dn_ = dr < scale * pr / c.arg_delta;
    float fac = 1.f - aa;
    tau = up ? tau / fac : (dn_ ? tau * fac : tau);
    sigma = up ? sigma * fac : (dn_ ? sigma / fac : sigma);
    aa = (up || dn_) ? aa * c.arg_nu : aa;
  } else if (stepsize == STEP_BOYD) {
    bool c1 = (dr < eps_dua) && (c.arb_tau * it > al);
    bool c2 = (pr < eps_pri) && (c.arb_tau * it > au) && !c1;
    tau = c1 ? tau / c.arb_delta : (c2 ? tau * c.arb_delta : tau);
    sigma = c1 ? sigma * c.arb_delta : (c2 ? sigma / c.arb_delta : sigma);
    au = c1 ? it : au;
    al = c2 ? it : al;
  }
  sc[S_TAU] = tau;
  sc[S_SIGMA] = sigma;
  sc[S_ARG_ALPHA] = aa;
  sc[S_ARB_L] = al;
  sc[S_ARB_U] = au;
  sc[S_NORM + 0] = pr;
  sc[S_NORM + 1] = pn;
  sc[S_NORM + 2] = dr;
  sc[S_NORM + 3] = dn;
  sc[S_DONE] += 1.f;
  sc[S_IT] += (float)count;
  sc[S_CONV] = conv ? 1.f : 0.f;  // last: the other threads have read it
}

__global__ void pdhg_finish(float* __restrict__ sc,
                            const float* __restrict__ partial, int nblocks,
                            int count, int adapt, int stepsize,
                            AdaptConsts c) {
  __shared__ float red[4][FIN];
  finish_block(red, sc + (size_t)blockIdx.x * S_LEN,
               partial + (size_t)blockIdx.x * 4 * nblocks, nblocks, count,
               adapt, stepsize, c);
}

// ---------------------------------------------------------------------------
// Grid-resident chunks (one cooperative launch a chunk).  The launch has one
// block of RES_THREADS on each SM; block b owns the rows band_of(n, b, G)
// of the chunk's grid and holds every plane of them in dynamic shared
// memory, with the neighbours' rows its stencils read copied in after each
// grid barrier.  The norms: each block writes its pixels' four terms to a
// global array `terms` (4 planes of the grid), and after a barrier the
// blocks reduce the 32x8 tiles of the streaming launches' grid_of in
// block_partials' tree (coop_tile_partials), so the partials, and the
// finish over them, are the streaming sequence's bit for bit.
// ---------------------------------------------------------------------------

constexpr int RES_THREADS = FIN;  // finish_block's threads: two 32x8 tiles
constexpr int RES_RED_BYTES = 4 * FIN * (int)sizeof(float);

// Rows [lo, hi) of band `blk` of `blocks` over n rows: every row in exactly
// one band, the bands' sizes within one (empty where blocks > n).
__host__ __device__ __forceinline__ void band_of(int n, int blk, int blocks,
                                                 int& lo, int& hi) {
  lo = (int)((long long)blk * n / blocks);
  hi = (int)((long long)(blk + 1) * n / blocks);
}

// The rows of the largest band of n rows over `blocks`.
__host__ __device__ __forceinline__ int band_rows(int n, int blocks) {
  return (n + blocks - 1) / blocks;
}

// block_partials for every 32x8 tile of the (nr, nc) grid from the terms
// terms[k * nr * nc + pixel] (zeros where a pixel has none), RES_THREADS /
// NT tiles at a time per block, tile t of grid_of(nr, nc) numbered as that
// grid numbers its blocks; `red` holds 4 RES_THREADS floats.  Block `blk`
// of the `nblk` blocks that share the tiles calls it (every block of the
// launch, or one instance's group of blocks).
__device__ __forceinline__ void coop_tile_partials(
    const float* __restrict__ terms, int nr, int nc,
    float* __restrict__ partial, float* red, int blk, int nblk) {
  const int ntx = (nc + BX - 1) / BX;
  const int ntiles = (nr + BY - 1) / BY * ntx;
  const int per = RES_THREADS / NT;
  const int g = threadIdx.x / NT, t = threadIdx.x % NT;
  const size_t m = (size_t)nr * nc;
  float* r = red + g * 4 * NT;  // r[k * NT + t]
  for (int base = per * blk; base < ntiles; base += per * nblk) {
    const int tile = base + g;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < ntiles) {
      int i = tile / ntx * BY + t / BX, j = tile % ntx * BX + t % BX;
      if (i < nr && j < nc) {
        size_t p = (size_t)i * nc + j;
        for (int k = 0; k < 4; ++k) v[k] = terms[k * m + p];
      }
    }
    for (int k = 0; k < 4; ++k) r[k * NT + t] = v[k];
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int k = 0; k < 4; ++k) r[k * NT + t] += r[k * NT + t + s];
      __syncthreads();
    }
    if (t == 0 && tile < ntiles)
      for (int k = 0; k < 4; ++k) partial[4 * tile + k] = r[k * NT];
    __syncthreads();  // the next tiles overwrite r
  }
}

__device__ __forceinline__ void coop_tile_partials(
    const float* __restrict__ terms, int nr, int nc,
    float* __restrict__ partial, float* red) {
  coop_tile_partials(terms, nr, nc, partial, red, blockIdx.x, gridDim.x);
}

// The norm pass of a tiled chunk (csrc/fused_multilabel.cu ml_tiled,
// csrc/fused_tight.cu tight_tiled, csrc/fused_vol.cu vol_tiled):
// block_partials' tree for every 32x8 tile of the (nr, nc) grid, THREADS /
// NT tiles at a time per block of the launch, tile t of grid_of(nr, nc)
// into partial[4 t ..].  terms(i, j, v) is called once for each pixel of
// the grid and adds the pixel's four terms to v (zeros); `red` holds 4
// THREADS floats.
template <int THREADS, typename F>
__device__ __forceinline__ void tiled_tile_partials(int nr, int nc,
                                                    float* __restrict__ partial,
                                                    float* red, F terms) {
  const int ntx = (nc + BX - 1) / BX;
  const int ntiles = (nr + BY - 1) / BY * ntx;
  const int group = threadIdx.x / NT, t = threadIdx.x % NT;
  const int groups = THREADS / NT;
  float* r = red + group * 4 * NT;  // r[k * NT + t]
  for (int base = groups * blockIdx.x; base < ntiles;
       base += groups * gridDim.x) {
    const int tile = base + group;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < ntiles) {
      const int i = tile / ntx * BY + t / BX, j = tile % ntx * BX + t % BX;
      if (i < nr && j < nc) terms(i, j, v);
    }
    for (int k = 0; k < 4; ++k) r[k * NT + t] = v[k];
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int k = 0; k < 4; ++k) r[k * NT + t] += r[k * NT + t + s];
      __syncthreads();
    }
    if (t == 0 && tile < ntiles)
      for (int k = 0; k < 4; ++k) partial[4 * tile + k] = r[k * NT];
    __syncthreads();  // the next pass overwrites r
  }
}

// A window of rows [r0, r0 + rows) of L label planes in shared memory;
// w(l, i, j) reads what w.at(l, i, j) holds (an accessor, as
// csrc/fused_tight.cu's pixel helpers take one).
struct LWin {
  float* a;
  int r0, rows, w;
  __device__ __forceinline__ float& at(int l, int i, int j) const {
    return a[((size_t)l * rows + (i - r0)) * w + j];
  }
  __device__ __forceinline__ float operator()(int l, int i, int j) const {
    return at(l, i, j);
  }
};

// A tiled chunk's window of planes in shared memory (csrc/fused_multilabel.cu
// ml_tiled, csrc/fused_tight.cu tight_tiled): at(k, i, j) is element (i, j)
// of the plane of its k-th plane, the window's corner (r0, c0), its rows w
// floats apart and its planes m floats apart; an accessor as LWin is.
struct MWin {
  float* a;
  int r0, c0, w, m;
  __device__ __forceinline__ float& at(int k, int i, int j) const {
    return a[(size_t)k * m + (i - r0) * w + (j - c0)];
  }
  __device__ __forceinline__ float operator()(int k, int i, int j) const {
    return at(k, i, j);
  }
};

__device__ __forceinline__ LWin take(float*& p, int planes, int r0, int rows,
                                     int w) {
  LWin v{p, r0, rows, w};
  p += (size_t)planes * rows * w;
  return v;
}

// The pixel RES_THREADS further along a row-major walk of rows w wide.
__device__ __forceinline__ void next_pixel(int& i, int& j, int w) {
  j += RES_THREADS;
  while (j >= w) {
    j -= w;
    ++i;
  }
}

// Rows [a, e) of the L (n, w) device planes at `src` (planes n w apart)
// that exist into window `dst` (its own rows in [0, n)).
__device__ __forceinline__ void load_rows(const LWin& dst, const float* src,
                                          int L, int a, int e, int n) {
  a = a < 0 ? 0 : a;
  e = e > n ? n : e;
  const int per = (e - a) * dst.w;
  if (per <= 0) return;
  for (int k = threadIdx.x; k < L * per; k += RES_THREADS) {
    int l = k / per, i = a + k % per / dst.w, j = k % dst.w;
    dst.at(l, i, j) = src[((size_t)l * n + i) * dst.w + j];
  }
}

// The SMs of the current device, found once per device.
inline int device_sms(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) cached[dev] = *sms;
  return 0;
}

// The dynamic shared memory a block of `kernel` may opt into on the current
// device (the device's opt-in limit less the kernel's static shared
// memory), or minus the error.
template <typename K>
int resident_smem_limit(K kernel) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// One cooperative launch of `kernel` with one block of `groups` x
// RES_THREADS threads (threadIdx.y the group) on each SM (on `blocks` SMs
// where it is set) and `smem` bytes of dynamic shared memory; the card
// refuses it (cudaErrorCooperativeLaunchTooLarge) where a block does not
// fit on an SM.
template <typename K>
int resident_launch(K kernel, void** args, size_t smem, cudaStream_t st,
                    int groups = 1, int blocks = 0) {
  int sms = 0;
  if (int rc = device_sms(&sms)) return rc;
  if (blocks > 0) sms = blocks;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(RES_THREADS, groups), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  return (int)e;
}

#define LAUNCH_CHECK()                                  \
  do {                                                  \
    cudaError_t e_ = cudaGetLastError();                \
    if (e_ != cudaSuccess) return (int)e_;              \
  } while (0)

// The error a batched entry point returns for a batch it cannot launch.
inline int batch_error(int batch) {
  return (batch < 1 || batch > MAX_BATCH) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace
