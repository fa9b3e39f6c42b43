// Fused ROF-by-ADMM chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's ADMM ROF route:
//   prost_tpu/ops/fused_admm.py  admm_fused_chunk      -> _admm_chunk_kernel
//   prost_tpu/ops/fused_admm.py  admm_fused_multichunk -> _admm_multichunk_kernel
//   prost_tpu/ops/fused_admm.py  admm_banded_iter
//                                -> _admm_banded_kernel, _admm_banded_db_kernel
//   prost_tpu/ops/fused_admm.py  admm_banded_chunk     -> _admm_banded_chunk_kernel
// whose math is _admm_iter, _cgls_masked, _cheby_project, _admm_norms and
// admm_adapt_scalars in the same file.  The last, the banded route for
// planes beyond a TPU core's VMEM, becomes the tiled chunk (admm_tiled,
// further down) for planes whose bands no grid-resident launch holds.  The
// plain PyTorch versions live beside the wrappers in
// prost_tpu_torch/ops/fused_admm.py.
//
// Halo mode (spatial sharding, admm_banded_iter on a shard).  One outer
// Chebyshev iteration on one halo-extended shard of a row-partitioned plane,
// nx = rows + 2 halo, zeros beyond the plane's edges, in place: every
// stencil tests its neighbour row by local and global row (Rows below), the
// dead z row is the global last row, and the norms cover the owned rows.
// One iteration moves information degree + 3 rows (the t1 gradient, the
// warm start's M, degree - 1 Chebyshev steps, x_proj's gradient, the
// norms' stencils), so the caller exchanges the halo before every
// iteration.  The whole-plane launches are the case (0, nx, 0, nx) of the
// same arithmetic.  The halo iteration runs as one cooperative launch
// (admm_iter_coop), its steps separated by grid barriers; the chunk and
// the multichunk run as one grid-resident cooperative launch
// (admm_chunk_resident, admm_multichunk_resident) where their planes fit
// in the shared memory of one block per SM, else as tiled cooperative
// launches (admm_tiled) where a tile's window does, else as the launch
// sequence of iteration() (the CGLS chunk always as the sequence).
//
// Layout (the JAX package's): x-like planes (nx, ny) row-major f32; z-like
// arrays are two such planes back to back, [zx; zy].
//
// One ADMM outer iteration (Sigma = 1/2, Tau = 1/4, K~ = c_K grad):
//   t1 = (alpha xh + (1 - alpha) xp + xd) / sqrt(Tau),  t2 = sqrt(Sigma) (zh + zd)
//   d  = t2 - c_K grad t1
//   u  = argmin |c_K grad u - d|^2 + |u|^2, warm-started (Chebyshev or CGLS)
//   xp = sqrt(Tau) (u + t1),  zp = grad xp,  xd = sqrt(Tau) t1 - xp,
//   zd = t2 / sqrt(Sigma) - zp,  xh = prox_g(xp - xd),  zh = shrink(zp - zd)
//
// What bounds it on this card.  The TPU kernels hold the ten state planes
// in VMEM for a whole chunk.  A 512x512 f32 plane is 1 MiB, far above the
// 227 KB of shared memory a block can use, so the planes stay in device
// memory (in the 50 MB L2 at 512x512) and each step of the iteration is one
// launch over the plane: about degree + 2 launches per outer iteration with
// the Chebyshev projection.  Each launch moves a few planes and does a few
// dozen flops per pixel; at 512x512 the launches are short enough that
// launch latency, not bytes or flops, bounds a chunk.
//
// Design.  One thread per pixel, 32x8 blocks with threadIdx.x along the
// contiguous y axis.  Stencil neighbours come straight from global memory.
// A kernel writes only its own pixel of a plane, and reads neighbours only
// from planes it does not write: t1 is kept in a scratch plane so the
// projection and update steps can recompute the neighbours' x_proj; the
// Chebyshev direction ping-pongs between two planes.  The scalars (rho,
// lmb, radius, the Boyd state, tolerances, the converged flag, the norms,
// the CG scalars) live in a small device buffer `sc` read by every kernel,
// and every kernel returns at once when sc[S_CONV] is set, so the host
// queues a whole launch sequence without a sync.  Sums reduce in two
// deterministic passes (per-block tree, then one block), with no atomics.
//
// CGLS.  The JAX kernel's masked CG loop (a fixed trip of maxit steps with
// every update predicated on a `done` flag) becomes a fixed host loop of
// launches whose kernels return at once once the device flag is set.  A
// step reads the flag of its parity slot and its last finish writes the
// next step's slot, so every block of a step sees the pre-step flag, as
// the JAX predicate does.  Three reductions per step: |q|^2 + |p|^2 (alpha),
// |x|^2 and |s|^2 (beta and the stopping test).
//
// Rounding.  The build passes -fmad=false, so each expression rounds where
// the plain PyTorch version (one op per kernel there) rounds; sqrtf and
// division are IEEE.  With the Chebyshev projection an iteration has no
// reduction, so only the order of the residual-norm sums differs; CGLS's
// alpha and beta carry that order difference into the iterates.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive as
// void*, and every entry point returns the cudaError_t of its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

// scalar buffer slots, mirrored by prost_tpu_torch/ops/fused_admm.py
enum {
  S_RHO = 0, S_LMB = 1, S_RADIUS = 2, S_DELTA = 3, S_ARB_L = 4, S_ARB_U = 5,
  S_IT = 6, S_TOL_RP = 7, S_TOL_RD = 8, S_TOL_AP = 9, S_TOL_AD = 10,
  S_CONV = 11, S_DONE = 12, S_NORM = 13,  // S_NORM .. S_NORM + 3
  S_FAC = 17,  // dual rescale of the chunk just run; -1 when it did not run
  S_CG_GAMMA = 18, S_CG_NORMS0 = 19, S_CG_ALPHA = 20, S_CG_BETA = 21,
  S_CG_DONE = 22,  // two slots, by the parity of the CG step
  S_LEN = 24,
};

enum { DT_SQUARE = 0, DT_WSQUARE = 1, DT_ABS = 2 };
enum { OP_NORMS = 0, OP_ADAPT = 1, OP_CG_INIT = 2, OP_CG_ALPHA = 3,
       OP_CG_BETA = 4, OP_ADAPT_HOLD = 5 };

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 512;  // threads of the final reduction
constexpr int PS = 4;     // partial sums per block

// the constants as the plain version forms them: in double, rounded once
constexpr double SQRT_S_D = 0.7071067811865476;  // sqrt(Sigma) = sqrt(1/2)
constexpr double SQRT_T_D = 0.5;                 // sqrt(Tau)   = sqrt(1/4)
constexpr double C_K_D = SQRT_S_D * SQRT_T_D;    // K~ = c_K grad
constexpr float SQRT_S = (float)SQRT_S_D;
constexpr float SQRT_T = (float)SQRT_T_D;
constexpr float INV_SQRT_S = (float)(1.0 / SQRT_S_D);
constexpr float INV_SQRT_T = (float)(1.0 / SQRT_T_D);
constexpr float C_K = (float)C_K_D;
constexpr float C2 = (float)(C_K_D * C_K_D);
constexpr float INV_THETA = (float)(1.0 / 1.5);  // Chebyshev, spectrum [1, 2)
constexpr float EPS = 1.1920928955078125e-07f;   // float32 machine epsilon

// Where a launch's nx rows lie in the global plane (the row context of
// pdhg_chunk.cuh, whose scalar slots this family does not share): local row
// i is global row i + off of nxg, and the norms sum local rows [own_lo,
// own_hi).  A neighbour row is read only where the local and the global row
// both have one.
struct Rows {
  int off, nxg, own_lo, own_hi;
};

struct State {
  float *xh, *xp, *xd, *zh, *zp, *zd, *warm;  // updated in place
  const float *f, *w;
  float* t1;       // relaxed primal argument (scaled)
  float* dd;       // Chebyshev: d = t2 - c_K grad t1; CGLS: its residual r
  float* x;        // the projection's iterate
  float *r, *v0, *v1;  // Chebyshev: residual, direction ping-pong
  float *p, *q, *s;    // CGLS: direction, c_K grad p (2 planes), A^T r - x
  float* sc;
  float* partial;  // PS per block
  int nx, ny;
  Rows rows;
  // floats from the x part of a z-like array (zh, zp, zd, dd, q) to its y
  // part: nx ny in device memory, a window's size in a resident block's
  // shared memory (admm_multichunk_resident), so that the pixel stages
  // index a plane as p = i ny + j wherever it lives
  size_t zn;
};

// The forward difference of row i reads row i + 1.
__device__ __forceinline__ bool below(const State& b, int i) {
  return i < b.nx - 1 && i + b.rows.off < b.rows.nxg - 1;
}

// The adjoint of row i reads row i - 1.
__device__ __forceinline__ bool above(const State& b, int i) {
  return i > 0 && i + b.rows.off > 0;
}

__device__ __forceinline__ bool pixel(int nx, int ny, int& i, int& j) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  return i < nx && j < ny;
}

__device__ __forceinline__ bool conv_set(const float* sc) {
  return sc[S_CONV] != 0.f;
}

__device__ __forceinline__ bool cg_skip(const float* sc, int par) {
  return sc[S_CONV] != 0.f || sc[S_CG_DONE + par] != 0.f;
}

// Per-block tree sums of K values into partial[PS * block + slot + k].
template <int K>
__device__ __forceinline__ void block_partial(const float (&v)[K],
                                              float* partial, int slot) {
  __shared__ float red[K][NT];
  int t = threadIdx.y * BX + threadIdx.x;
  for (int k = 0; k < K; ++k) red[k][t] = v[k];
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < K; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t == 0) {
    int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int k = 0; k < K; ++k) partial[PS * blk + slot + k] = red[k][0];
  }
}

__device__ __forceinline__ float t1_at(const State& b, size_t p, float alpha,
                                       float oma) {
  return ((alpha * b.xh[p] + oma * b.xp[p]) + b.xd[p]) * INV_SQRT_T;
}

// M(v) = v + c_K^2 grad^T grad v at (i, j), the operator of the projection,
// grad^T as the maskless roll adjoint of the plain version (row i - 1's
// difference is zero where it has no row below, beyond the global plane).
__device__ __forceinline__ float m_at(const float* v, const State& b, int i,
                                      int j, size_t p) {
  int ny = b.ny;
  float c = v[p];
  float gxm = above(b, i) && below(b, i - 1) ? c - v[p - ny] : 0.f;
  float gx = below(b, i) ? v[p + ny] - c : 0.f;
  float gym = j > 0 ? c - v[p - 1] : 0.f;
  float gy = j < ny - 1 ? v[p + 1] - c : 0.f;
  return c + C2 * ((gxm - gx) + (gym - gy));
}

// c_K grad^T of the two planes of v at (i, j); bounds-checked neighbours
// equal the roll adjoint because v's dead coordinates are zero.  On a shard
// the upper mask keeps global row 0 from reading the halo rows above it,
// which are not zero after a step.
__device__ __forceinline__ float ckt_at(const float* v, const State& b,
                                        int i, int j, size_t p) {
  const size_t n = b.zn;
  int ny = b.ny;
  float vxm = above(b, i) ? v[p - ny] : 0.f;
  float vym = j > 0 ? v[n + p - 1] : 0.f;
  return C_K * ((vxm - v[p]) + (vym - v[n + p]));
}

// Whether row i's x-part duals are the dead ones (the global last row).
__device__ __forceinline__ bool dead_row(const State& b, int i) {
  return i + b.rows.off == b.rows.nxg - 1;
}

// Launch seed: the dead z coordinates (zx's last row, zy's last column)
// zeroed, as _admm_chunk_kernel does at entry; every later step keeps them
// zero, which makes the maskless adjoints exact.
// Bound: memory, a row and a column of three arrays.
__device__ __forceinline__ void seed_at(const State& b, int i, int j) {
  size_t n = b.zn, p = (size_t)i * b.ny + j;
  if (dead_row(b, i)) b.zh[p] = b.zp[p] = b.zd[p] = 0.f;
  if (j == b.ny - 1) b.zh[n + p] = b.zp[n + p] = b.zd[n + p] = 0.f;
}

__global__ void admm_seed(State b) {
  if (conv_set(b.sc)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  seed_at(b, i, j);
}

// d's x part at pixel p of row i from t1 there: t2_x - c_K dx(t1), t1
// recomputed at the row below.
__device__ __forceinline__ float rhs_dx(const State& b, int i, size_t p,
                                        float t1, float alpha, float oma) {
  float gx = below(b, i) ? t1_at(b, p + b.ny, alpha, oma) - t1 : 0.f;
  float t2x = SQRT_S * (b.zh[p] + b.zd[p]);
  return t2x - C_K * gx;
}

// First step of _admm_iter: t1, and d = t2 - c_K grad t1 (t1 recomputed at
// the neighbour).  For CGLS also the warm start's residual r = d - c_K grad
// u0 and x = u0 (the head of _cgls_masked).
// Bound: memory, 7 planes read (xh, xp, xd, zh, zd; + warm), 3 written
// (+1 for CGLS).
__device__ __forceinline__ void rhs_at(const State& b, int i, int j,
                                       float alpha, float oma, int cgls) {
  int ny = b.ny;
  size_t n = b.zn, p = (size_t)i * ny + j;
  float t1 = t1_at(b, p, alpha, oma);
  float dx = rhs_dx(b, i, p, t1, alpha, oma);
  float gy = j < ny - 1 ? t1_at(b, p + 1, alpha, oma) - t1 : 0.f;
  float t2y = SQRT_S * (b.zh[n + p] + b.zd[n + p]);
  float dy = t2y - C_K * gy;
  b.t1[p] = t1;
  if (cgls) {
    float u = b.warm[p];
    float ux = below(b, i) ? b.warm[p + ny] - u : 0.f;
    float uy = j < ny - 1 ? b.warm[p + 1] - u : 0.f;
    b.dd[p] = dx - C_K * ux;
    b.dd[n + p] = dy - C_K * uy;
    b.x[p] = u;
  } else {
    b.dd[p] = dx;
    b.dd[n + p] = dy;
  }
}

__global__ void admm_rhs(State b, float alpha, float oma, int cgls) {
  if (conv_set(b.sc)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  rhs_at(b, i, j, alpha, oma, cgls);
}

// _cheby_project's head: b = c_K grad^T d, r = b - M(u0), x = u0,
// v = r / theta.
// Bound: memory, 3 planes read (d, u0), 3 written.
// A pixel's new x, r and direction after cheby_init or a Chebyshev step.
struct Step {
  float x, r, v;
};

__device__ __forceinline__ Step cheby_init_val(const State& b, int i, int j) {
  size_t p = (size_t)i * b.ny + j;
  float rhs = ckt_at(b.dd, b, i, j, p);
  float r = rhs - m_at(b.warm, b, i, j, p);
  return Step{b.warm[p], r, r * INV_THETA};
}

__device__ __forceinline__ void cheby_init_at(const State& b, int i, int j) {
  size_t p = (size_t)i * b.ny + j;
  Step st = cheby_init_val(b, i, j);
  b.x[p] = st.x;
  b.r[p] = st.r;
  b.v0[p] = st.v;
}

__global__ void cheby_init(State b) {
  if (conv_set(b.sc)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  cheby_init_at(b, i, j);
}

// One Chebyshev step: x += v, r -= M(v), v' = c_prev v + c_r r, with v' in
// the other ping-pong plane (M reads v's neighbours).  The coefficients are
// host constants, as in the JAX kernel.
// Bound: memory, 3 planes read, 3 written; degree - 1 launches per outer
// iteration.
__device__ __forceinline__ Step cheby_step_val(const State& b,
                                               const float* __restrict__ v,
                                               float c_prev, float c_r, int i,
                                               int j) {
  size_t p = (size_t)i * b.ny + j;
  float vv = v[p];
  float x = b.x[p] + vv;
  float r = b.r[p] - m_at(v, b, i, j, p);
  return Step{x, r, c_prev * vv + c_r * r};
}

__device__ __forceinline__ void cheby_step_at(const State& b,
                                              const float* __restrict__ v,
                                              float* __restrict__ vn,
                                              float c_prev, float c_r, int i,
                                              int j) {
  size_t p = (size_t)i * b.ny + j;
  Step st = cheby_step_val(b, v, c_prev, c_r, i, j);
  b.x[p] = st.x;
  b.r[p] = st.r;
  vn[p] = st.v;
}

__global__ void cheby_step(State b, const float* __restrict__ v,
                           float* __restrict__ vn, float c_prev, float c_r) {
  if (conv_set(b.sc)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  cheby_step_at(b, v, vn, c_prev, c_r, i, j);
}

// The head of _cgls_masked after admm_rhs: s = c_K grad^T r - x, p = s, and
// the partial sums of |s|^2 (gamma0).
// Bound: memory, 3 planes read, 1 written, one block tree.
__global__ void cg_init(State b) {
  if (conv_set(b.sc)) return;
  int i, j;
  float v[1] = {0.f};
  if (pixel(b.nx, b.ny, i, j)) {
    size_t p = (size_t)i * b.ny + j;
    float s = ckt_at(b.dd, b, i, j, p) - b.x[p];
    b.p[p] = s;
    v[0] = s * s;
  }
  block_partial<1>(v, b.partial, 0);
}

// CG step, part 1: q = c_K grad p; partial sums of |q|^2 + |p|^2 (delta).
__global__ void cg_q(State b, int par) {
  if (cg_skip(b.sc, par)) return;
  int i, j;
  float v[1] = {0.f};
  if (pixel(b.nx, b.ny, i, j)) {
    int ny = b.ny;
    size_t n = b.zn, p = (size_t)i * ny + j;
    float pv = b.p[p];
    float qx = C_K * (below(b, i) ? b.p[p + ny] - pv : 0.f);
    float qy = C_K * (j < ny - 1 ? b.p[p + 1] - pv : 0.f);
    b.q[p] = qx;
    b.q[n + p] = qy;
    v[0] = (qx * qx + qy * qy) + pv * pv;
  }
  block_partial<1>(v, b.partial, 0);
}

// CG step, part 2: x += alpha p, r -= alpha q; partial sums of |x|^2.
__global__ void cg_xr(State b, int par) {
  if (cg_skip(b.sc, par)) return;
  int i, j;
  float v[1] = {0.f};
  if (pixel(b.nx, b.ny, i, j)) {
    size_t n = b.zn, p = (size_t)i * b.ny + j;
    float alpha = b.sc[S_CG_ALPHA];
    float x = b.x[p] + alpha * b.p[p];
    b.x[p] = x;
    b.dd[p] = b.dd[p] - alpha * b.q[p];
    b.dd[n + p] = b.dd[n + p] - alpha * b.q[n + p];
    v[0] = x * x;
  }
  block_partial<1>(v, b.partial, 1);
}

// CG step, part 3: s = c_K grad^T r - x; partial sums of |s|^2 (gamma).
__global__ void cg_s(State b, int par) {
  if (cg_skip(b.sc, par)) return;
  int i, j;
  float v[1] = {0.f};
  if (pixel(b.nx, b.ny, i, j)) {
    size_t p = (size_t)i * b.ny + j;
    float s = ckt_at(b.dd, b, i, j, p) - b.x[p];
    b.s[p] = s;
    v[0] = s * s;
  }
  block_partial<1>(v, b.partial, 2);
}

// CG step, part 4: p = s + beta p.
__global__ void cg_p(State b, int par) {
  if (cg_skip(b.sc, par)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  size_t p = (size_t)i * b.ny + j;
  b.p[p] = b.s[p] + b.sc[S_CG_BETA] * b.p[p];
}

// The rest of _admm_iter: u = x (+ v, the Chebyshev tail), x_proj, z_proj
// = grad x_proj (the neighbour's x_proj recomputed from x, v and t1), the
// duals, prox_g of the data term and the 2-vector shrink of prox_f; the
// warm start keeps u.
// Bound: memory, 9 planes read (x, v, t1, zh, zd, f; +w), 10 written.
// The scalars of update_at that depend on rho, lmb and radius alone, the
// same expressions wherever they are formed: per thread in admm_update,
// once a chunk in the resident multichunk.
struct UpdScal {
  float tl;      // (Tau / rho) lmb
  float inv_tl;  // 1 / (1 + tl), square's prox_g
  float shrink;  // radius 2 / rho, prox_f's
};

__device__ __forceinline__ UpdScal upd_scal(const float* sc) {
  float rho = sc[S_RHO];
  float tl = (0.25f / rho) * sc[S_LMB];
  return UpdScal{tl, 1.f / (1.f + tl), sc[S_RADIUS] * (2.f / rho)};
}

// The update's new values at a pixel from x_proj there, t1, z_proj (x_proj's
// forward differences), t2, f and (wsquare) w: x_dual, z_dual, prox_g of
// the data term and the 2-vector shrink of prox_f.
struct Upd {
  float xh, xd, zhx, zhy, zdx, zdy;
};

__device__ __forceinline__ Upd update_val(float xpn, float t1, float zpx,
                                          float zpy, float t2x, float t2y,
                                          float fv, float wv, int dataterm,
                                          const UpdScal& k) {
  float xdn = SQRT_T * t1 - xpn;
  float zdx = t2x * INV_SQRT_S - zpx;
  float zdy = t2y * INV_SQRT_S - zpy;

  // prox_g with effective step Tau / rho = 1 / (4 rho)
  const float tl = k.tl;
  float arg = xpn - xdn;
  float xhn;
  if (dataterm == DT_SQUARE) {
    xhn = (arg + tl * fv) * k.inv_tl;
  } else if (dataterm == DT_WSQUARE) {
    float tw = tl * wv;
    xhn = (arg + tw * fv) / (1.f + tw);
  } else {  // abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
    float dv = arg - fv;
    xhn = arg - fminf(fmaxf(dv, -tl), tl);
  }

  // prox_f: shrink the 2-vector by radius * 2 / rho (inverted step)
  float zax = zpx - zdx, zay = zpy - zdy;
  float nrm = sqrtf(zax * zax + zay * zay);
  float scale = fmaxf(nrm - k.shrink, 0.f) / (nrm > 0.f ? nrm : 1.f);
  return Upd{xhn, xdn, zax * scale, zay * scale, zdx, zdy};
}

__device__ __forceinline__ void update_at(const State& b,
                                          const float* __restrict__ v,
                                          int dataterm, int i, int j,
                                          const UpdScal& k) {
  int ny = b.ny;
  size_t n = b.zn, p = (size_t)i * ny + j;
  float u = v ? b.x[p] + v[p] : b.x[p];
  float t1 = b.t1[p];
  float xpn = SQRT_T * (u + t1);
  float zpx = 0.f, zpy = 0.f;
  if (below(b, i)) {
    size_t o = p + ny;
    float uo = v ? b.x[o] + v[o] : b.x[o];
    zpx = SQRT_T * (uo + b.t1[o]) - xpn;
  }
  if (j < ny - 1) {
    size_t o = p + 1;
    float uo = v ? b.x[o] + v[o] : b.x[o];
    zpy = SQRT_T * (uo + b.t1[o]) - xpn;
  }
  float t2x = SQRT_S * (b.zh[p] + b.zd[p]);
  float t2y = SQRT_S * (b.zh[n + p] + b.zd[n + p]);
  const Upd o = update_val(xpn, t1, zpx, zpy, t2x, t2y, b.f[p],
                           dataterm == DT_WSQUARE ? b.w[p] : 0.f, dataterm,
                           k);
  b.xh[p] = o.xh;
  b.xp[p] = xpn;
  b.xd[p] = o.xd;
  b.zh[p] = o.zhx;
  b.zh[n + p] = o.zhy;
  b.zp[p] = zpx;
  b.zp[n + p] = zpy;
  b.zd[p] = o.zdx;
  b.zd[n + p] = o.zdy;
  b.warm[p] = u;
}

__global__ void admm_update(State b, const float* __restrict__ v,
                            int dataterm) {
  if (conv_set(b.sc)) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  update_at(b, v, dataterm, i, j, upd_scal(b.sc));
}

// First pass of _admm_norms after a chunk: per-block sums of the squared
// primal residual, primal variable, dual residual and dual variable norms
// over the owned rows (y and w recomputed at the neighbour for K^T y).
// Bound: memory, 10 planes read once per chunk.
__device__ __forceinline__ void norm_terms_at(const State& b, int i, int j,
                                              float (&v)[4]) {
  int ny = b.ny;
  size_t n = b.zn, p = (size_t)i * ny + j;
  float rho = b.sc[S_RHO];
  float cw = -rho * 4.f;  // -rho / Tau
  float cy = -rho * 0.5f;  // -rho * Sigma
  float xh = b.xh[p];
  float kxx = below(b, i) ? b.xh[p + ny] - xh : 0.f;
  float kxy = j < ny - 1 ? b.xh[p + 1] - xh : 0.f;
  float prx = SQRT_S * (kxx - b.zh[p]);
  float pry = SQRT_S * (kxy - b.zh[n + p]);
  float pnx = SQRT_S * b.zh[p];
  float pny = SQRT_S * b.zh[n + p];
  float wv = cw * ((xh - b.xp[p]) + b.xd[p]);
  float yx = cy * ((b.zh[p] - b.zp[p]) + b.zd[p]);
  float yy = cy * ((b.zh[n + p] - b.zp[n + p]) + b.zd[n + p]);
  float yxm = 0.f, yym = 0.f;
  if (above(b, i)) {
    size_t o = p - ny;
    yxm = cy * ((b.zh[o] - b.zp[o]) + b.zd[o]);
  }
  if (j > 0) {
    size_t o = n + p - 1;
    yym = cy * ((b.zh[o] - b.zp[o]) + b.zd[o]);
  }
  float kty = (yxm - yx) + (yym - yy);
  float dn = SQRT_T * wv;
  float dr = SQRT_T * (wv + kty);
  v[0] = prx * prx + pry * pry;
  v[1] = pnx * pnx + pny * pny;
  v[2] = dr * dr;
  v[3] = dn * dn;
}

__global__ void admm_norm_partial(State b) {
  if (conv_set(b.sc)) return;
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (pixel(b.nx, b.ny, i, j) && i >= b.rows.own_lo && i < b.rows.own_hi)
    norm_terms_at(b, i, j, v);
  block_partial<4>(v, b.partial, 0);
}

// After admm_adapt (multichunk): the Boyd dual rescale of the chunk just
// run, x_dual and z_dual times rho / rho_new, in place.
// Bound: memory, 3 planes read and written.
__global__ void admm_rescale(State b) {
  float fac = b.sc[S_FAC];
  if (fac < 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  size_t n = b.zn, p = (size_t)i * b.ny + j;
  b.xd[p] = b.xd[p] * fac;
  b.zd[p] = b.zd[p] * fac;
  b.zd[n + p] = b.zd[n + p] * fac;
}

struct AdaptConsts {
  float sqrt_nrows, sqrt_ncols, arb_tau, arb_gamma;
};

// Second pass, one block: the sums of the partials in a fixed order, then
// thread 0 finishes `op`:
//   OP_NORMS     the 4 squared norms into sc[S_NORM..] (admm_chunk);
//   OP_ADAPT     admm_adapt_scalars, the same f32 operations in the same
//                order, with it = it0 + `aux` (the chunk's post-increment
//                counter offset); sqrt'd norms, S_FAC, S_DONE, S_CONV;
//   OP_ADAPT_HOLD  OP_ADAPT for the tiled multichunk, except that where
//                the flag is set at entry S_FAC keeps the factor the last
//                executed chunk still owes (admm_tiled_settle applies it);
//   OP_CG_INIT   gamma0, norms0 and the first step's done flag;
//   OP_CG_ALPHA  alpha = gamma / delta;
//   OP_CG_BETA   beta, gamma and the next step's done flag, with the
//                iteration's CG tolerance tols[tix].
// Bound: launch latency (a few KB of partials).  finish_at is its body on
// the FIN threads of a block, in the block's shared array `red`; the
// cooperative iteration below runs it too.
__device__ __forceinline__ void finish_at(float (*red)[FIN],
                                          float* __restrict__ sc,
                                          const float* __restrict__ partial,
                                          int nblocks, int op, int par,
                                          float aux,
                                          const float* __restrict__ tols,
                                          int tix, const AdaptConsts& c) {
  int t = threadIdx.x;
  if (sc[S_CONV] != 0.f) {
    if (t == 0 && op == OP_ADAPT) sc[S_FAC] = -1.f;
    return;
  }
  if (op == OP_CG_ALPHA || op == OP_CG_BETA) {
    if (sc[S_CG_DONE + par] != 0.f) {
      if (t == 0 && op == OP_CG_BETA) sc[S_CG_DONE + (par ^ 1)] = 1.f;
      return;
    }
  }
  const bool adapt = op == OP_ADAPT || op == OP_ADAPT_HOLD;
  int slot0 = op == OP_CG_BETA ? 1 : 0;
  int nsum = op == OP_CG_BETA ? 2 : (op == OP_NORMS || adapt ? 4 : 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int blk = t; blk < nblocks; blk += FIN)
    for (int k = 0; k < nsum; ++k) acc[k] += partial[PS * blk + slot0 + k];
  for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < nsum; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t != 0) return;

  if (op == OP_NORMS) {
    for (int k = 0; k < 4; ++k) sc[S_NORM + k] = red[k][0];
  } else if (adapt) {
    float pr = sqrtf(red[0][0]), pn = sqrtf(red[1][0]);
    float dr = sqrtf(red[2][0]), dn = sqrtf(red[3][0]);
    float it = sc[S_IT] + aux;
    float eps_pri = c.sqrt_nrows * sc[S_TOL_AP] + sc[S_TOL_RP] * pn;
    float eps_dua = c.sqrt_ncols * sc[S_TOL_AD] + sc[S_TOL_RD] * dn;
    float rho = sc[S_RHO], delta = sc[S_DELTA];
    float al = sc[S_ARB_L], au = sc[S_ARB_U];
    bool c1 = (dr < eps_dua) && (c.arb_tau * it > al);
    bool c2 = (pr < eps_pri) && (c.arb_tau * it > au) && !c1;
    float rho_new = c1 ? rho * delta : (c2 ? rho / delta : rho);
    sc[S_DELTA] = (c1 || c2) ? delta * c.arb_gamma : delta;
    sc[S_ARB_U] = c1 ? it : au;
    sc[S_ARB_L] = c2 ? it : al;
    sc[S_FAC] = rho / rho_new;
    sc[S_RHO] = rho_new;
    sc[S_NORM + 0] = pr;
    sc[S_NORM + 1] = pn;
    sc[S_NORM + 2] = dr;
    sc[S_NORM + 3] = dn;
    sc[S_DONE] += 1.f;
    bool conv = (pr < eps_pri) && (dr < eps_dua);
    sc[S_CONV] = conv ? 1.f : 0.f;  // last: the other threads have read it
  } else if (op == OP_CG_INIT) {
    float gamma = red[0][0];
    float norms0 = sqrtf(gamma);
    sc[S_CG_GAMMA] = gamma;
    sc[S_CG_NORMS0] = norms0;
    sc[S_CG_DONE + 0] = norms0 < EPS ? 1.f : 0.f;
  } else if (op == OP_CG_ALPHA) {
    float delta = red[0][0];
    if (delta <= 0.f) delta = EPS;
    sc[S_CG_ALPHA] = sc[S_CG_GAMMA] / delta;
  } else {  // OP_CG_BETA
    float xx = red[0][0], gamma_n = red[1][0];
    float gamma = sc[S_CG_GAMMA];
    float tol = tols[tix];
    float normx = sqrtf(xx);
    bool conv = (sqrtf(gamma_n) <= sc[S_CG_NORMS0] * tol) ||
                (normx * tol >= 1.f);
    sc[S_CG_BETA] = gamma_n / (gamma > 0.f ? gamma : 1.f);
    sc[S_CG_GAMMA] = gamma_n;
    sc[S_CG_DONE + (par ^ 1)] = conv ? 1.f : 0.f;
  }
}

__global__ void admm_finish(float* __restrict__ sc,
                            const float* __restrict__ partial, int nblocks,
                            int op, int par, float aux,
                            const float* __restrict__ tols, int tix,
                            AdaptConsts c) {
  __shared__ float red[4][FIN];
  finish_at(red, sc, partial, nblocks, op, par, aux, tols, tix, c);
}

// ---------------------------------------------------------------------------
// One Chebyshev iteration on a halo band as one cooperative launch
// (admm_banded_iter -> _admm_banded_kernel, which is one launch on the TPU).
//
// What bounds it.  At the sharded route's band (560x512 at 512x512 on one
// card) the iteration moves about 19 planes of 1.1 MB, about 0.007 ms of
// device memory, and the planes sit in L2.  The launch sequence of
// iteration() (seed, rhs, cheby_init, degree - 1 cheby_step, update, and
// the norm pass and finish) pays a launch for each of those short passes.
//
// Design.  One cooperative launch per iteration (cudaLaunchCooperativeKernel)
// with as many blocks as the card holds at once, the steps as stages
// separated by grid barriers (cooperative_groups::this_grid().sync()):
// seed and rhs (fused: the seed writes only the pixel's own dead z values,
// which its rhs reads), cheby_init, the degree - 1 Chebyshev steps, the
// update, and with norms the norm pass and the finish in block 0.  Each
// block owns a fixed band of whole rows in every pixel stage (band_of), so
// a stencil's row neighbours are mostly its own block's.  The planes stay
// in device memory (L2): a block's band is a few rows at this size, as
// many as the two neighbour rows a stage reads, so a shared-memory copy
// would save little against the barriers.  The pixel work is the device
// functions of the launch sequence, and the norm pass reduces the same
// 32x8 tiles in the same tree (two tiles per block at a time) for the same
// finish: the iteration is bit-equal to the launch sequence.  The
// converged flag is read once at entry, and the whole grid returns before
// any barrier.
// ---------------------------------------------------------------------------

constexpr int CO_THREADS = FIN;  // the finish's threads: two 32x8 tiles
constexpr int CO_SMEM = 4 * FIN * sizeof(float);  // the reductions' array

// Rows [lo, hi) of band `blk` of `blocks` over nx rows (ops/fused_admm.py
// admm_bands): every row in exactly one band, the bands' sizes within one.
__host__ __device__ __forceinline__ void band_of(int nx, int blk, int blocks,
                                                 int& lo, int& hi) {
  lo = (int)((long long)blk * nx / blocks);
  hi = (int)((long long)(blk + 1) * nx / blocks);
}

__global__ void __launch_bounds__(CO_THREADS)
    admm_iter_coop(State b, float alpha, float oma, int dataterm,
                   int degree, const float* __restrict__ coeffs,
                   int with_norms) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  if (conv_set(b.sc)) return;
  extern __shared__ float smem[];
  const int ny = b.ny;
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const int band = (hi - lo) * ny;

  for (int k = threadIdx.x; k < band; k += CO_THREADS) {
    int i = lo + k / ny, j = k % ny;
    seed_at(b, i, j);
    rhs_at(b, i, j, alpha, oma, 0);
  }
  grid.sync();
  for (int k = threadIdx.x; k < band; k += CO_THREADS)
    cheby_init_at(b, lo + k / ny, k % ny);
  grid.sync();
  float* cur = b.v0;
  float* nxt = b.v1;
  for (int s = 0; s < degree - 1; ++s) {
    for (int k = threadIdx.x; k < band; k += CO_THREADS)
      cheby_step_at(b, cur, nxt, coeffs[2 * s], coeffs[2 * s + 1],
                    lo + k / ny, k % ny);
    grid.sync();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int k = threadIdx.x; k < band; k += CO_THREADS)
    update_at(b, cur, dataterm, lo + k / ny, k % ny, upd_scal(b.sc));
  if (!with_norms) return;
  grid.sync();

  // admm_norm_partial's tiles, two at a time (block_partial's tree)
  const int ntx = (ny + BX - 1) / BX;
  const int ntiles = (b.nx + BY - 1) / BY * ntx;
  const int half = threadIdx.x / NT, t = threadIdx.x % NT;
  float* red = smem + half * 4 * NT;  // red[k * NT + t]
  for (int base = 2 * blockIdx.x; base < ntiles; base += 2 * gridDim.x) {
    const int tile = base + half;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < ntiles) {
      int i = tile / ntx * BY + t / BX, j = tile % ntx * BX + t % BX;
      if (i < b.nx && j < ny && i >= b.rows.own_lo && i < b.rows.own_hi)
        norm_terms_at(b, i, j, v);
    }
    for (int k = 0; k < 4; ++k) red[k * NT + t] = v[k];
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int k = 0; k < 4; ++k) red[k * NT + t] += red[k * NT + t + s];
      __syncthreads();
    }
    if (t == 0 && tile < ntiles)
      for (int k = 0; k < 4; ++k) b.partial[PS * tile + k] = red[k * NT];
    __syncthreads();  // the next pass overwrites red
  }
  grid.sync();
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f};
    finish_at(reinterpret_cast<float(*)[FIN]>(smem), b.sc, b.partial,
              ntiles, OP_NORMS, 0, 0.f, nullptr, 0, none);
  }
}

// The blocks of a cooperative launch: as many as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), found once
// per device.
int coop_blocks(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, admm_iter_coop,
                                                    CO_THREADS, CO_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  if (*blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

// ---------------------------------------------------------------------------
// The Chebyshev multichunk and chunk grid-resident (admm_fused_multichunk
// -> _admm_multichunk_kernel and admm_fused_chunk -> _admm_chunk_kernel,
// which hold the planes in VMEM for the whole launch on the TPU): one
// cooperative launch runs what prost_admm_multichunk runs in about
// k_chunks (count (degree + 2) + 3) launches, or prost_admm_chunk in
// count (degree + 2) + 3.
//
// What bounds them.  At config 4's shape (512x512, degree 10, ri 10, 8
// chunks) the launch sequence makes 985 launches (a chunk 123) of about 3
// us of device time each over 1 MiB planes: launch latency, not bytes (19
// planes in and out, 0.006 ms) or operations (0.05 ms).  The state of the
// launch, 12 planes with wsquare's weights and 7 of the iteration's
// scratch, fits in the shared memory of the card's SMs at 512x512: bands
// of 4 rows.  What
// sets the resident launch's time is then the stages' barriers and the
// exchange of neighbour rows between them, degree + 1 an iteration.
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// band_of(nx, b, G) and holds them in dynamic shared memory from entry to
// exit: xh, xp, xd, warm, v0 and v1 with the rows above and below, t1 and
// x with the row below, zh, zp, zd and dd (both parts) with the row above,
// and f, w and r (the stencils' reach).  A State whose pointers lie `lo`
// rows before each window (and whose zn is a window's size) lets the pixel
// stages of the launch sequence (seed_at, rhs_at and rhs_dx,
// cheby_init_val, cheby_step_val, update_at, norm_terms_at) run unchanged
// on the band.  An iteration is degree + 1 stages between grid barriers:
//   1. rhs on the band, d's x part on the row above (rhs_dx) and t1 on the
//      row below, then cheby_init, whose reach those rows are;
//   2. the degree - 1 Chebyshev steps;
//   3. update.
// A stage updates the band in shared memory and writes to device memory
// only the rows its neighbours' next stage reads (the direction's first
// and last rows after 1 and 2, x's first row after the last of them; xh,
// xp, xd and warm's first and last rows and zh and zd's last after 3, and
// zp's last before the norms); after the barrier each block copies those
// rows of its neighbours in, all of a stage's rows in one pass
// (copy_row_set).  The Chebyshev stages hold four rows of a column per
// thread, all read before any is written; update's scalars of rho, lmb
// and radius are formed once a chunk (upd_scal).  After each chunk every
// block writes its pixels' norm terms to a global `terms` array, the
// blocks reduce the 32x8 tiles of admm_norm_partial's grid in
// block_partial's tree, block 0 runs finish_at(OP_ADAPT) and, after a
// barrier, every block reads the rescale factor and the flag: it rescales
// x_dual and z_dual on its band and on the rows of them it holds, and once
// the flag is set the whole grid leaves the loop together.  The state goes
// back to device memory once, at exit.  The same pixel expressions on the
// same values,
// the same tiles, tree and finish: bit-equal to prost_admm_multichunk.
// The pieces (band_load, band_iterations, band_norms, band_store) are one
// chunk's; admm_chunk_resident runs them once and ends in finish_at's
// OP_NORMS, bit-equal to prost_admm_chunk.  The coefficients come from a
// device array, so any degree >= 1 runs.
// Measured on an H100 and reverted (PERF.md): the stages synchronised by
// flags between neighbouring blocks in place of grid barriers (49.7
// against 43.8 us an iteration, an earlier form of this launch), and two
// Chebyshev steps between barriers, the first also on the rows beyond the
// band (35.1 against 32.6 us: the extra rows and register spills cost more
// than the barriers saved).
// ---------------------------------------------------------------------------

constexpr int RES_THREADS = FIN;  // finish_at's threads: two 32x8 tiles
constexpr int RES_RED = 4 * FIN;  // floats of the reductions' array
constexpr int RES_GROUP = 4;      // rows of a column a thread holds

// A block's windows, rmax the rows of the largest band: (rmax + 2) rows of
// xh, xp, xd, warm, v0 and v1, (rmax + 1) of t1, x and of both parts of zh,
// zp, zd and dd, rmax of f, r and (wsquare) w; then the reductions.
__host__ __device__ __forceinline__ size_t admm_resident_floats(int rmax,
                                                                int ny,
                                                                int wsq) {
  return ((size_t)6 * (rmax + 2) + (size_t)10 * (rmax + 1)
          + (size_t)(2 + wsq) * rmax) * ny + RES_RED;
}

// A window of `rows` rows from row r0 at p, as a plane pointer: row i of
// the window is at (i * ny) floats from the pointer.
__device__ __forceinline__ float* take_rows(float*& p, int r0, int rows,
                                            int ny) {
  float* plane = p - (ptrdiff_t)r0 * ny;
  p += (size_t)rows * ny;
  return plane;
}

// The pixels [a, e) of row-major rows ny wide, RES_THREADS apart.
#define FOR_ROWS(a, e, ny, i, j)                                           \
  for (int k_ = threadIdx.x, i = (a) + k_ / (ny), j = k_ % (ny);           \
       k_ < ((e) - (a)) * (ny);                                            \
       k_ += RES_THREADS, j += RES_THREADS % (ny),                         \
           i += RES_THREADS / (ny) + (j >= (ny) ? 1 : 0),                  \
           j -= j >= (ny) ? (ny) : 0)

// A stage of the Chebyshev iteration on the rows [lo, hi): each thread
// takes RES_GROUP rows of a column, computes every pixel's Step from the
// stage's inputs first and then writes them (`put`), so the reads of its
// pixels are independent of each other.
template <typename Val, typename Put>
__device__ __forceinline__ void for_groups(int lo, int hi, int ny, Val val,
                                           Put put) {
  const int groups = (hi - lo + RES_GROUP - 1) / RES_GROUP;
  for (int k = threadIdx.x; k < groups * ny; k += RES_THREADS) {
    const int i0 = lo + RES_GROUP * (k / ny), j = k % ny;
    Step o[RES_GROUP];
#pragma unroll
    for (int g = 0; g < RES_GROUP; ++g)
      if (i0 + g < hi) o[g] = val(i0 + g, j);
#pragma unroll
    for (int g = 0; g < RES_GROUP; ++g)
      if (i0 + g < hi) put((size_t)(i0 + g) * ny + j, o[g]);
  }
}

// Rows [a, e) of the plane at `src` that lie in [0, nx) into the plane at
// `dst` (an x part; with z set both parts, zs and zd floats apart).
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int a, int e, int nx, int ny,
                                          size_t zd = 0, size_t zs = 0,
                                          bool z = false) {
  a = a < 0 ? 0 : a;
  e = e > nx ? nx : e;
  FOR_ROWS(a, e, ny, i, j) {
    size_t p = (size_t)i * ny + j;
    dst[p] = src[p];
    if (z) dst[zd + p] = src[zs + p];
  }
}

// One row of an exchange: row `row` of the plane at src into the plane at
// dst (each indexed as take_rows' planes and device planes are); a row
// outside [0, nx) is skipped, so -1 marks an entry that a stage leaves
// out.
struct RowIO {
  float* dst;
  const float* src;
  int row;
};

// A stage's exchange rows in one pass: every thread reads all its entries
// before it writes any, so the rows cost one round trip to L2, not one
// each.
template <int K>
__device__ __forceinline__ void copy_row_set(const RowIO (&io)[K], int nx,
                                             int ny) {
  for (int j = threadIdx.x; j < ny; j += RES_THREADS) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (io[k].row >= 0 && io[k].row < nx)
        v[k] = io[k].src[(size_t)io[k].row * ny + j];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (io[k].row >= 0 && io[k].row < nx)
        io[k].dst[(size_t)io[k].row * ny + j] = v[k];
  }
}

// A block's band of rows [lo, hi) and its windows in shared memory
// (admm_resident_floats): a State whose pointers lie `lo` rows before each
// window and whose zn is a window's size, so that the pixel stages of the
// launch sequence run unchanged on the band.
struct Band {
  State b;     // sc, partial, nx, ny and rows as the grid's
  float* red;  // RES_RED floats: the norm tiles' trees and finish_at's
  int lo, hi;
  int first, last;  // the band's first and last rows, -1 for an empty band
};

// The band's windows, the band and the rows its first stage reads loaded
// (xh, xp, xd and warm above and below, zh and zd's x part above), then
// admm_seed on the band.
__device__ __forceinline__ Band band_load(const State& g, int dataterm,
                                          int rmax, float* smem) {
  const int nx = g.nx, ny = g.ny;
  const size_t n = (size_t)nx * ny;
  Band d;
  band_of(nx, blockIdx.x, gridDim.x, d.lo, d.hi);
  const int lo = d.lo, hi = d.hi;
  d.first = lo < hi ? lo : -1;
  d.last = lo < hi ? hi - 1 : -1;
  const bool wsq = dataterm == DT_WSQUARE;
  State& b = d.b;
  b = g;
  float* p = smem;
  b.xh = take_rows(p, lo - 1, rmax + 2, ny);
  b.xp = take_rows(p, lo - 1, rmax + 2, ny);
  b.xd = take_rows(p, lo - 1, rmax + 2, ny);
  b.warm = take_rows(p, lo - 1, rmax + 2, ny);
  b.v0 = take_rows(p, lo - 1, rmax + 2, ny);
  b.v1 = take_rows(p, lo - 1, rmax + 2, ny);
  b.t1 = take_rows(p, lo, rmax + 1, ny);
  b.x = take_rows(p, lo, rmax + 1, ny);
  b.zn = (size_t)(rmax + 1) * ny;
  b.zh = take_rows(p, lo - 1, 2 * (rmax + 1), ny);
  b.zp = take_rows(p, lo - 1, 2 * (rmax + 1), ny);
  b.zd = take_rows(p, lo - 1, 2 * (rmax + 1), ny);
  b.dd = take_rows(p, lo - 1, 2 * (rmax + 1), ny);
  float* f = take_rows(p, lo, rmax, ny);
  b.r = take_rows(p, lo, rmax, ny);
  float* w = wsq ? take_rows(p, lo, rmax, ny) : f;
  b.f = f;
  b.w = w;
  d.red = p;
  b.p = b.q = b.s = nullptr;

  copy_rows(b.xh, g.xh, lo - 1, hi + 1, nx, ny);
  copy_rows(b.xp, g.xp, lo - 1, hi + 1, nx, ny);
  copy_rows(b.xd, g.xd, lo - 1, hi + 1, nx, ny);
  copy_rows(b.warm, g.warm, lo - 1, hi + 1, nx, ny);
  copy_rows(b.zh, g.zh, lo - 1, lo, nx, ny);
  copy_rows(b.zd, g.zd, lo - 1, lo, nx, ny);
  copy_rows(b.zh, g.zh, lo, hi, nx, ny, b.zn, n, true);
  copy_rows(b.zp, g.zp, lo, hi, nx, ny, b.zn, n, true);
  copy_rows(b.zd, g.zd, lo, hi, nx, ny, b.zn, n, true);
  copy_rows(f, g.f, lo, hi, nx, ny);
  if (wsq) copy_rows(w, g.w, lo, hi, nx, ny);
  __syncthreads();
  FOR_ROWS(lo, hi, ny, i, j) seed_at(b, i, j);
  __syncthreads();
  return d;
}

// `count` outer iterations on the band, degree + 1 stages each between grid
// barriers, with rho, lmb and radius as sc holds them at entry.
__device__ __forceinline__ void band_iterations(
    const State& g, const Band& d, float alpha, float oma, int dataterm,
    int degree, const float* __restrict__ coeffs, int count,
    cooperative_groups::grid_group& grid) {
  const int nx = g.nx, ny = g.ny;
  const int lo = d.lo, hi = d.hi, first = d.first, last = d.last;
  const State& b = d.b;
  const UpdScal us = upd_scal(g.sc);
  for (int it = 0; it < count; ++it) {
    const bool last_it = it == count - 1;
    // 1. admm_rhs on the band, d_x on the row above, t1 on the row
    // below; cheby_init
    FOR_ROWS(lo, hi, ny, i, j) rhs_at(b, i, j, alpha, oma, 0);
    for (int j = threadIdx.x; j < ny; j += RES_THREADS) {
      if (lo > 0 && lo < hi) {
        size_t q = (size_t)(lo - 1) * ny + j;
        b.dd[q] = rhs_dx(b, lo - 1, q, t1_at(b, q, alpha, oma), alpha,
                         oma);
      }
      if (hi < nx && lo < hi) {
        size_t q = (size_t)hi * ny + j;
        b.t1[q] = t1_at(b, q, alpha, oma);
      }
    }
    __syncthreads();
    for_groups(lo, hi, ny,
               [&](int i, int j) { return cheby_init_val(b, i, j); },
               [&](size_t q, const Step& o) {
                 b.x[q] = o.x;
                 b.r[q] = o.r;
                 b.v0[q] = o.v;
               });
    // 2. the degree - 1 steps; after 1 and each step the direction's
    // first and last rows out, and x's first row after the last
    float* cur = b.v0;
    float* nxt = b.v1;
    float* dcur = g.v0;
    float* dnxt = g.v1;
    for (int st = 0; st < degree; ++st) {
      if (st > 0) {
        const float cp = coeffs[2 * (st - 1)], cr = coeffs[2 * st - 1];
        for_groups(lo, hi, ny,
                   [&](int i, int j) {
                     return cheby_step_val(b, cur, cp, cr, i, j);
                   },
                   [&](size_t q, const Step& o) {
                     b.x[q] = o.x;
                     b.r[q] = o.r;
                     nxt[q] = o.v;
                   });
        float* t = cur;
        cur = nxt;
        nxt = t;
        t = dcur;
        dcur = dnxt;
        dnxt = t;
      }
      const int xrow = st == degree - 1 ? first : -1;
      __syncthreads();
      const RowIO out[] = {{dcur, cur, first}, {dcur, cur, last},
                           {g.x, b.x, xrow}};
      copy_row_set(out, nx, ny);
      grid.sync();
      const RowIO in[] = {{cur, dcur, lo - 1}, {cur, dcur, hi},
                          {b.x, g.x, xrow < 0 ? -1 : hi}};
      copy_row_set(in, nx, ny);
      __syncthreads();
    }
    // 3. admm_update; the first and last rows of xh, xp, xd and warm out,
    // zh and zd's last rows, and before the norms zp's
    FOR_ROWS(lo, hi, ny, i, j) update_at(b, cur, dataterm, i, j, us);
    __syncthreads();
    const int zp_last = last_it ? last : -1;
    const RowIO out[] = {
        {g.xh, b.xh, first}, {g.xp, b.xp, first}, {g.xd, b.xd, first},
        {g.warm, b.warm, first}, {g.xh, b.xh, last}, {g.xp, b.xp, last},
        {g.xd, b.xd, last}, {g.warm, b.warm, last}, {g.zh, b.zh, last},
        {g.zd, b.zd, last}, {g.zp, b.zp, zp_last}};
    copy_row_set(out, nx, ny);
    grid.sync();
    const int above = lo - 1, zp_above = last_it ? lo - 1 : -1;
    const RowIO in[] = {
        {b.xh, g.xh, above}, {b.xp, g.xp, above}, {b.xd, g.xd, above},
        {b.warm, g.warm, above}, {b.xh, g.xh, hi}, {b.xp, g.xp, hi},
        {b.xd, g.xd, hi}, {b.warm, g.warm, hi}, {b.zh, g.zh, above},
        {b.zd, g.zd, above}, {b.zp, g.zp, zp_above}};
    copy_row_set(in, nx, ny);
    __syncthreads();
  }
}

// admm_norm_partial's terms of the band into `terms`, then its 32x8 tiles
// in block_partial's tree into g.partial; every block leaves after a grid
// barrier, so that block 0 may run the finish over the tiles' partials,
// whose number it returns.
__device__ __forceinline__ int band_norms(
    const State& g, const Band& d, float* __restrict__ terms,
    cooperative_groups::grid_group& grid) {
  const int nx = g.nx, ny = g.ny;
  const size_t n = (size_t)nx * ny;
  FOR_ROWS(d.lo, d.hi, ny, i, j) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    norm_terms_at(d.b, i, j, v);
    size_t q = (size_t)i * ny + j;
    for (int k = 0; k < 4; ++k) terms[k * n + q] = v[k];
  }
  grid.sync();
  const int ntx = (ny + BX - 1) / BX;
  const int ntiles = (nx + BY - 1) / BY * ntx;
  const int half = threadIdx.x / NT, t = threadIdx.x % NT;
  float* r = d.red + half * 4 * NT;  // r[k * NT + t]
  for (int base = 2 * blockIdx.x; base < ntiles; base += 2 * gridDim.x) {
    const int tile = base + half;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < ntiles) {
      int i = tile / ntx * BY + t / BX, j = tile % ntx * BX + t % BX;
      if (i < nx && j < ny)
        for (int k = 0; k < 4; ++k) v[k] = terms[k * n + (size_t)i * ny + j];
    }
    for (int k = 0; k < 4; ++k) r[k * NT + t] = v[k];
    __syncthreads();
    for (int s2 = NT / 2; s2 > 0; s2 >>= 1) {
      if (t < s2)
        for (int k = 0; k < 4; ++k) r[k * NT + t] += r[k * NT + t + s2];
      __syncthreads();
    }
    if (t == 0 && tile < ntiles)
      for (int k = 0; k < 4; ++k) g.partial[PS * tile + k] = r[k * NT];
    __syncthreads();  // the next pass overwrites r
  }
  grid.sync();
  return ntiles;
}

// The band's state back to device memory.
__device__ __forceinline__ void band_store(const State& g, const Band& d) {
  const int nx = g.nx, ny = g.ny, lo = d.lo, hi = d.hi;
  const size_t n = (size_t)nx * ny;
  const State& b = d.b;
  copy_rows(g.xh, b.xh, lo, hi, nx, ny);
  copy_rows(g.xp, b.xp, lo, hi, nx, ny);
  copy_rows(g.xd, b.xd, lo, hi, nx, ny);
  copy_rows(g.warm, b.warm, lo, hi, nx, ny);
  copy_rows(g.zh, b.zh, lo, hi, nx, ny, n, b.zn, true);
  copy_rows(g.zp, b.zp, lo, hi, nx, ny, n, b.zn, true);
  copy_rows(g.zd, b.zd, lo, hi, nx, ny, n, b.zn, true);
}

__global__ void __launch_bounds__(RES_THREADS, 1)
    admm_multichunk_resident(State g, float alpha, float oma, int dataterm,
                             int degree, const float* __restrict__ coeffs,
                             int count, int k_chunks, AdaptConsts c,
                             float* __restrict__ terms, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (conv_set(g.sc)) {  // every block, before any barrier
    // each chunk of the launch sequence finds the flag and clears S_FAC
    if (blockIdx.x == 0 && threadIdx.x == 0 && k_chunks > 0)
      g.sc[S_FAC] = -1.f;
    return;
  }
  extern __shared__ float smem[];
  const Band d = band_load(g, dataterm, rmax, smem);
  const int nx = g.nx, ny = g.ny, lo = d.lo, hi = d.hi;
  const State& b = d.b;
  int ch = 0;
  for (; ch < k_chunks; ++ch) {
    band_iterations(g, d, alpha, oma, dataterm, degree, coeffs, count, grid);
    const int ntiles = band_norms(g, d, terms, grid);
    if (blockIdx.x == 0)
      finish_at(reinterpret_cast<float(*)[FIN]>(d.red), g.sc, g.partial,
                ntiles, OP_ADAPT, 0, (float)((ch + 1) * count), nullptr, 0,
                c);
    grid.sync();
    // admm_rescale on the band and on the rows of x_dual (above and below)
    // and z_dual's x part (above) that the next rhs reads
    const float fac = *(volatile float*)&g.sc[S_FAC];
    const bool conv = *(volatile float*)&g.sc[S_CONV] != 0.f;
    if (fac >= 0.f) {
      const int a = lo > 0 ? lo - 1 : lo, e = hi < nx ? hi + 1 : hi;
      FOR_ROWS(a, e, ny, i, j) {
        size_t q = (size_t)i * ny + j;
        b.xd[q] = b.xd[q] * fac;
        if (i < hi) b.zd[q] = b.zd[q] * fac;
        if (i >= lo && i < hi) b.zd[b.zn + q] = b.zd[b.zn + q] * fac;
      }
    }
    __syncthreads();
    if (conv) break;
  }
  // the launch sequence's later chunks each find the flag and clear S_FAC
  if (ch < k_chunks - 1) {
    grid.sync();  // every block has read this chunk's S_FAC
    if (blockIdx.x == 0 && threadIdx.x == 0) g.sc[S_FAC] = -1.f;
  }
  band_store(g, d);  // the state back to device memory, once
}

// One Chebyshev chunk grid-resident (admm_fused_chunk ->
// _admm_chunk_kernel): the multichunk's body for one chunk, ending in
// admm_finish's OP_NORMS in block 0, without the adaptation and the
// rescale; bit-equal to prost_admm_chunk.
__global__ void __launch_bounds__(RES_THREADS, 1)
    admm_chunk_resident(State g, float alpha, float oma, int dataterm,
                        int degree, const float* __restrict__ coeffs,
                        int count, float* __restrict__ terms, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (conv_set(g.sc)) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const Band d = band_load(g, dataterm, rmax, smem);
  band_iterations(g, d, alpha, oma, dataterm, degree, coeffs, count, grid);
  const int ntiles = band_norms(g, d, terms, grid);
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f};
    finish_at(reinterpret_cast<float(*)[FIN]>(d.red), g.sc, g.partial,
              ntiles, OP_NORMS, 0, 0.f, nullptr, 0, none);
  }
  band_store(g, d);  // the state back to device memory, once
}

// ---------------------------------------------------------------------------
// The tiled Chebyshev chunk and multichunk (admm_banded_chunk ->
// _admm_banded_chunk_kernel), for planes whose bands no grid-resident launch
// holds (2048x2048).  The TPU kernel runs one launch a chunk, its grid
// (count, n_bands), iterations outer: each step DMAs one band's
// halo-extended window of the state into VMEM, runs one iteration there and
// writes the owned rows into the other slot of a ping-pong pair in HBM.
//
// What bounds it.  An iteration's reach is degree + 1 pixels (the halo
// below), so no window that fuses the ten iterations of a chunk fits in a
// block's 227 KB: each iteration is one pass over device memory, about 9
// planes of 16.8 MB read (with the windows' overlap) and 8 written at
// 2048x2048, some 0.09 ms at the card's memory rate; the launch sequence
// moves about 80 plane passes an iteration in 12 launches.  Inside the
// window the degree - 1 Chebyshev steps are 5-point stencils, and their
// instructions (the loads and stores of shared memory, the neighbour tests
// and the index arithmetic a pixel, not the 14 flops) set a step's time;
// the window's loads, a pass over device memory, set the rest.
//
// Design.  One cooperative launch a chunk, AT_BLOCKS (one) block of
// AT_THREADS on each SM, a grid barrier between iterations.  The first
// iteration reads the
// state from slot `start` (slot A the caller's planes, slot B the launch
// sequence's 8 scratch planes) and the last writes it (to the other slot
// for a count of 1, else back to slot A, which no iteration between reads);
// an iteration between them hands the next its carry instead of the state:
// t1, t2's two parts and warm, the values the next iteration's head forms
// from the state, formed by the same expressions from the same values, in
// four of slot B's planes (two carries in turn), so that an iteration
// reads 4 planes and writes 4 where the state is 8 and 8.  The blocks walk
// the plane's tiles (tx rows, a multiple of 8, by ty columns, of 32).  A
// tile's window is the tile and h = degree + 1 pixels on every side
// (ops/fused_admm.py admm_tiled_halo: u = x + v is exact degree pixels
// inside a window side that lies in the plane, z_proj one pixel less below
// and right; tests/test_torch_tiled_admm.py holds the plain twin exact with
// h and wider, and not with h - 1), held by the launch's fixed map
// (admm_tiled_map): cb blocks of 32 columns by rb blocks of AT_K rows from
// h pixels above and left of the tile, one warp a block, each thread one
// column of AT_K rows (its strip).  Pixels of the map outside the window
// or the plane load as zeros; neither they nor the map's border, which
// reads a ring of zeros around each shared plane, reach an owned pixel.  A
// thread keeps its strip's iterate x and residual r in registers; four
// shared planes of the map hold the rest in turn.  One window:
//   1-3. from the state, cp.async loads of xh, xp, xd and warm (the
//      rescale a multichunk's later chunk still owes applied to x_dual and
//      z_dual as they are read: admm_rescale's product), then t1 in place
//      of xd and x = warm; cp.async loads of zh and zd's x parts while
//      M(warm) goes into r, then d's x part = t2 - c_K grad t1 (admm_rhs,
//      the dead row's t2 zeroed as admm_seed zeroes its duals); the same
//      for the y parts.  From a carry, one round of loads (t2's parts, t1,
//      warm), then M(warm) and d in place of t2;
//   4. r = c_K grad^T d - M(warm) and v = r / theta (cheby_init);
//   5. the degree - 1 steps, one barrier each (cheby_step): x and r in
//      the registers, v between two planes;
//   6. u = x + v in place of v, x_proj = sqrt(Tau) (u + t1) into the other
//      direction plane;
//   7. the update of the owned pixels (update_val, t2 read again from the
//      state or the carry), a row of 32 threads to a row of the tile: the
//      state and z_proj (no iteration reads it) on the last iteration,
//      else the carry.
// Every stage tests a neighbour by the pixel's place in the plane, which is
// all the tests of the launch sequence decide by, except M's stencils (the
// steps and M(warm)) in a window that lies inside the plane, its rows
// within [1, nx - 2] and its columns within [1, ny - 2] (540 of 640 at
// 2048x2048, degree 10), which test nothing (strip_step<false>); a second
// copy of the whole window body for such windows held more registers than
// the tests cost (PERF.md).  The per-pixel expressions are
// the launch sequence's (t1_at, rhs_dx, ckt_at, m_at, cheby_step_val,
// update_at) in the same order, so the planes are its own bit for bit.
// After the last iteration and a grid barrier the warps reduce
// admm_norm_partial's 32x8 tiles of the written slot, a tile a warp
// (norm_terms_at, block_partial's tree as a column's sums and shuffles, no
// block barrier) for the finish: the norms are the launch sequence's bit
// for bit too.  A chunk is this launch, admm_finish's OP_NORMS and, after a
// count of 1, the copy back (admm_tiled_settle); a multichunk is k_chunks
// launches, each followed by admm_finish's OP_ADAPT_HOLD, the next chunk's
// loads applying the rescale the adaptation decided, and one settle that
// applies the last executed chunk's rescale (and copies slot B back where
// a count of 1 ended there).  A launch made after convergence returns at
// once.
// Measured on an H100 and not kept (PERF.md): PR 22's design (five shared
// planes walked by rows of 32 threads, every step testing four neighbours
// through the parameter structs, the state read and written every
// iteration); three planes with plain loads (their latency exposed,
// registers spilled); the next window's rows prefetched into L2 under the
// steps (slower: a round's windows exceed L2); two blocks of 384 threads
// on each SM (slower: smaller windows); 1024 threads of 12-row strips.
// ---------------------------------------------------------------------------

constexpr int AT_THREADS = 768;  // a block: 24 warps, one a map block
constexpr int AT_BLOCKS = 1;     // blocks on each SM
constexpr int AT_WARPS = AT_THREADS / BX;
constexpr int AT_K = 16;  // rows of a thread's strip
constexpr int AT_MAX_CB = 6;  // column blocks of a map: 2 (the least) to 6
constexpr int AT_PLANES = 4;

// The map of a launch's windows (mirrored by ops/fused_admm.py
// admm_tiled_map): cb blocks of 32 columns by rb blocks of AT_K rows, at
// least a tx x ty tile and degree + 1 pixels on every side.
struct AMap {
  int cb, rb;
};

inline __host__ __device__ AMap admm_tiled_map(int tx, int ty, int degree) {
  const int h2 = 2 * (degree + 1);
  return AMap{(ty + h2 + BX - 1) / BX, (tx + h2 + AT_K - 1) / AT_K};
}

// A slot's state planes.
struct Slot {
  float *xh, *xp, *xd, *zh, *zd, *warm;
};

__device__ __forceinline__ Slot slot_of(const State& a, const State& b,
                                        bool use_b) {
  return Slot{use_b ? b.xh : a.xh, use_b ? b.xp : a.xp,
              use_b ? b.xd : a.xd, use_b ? b.zh : a.zh,
              use_b ? b.zd : a.zd, use_b ? b.warm : a.warm};
}

// The planes a launch reads and writes and the window's owned tile, in
// shared memory after the window's planes (set once a launch and once a
// window), so that no register holds them across the Chebyshev steps: 17
// pointers and four ints, 152 bytes.  A carry is what one iteration hands
// the next in place of the state: t1, t2's two parts (zeroed on the dead
// row and column) and warm, the values the next iteration's head would
// form from the state, formed by the same expressions from the same
// values; four planes at c[t mod 2] + k n, k = 0-3, which iteration t
// writes.
struct Planes {
  Slot src, dst;  // the first iteration's state, the last one's
  float* c[2];    // the carries
  const float *f, *w;
  float* zp;   // the caller's z_proj (last iteration)
  int R0, C0;  // the owned tile's first row and column
  int ntc, nwin;  // the tiles of a row of tiles, and of the plane
};

// The dynamic shared memory of a block of the tiled launch (mirrored by
// ops/fused_admm.py admm_tiled_bytes): four planes of the map with a ring
// of one pixel, then the launch's Planes.
inline size_t admm_tiled_smem(int tx, int ty, int degree) {
  const AMap m = admm_tiled_map(tx, ty, degree);
  return (size_t)AT_PLANES * (m.rb * AT_K + 2) * (m.cb * BX + 2)
         * sizeof(float) + sizeof(Planes);
}

// What a window's stages share: the plane, the map's row blocks and the
// iteration's scalars.
struct AWin {
  int nx, ny, h, rb;
  float alpha, oma;
  int dataterm;
  bool scale;
  bool first, last;  // the state in (else a carry), the state out
};

// The thread's place in a map of CB column blocks: its warp's block of
// rows from wr and columns from wc, and its strip's first pixel at offset
// o of a shared plane (formed where it is used, from the thread's index).
template <int CB>
struct MapPos {
  int wp, wr, wc, o;
  __device__ __forceinline__ MapPos() {
    wp = threadIdx.x / BX;
    wc = wp % CB * BX;
    wr = wp / CB * AT_K;
    o = (wr + 1) * (CB * BX + 2) + wc + (int)(threadIdx.x % BX) + 1;
  }
};

// A thread's strip in the window of the owned tile at pl's corner: plane
// rows i0 .. i0 + AT_K - 1 of column j; the window's rows and columns end
// at ilim and jlim; `on` where the warp's block meets the window in the
// plane, `edge` where the window meets the plane's edges (M's neighbours
// tested).  Formed again at each stage from the corner in shared memory,
// so that no register holds it across the stages' barriers.
struct Strip {
  int i0, j, ilim, jlim;
  bool on, edge;
};

template <int CB>
__device__ __forceinline__ Strip strip_at(const Planes& pl, const AWin& a,
                                          int tx, int ty) {
  const MapPos<CB> m;
  const int R0 = pl.R0, C0 = pl.C0, nx = a.nx, ny = a.ny, h = a.h;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
  const int r0 = R0 - h, c0 = C0 - h;
  Strip s;
  s.i0 = r0 + m.wr;
  s.j = c0 + m.wc + (int)(threadIdx.x % BX);
  s.ilim = min(R1 + h, nx);
  s.jlim = min(C1 + h, ny);
  s.on = m.wp < CB * a.rb && s.i0 + AT_K > 0 && s.i0 < s.ilim
         && c0 + m.wc + BX > 0 && c0 + m.wc < s.jlim;
  s.edge = !(r0 >= 1 && c0 >= 1 && R1 + h <= nx - 1 && C1 + h <= ny - 1);
  return s;
}

// M(v) = v + c_K^2 grad^T grad v (m_at) at a strip's AT_K pixels from the
// plane at v (the strip's first pixel), into m; with EDGE, a neighbour
// beyond the plane's first (kt: the strip's row of plane row 0) or last
// (kb) row or its first (jl) or last (jr) column is taken as m_at takes it.
template <bool EDGE>
__device__ __forceinline__ void strip_m(const float* v, int S, int kt,
                                        int kb, bool jl, bool jr,
                                        float (&m)[AT_K]) {
  float up = v[-S], c = v[0];
#pragma unroll
  for (int k = 0; k < AT_K; ++k) {  // v walks the strip a row at a time
    const float* below = v + S;
    const float dn = *below;
    float gxm = c - up, gx = dn - c;
    float gym = c - v[-1], gy = v[1] - c;
    if (EDGE) {
      if (k <= kt) gxm = 0.f;
      if (k >= kb) gx = 0.f;
      if (jl) gym = 0.f;
      if (jr) gy = 0.f;
    }
    m[k] = c + C2 * ((gxm - gx) + (gym - gy));
    up = c;
    c = dn;
    v = below;
  }
}

// One Chebyshev step on a strip (cheby_step_val): x += v, r -= M(v), and
// v' = c_prev v + c_r r into nxt.
template <bool EDGE>
__device__ __forceinline__ void strip_step(const float* cur, float* nxt,
                                           int S, int kt, int kb, bool jl,
                                           bool jr, float cp, float cr,
                                           float (&x)[AT_K],
                                           float (&r)[AT_K]) {
  float up = cur[-S], c = cur[0];
#pragma unroll
  for (int k = 0; k < AT_K; ++k) {  // cur and nxt walk the strip
    const float* below = cur + S;
    const float dn = *below;
    float gxm = c - up, gx = dn - c;
    float gym = c - cur[-1], gy = cur[1] - c;
    if (EDGE) {
      if (k <= kt) gxm = 0.f;
      if (k >= kb) gx = 0.f;
      if (jl) gym = 0.f;
      if (jr) gy = 0.f;
    }
    const float m = c + C2 * ((gxm - gx) + (gym - gy));
    x[k] = x[k] + c;
    r[k] = r[k] - m;
    *nxt = cp * c + cr * r[k];
    up = c;
    c = dn;
    cur = below;
    nxt += S;
  }
}

// Stage 7 of tiled_window: the owned pixels' update (update_val) from
// x_proj (XP), t1 (T1) and u (U), planes of the map from its first pixel,
// a row of 32 threads to a row of the tile; with LAST the state and z_proj
// into slot `dst`, else the carry of iteration `it` (two forms, so that
// each holds only its own planes' pointers).
template <bool LAST, int CB>
__device__ __forceinline__ void tiled_update(const Planes& pl,
                                             const AWin& a, const float* U,
                                             const float* XP,
                                             const float* T1, const float* sc,
                                             int it, int degree, int tx,
                                             int ty) {
  constexpr int S = CB * BX + 2;
  const int nx = a.nx, ny = a.ny;
  const size_t n = (size_t)nx * ny;
  // the owned tile and the update's scalars, read again: no register held
  // them across the steps
  const UpdScal us = upd_scal(sc);
  const int R0 = pl.R0, C0 = pl.C0, h = degree + 1;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
#pragma unroll 1
  for (int i = R0 + (int)threadIdx.x / BX; i < R1; i += AT_WARPS)
#pragma unroll 1
    for (int jj = C0 + (int)threadIdx.x % BX; jj < C1; jj += BX) {
      const int q = (i - R0 + h + 1) * S + jj - C0 + h + 1;
      const size_t g = (size_t)i * ny + jj;
      const float xpn = XP[q];
      const float zpx = i < nx - 1 ? XP[q + S] - xpn : 0.f;
      const float zpy = jj < ny - 1 ? XP[q + 1] - xpn : 0.f;
      float t2x = 0.f, t2y = 0.f;
      if (!a.first) {
        const float* ci = pl.c[(it & 1) ^ 1] + g;
        t2x = ci[n];
        t2y = ci[2 * n];
      } else {
        if (i != nx - 1) {
          const float* zd_ = pl.src.zd;
          const float zd = a.scale ? zd_[g] * sc[S_FAC] : zd_[g];
          t2x = SQRT_S * (pl.src.zh[g] + zd);
        }
        if (jj < ny - 1) {
          const float* zd_ = pl.src.zd + n;
          const float zd = a.scale ? zd_[g] * sc[S_FAC] : zd_[g];
          t2y = SQRT_S * (pl.src.zh[n + g] + zd);
        }
      }
      const Upd o = update_val(
          xpn, T1[q], zpx, zpy, t2x, t2y, __ldg(pl.f + g),
          a.dataterm == DT_WSQUARE ? __ldg(pl.w + g) : 0.f, a.dataterm, us);
      if (LAST) {  // the pointers read a pixel at a time: none held
        const volatile Planes& v = pl;
        v.dst.xh[g] = o.xh;
        v.dst.xp[g] = xpn;
        v.dst.xd[g] = o.xd;
        v.dst.zh[g] = o.zhx;
        v.dst.zh[n + g] = o.zhy;
        v.dst.zd[g] = o.zdx;
        v.dst.zd[n + g] = o.zdy;
        v.dst.warm[g] = U[q];
        v.zp[g] = zpx;
        v.zp[n + g] = zpy;
      } else {  // what the next head forms from these values
        float* co = pl.c[it & 1] + g;
        co[0] = ((a.alpha * o.xh + a.oma * xpn) + o.xd) * INV_SQRT_T;
        co[n] = i == nx - 1 ? 0.f : SQRT_S * (o.zhx + o.zdx);
        co[2 * n] = jj == ny - 1 ? 0.f : SQRT_S * (o.zhy + o.zdy);
        co[3 * n] = U[q];
      }
    }
}

// One iteration on the window of the tile at pl's corner: from slot
// pl.src on the first iteration, else from the carry; the owned pixels
// into slot pl.dst on the last, else into the carry.  CB is the map's
// column blocks as a constant (a row stride that the offsets of the
// unrolled loops take as immediates: read at run time, it held registers
// of row offsets and spilled).  Only the loops over x and r, which live in
// registers, are unrolled; the others stay loops, so that the compiler
// holds no row's addresses or values beyond its own.
template <int CB>
__device__ __forceinline__ void tiled_window(
    const Planes& pl, const AWin& a, float* smem, int plane, int degree,
    const float* __restrict__ coeffs, const float* sc, int it, int tx,
    int ty) {
  constexpr int S = CB * BX + 2;
  const int nx = a.nx, ny = a.ny;
  const size_t n = (size_t)nx * ny;
  float* P0 = smem + MapPos<CB>().o;
  float* P1 = P0 + plane;
  float* P2 = P1 + plane;
  float* P3 = P2 + plane;
  float x[AT_K], r[AT_K];

  // Copies of planes p and q of the strip's rows in the window and the
  // plane into the shared planes sp and sq (zeros elsewhere: the map's
  // pixels beyond them), not waited for.
  auto load2 = [&](const Strip& s, const float* p, const float* q,
                   float* sp, float* sq) {
    const int k0 = max(-s.i0, 0);
    const int k1 = s.j >= 0 && s.j < s.jlim ? min(s.ilim - s.i0, AT_K) : 0;
    const size_t g0 = (size_t)((long long)s.i0 * ny + s.j);
#pragma unroll 1
    for (int k = 0; k < AT_K; ++k)
      if (k < k0 || k >= k1) sp[k * S] = sq[k * S] = 0.f;
#pragma unroll 1
    for (int k = k0; k < k1; ++k) {
      const size_t g = g0 + (size_t)k * ny;
      cp_async4(sp + k * S, p + g);
      cp_async4(sq + k * S, q + g);
    }
  };
  // M(warm) into r from P3, tested at the plane's edges in an edge window
  // (kt, kb: the strip's rows of plane rows 0 and nx - 1)
  auto m_warm = [&](const Strip& s) {
    const int kt = -s.i0, kb = nx - 1 - s.i0;
    if (s.edge)
      strip_m<true>(P3, S, kt, kb, s.j <= 0, s.j >= ny - 1, r);
    else
      strip_m<false>(P3, S, kt, kb, s.j <= 0, s.j >= ny - 1, r);
  };

  if (a.first) {
    // 1. xh, xp, xd and warm into P0-P3, then t1 in place of xd and x =
    // warm
    {
      const Strip s = strip_at<CB>(pl, a, tx, ty);
      if (s.on) {
        load2(s, pl.src.xh, pl.src.xp, P0, P1);
        load2(s, pl.src.xd, pl.src.warm, P2, P3);
        cp_async_wait();
#pragma unroll 1
        for (int k = 0; k < AT_K; ++k) {
          const float xd = a.scale ? P2[k * S] * sc[S_FAC] : P2[k * S];
          P2[k * S] = ((a.alpha * P0[k * S] + a.oma * P1[k * S]) + xd)
                      * INV_SQRT_T;
        }
#pragma unroll
        for (int k = 0; k < AT_K; ++k) x[k] = P3[k * S];
      }
    }
    __syncthreads();

    // 2. zh and zd's x parts into P0 and P1 while M(warm) goes into r,
    // then d's x part (t2 zeroed on the dead row) into P0
    {
      const Strip s = strip_at<CB>(pl, a, tx, ty);
      if (s.on) {
        load2(s, pl.src.zh, pl.src.zd, P0, P1);
        m_warm(s);
        cp_async_wait();
        const int kb = nx - 1 - s.i0;
#pragma unroll 1
        for (int k = 0; k < AT_K; ++k) {
          const float zd = a.scale ? P1[k * S] * sc[S_FAC] : P1[k * S];
          const float t2x = k == kb ? 0.f : SQRT_S * (P0[k * S] + zd);
          const float t1 = P2[k * S];
          const float gx = k < kb ? P2[(k + 1) * S] - t1 : 0.f;
          P0[k * S] = t2x - C_K * gx;
        }
      }
    }
    __syncthreads();

    // 3. zh and zd's y parts into P1 and P3, then d's y part (t2 zeroed
    // on the last column) into P1
    {
      const Strip s = strip_at<CB>(pl, a, tx, ty);
      if (s.on) {
        load2(s, pl.src.zh + n, pl.src.zd + n, P1, P3);
        cp_async_wait();
        const bool jr = s.j >= ny - 1;
#pragma unroll 1
        for (int k = 0; k < AT_K; ++k) {
          const float zd = a.scale ? P3[k * S] * sc[S_FAC] : P3[k * S];
          const float t2y = jr ? 0.f : SQRT_S * (P1[k * S] + zd);
          const float t1 = P2[k * S];
          const float gy = !jr ? P2[k * S + 1] - t1 : 0.f;
          P1[k * S] = t2y - C_K * gy;
        }
      }
    }
    __syncthreads();
  } else {
    // 1-3 from the carry: t2's parts, t1 and warm into P0-P3, x = warm;
    // then M(warm) into r and d in place of t2
    const float* ci = pl.c[(it & 1) ^ 1];
    {
      const Strip s = strip_at<CB>(pl, a, tx, ty);
      if (s.on) {
        load2(s, ci + n, ci + 2 * n, P0, P1);
        load2(s, ci, ci + 3 * n, P2, P3);
        cp_async_wait();
#pragma unroll
        for (int k = 0; k < AT_K; ++k) x[k] = P3[k * S];
      }
    }
    __syncthreads();
    {
      const Strip s = strip_at<CB>(pl, a, tx, ty);
      if (s.on) {
        m_warm(s);
        const int kb = nx - 1 - s.i0;
        const bool jr = s.j >= ny - 1;
#pragma unroll 1
        for (int k = 0; k < AT_K; ++k) {
          const float t1 = P2[k * S];
          const float gx = k < kb ? P2[(k + 1) * S] - t1 : 0.f;
          const float gy = !jr ? P2[k * S + 1] - t1 : 0.f;
          P0[k * S] = P0[k * S] - C_K * gx;
          P1[k * S] = P1[k * S] - C_K * gy;
        }
      }
    }
    __syncthreads();
  }

  // 4. r = c_K grad^T d - M(warm), and v = r / theta into P3
  {
    const Strip s = strip_at<CB>(pl, a, tx, ty);
    if (s.on) {
      const int kt = -s.i0;
      const bool jl = s.j <= 0;
#pragma unroll
      for (int k = 0; k < AT_K; ++k) {
        const float vxm = k > kt ? P0[(k - 1) * S] : 0.f;
        const float vym = !jl ? P1[k * S - 1] : 0.f;
        const float rhs = C_K * ((vxm - P0[k * S]) + (vym - P1[k * S]));
        r[k] = rhs - r[k];
        P3[k * S] = r[k] * INV_THETA;
      }
    }
  }
  __syncthreads();

  // 5. the degree - 1 Chebyshev steps, v between P3 and P0
  const Strip s = strip_at<CB>(pl, a, tx, ty);
  const int kt = -s.i0, kb = nx - 1 - s.i0;
  const bool jl = s.j <= 0, jr = s.j >= ny - 1;
  float* cur = P3;
  float* nxt = P0;
  for (int st = 0; st < degree - 1; ++st) {
    const float cp = coeffs[2 * st], cr = coeffs[2 * st + 1];
    if (s.on && s.edge)
      strip_step<true>(cur, nxt, S, kt, kb, jl, jr, cp, cr, x, r);
    else if (s.on)
      strip_step<false>(cur, nxt, S, kt, kb, jl, jr, cp, cr, x, r);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // 6. u = x + v in place of v, x_proj = sqrt(Tau) (u + t1) into nxt
  if (s.on) {
#pragma unroll
    for (int k = 0; k < AT_K; ++k) {
      const float u = x[k] + cur[k * S];
      cur[k * S] = u;
      nxt[k * S] = SQRT_T * (u + P2[k * S]);
    }
  }
  __syncthreads();

  // 7. the owned pixels' update into the other slot or the carry
  const int o = MapPos<CB>().o;  // the planes from the map's first pixel
  const float* U = cur - o;
  const float* XP = nxt - o;
  const float* T1 = P2 - o;
  if (a.last)
    tiled_update<true, CB>(pl, a, U, XP, T1, sc, it, degree, tx, ty);
  else
    tiled_update<false, CB>(pl, a, U, XP, T1, sc, it, degree, tx, ty);
}

// `count` iterations from slot `start` (0: A, the caller's planes; 1: B),
// on maps of CB column blocks (2 to AT_MAX_CB, each its own kernel),
// then admm_norm_partial's tiles of the slot written last: the other slot
// for a count of 1, else slot `start` (0 then: the iterations between hand
// on carries in slot B's planes).  `pending`: the planes owe sc[S_FAC] on
// x_dual and z_dual (a multichunk's later chunk).  sb.zp is sa.zp.
template <int CB>
__global__ void __launch_bounds__(AT_THREADS, AT_BLOCKS)
    admm_tiled(State sa, State sb, float alpha, float oma, int dataterm,
               int degree, const float* __restrict__ coeffs, int count,
               int start, int pending, int tx, int ty) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (conv_set(sa.sc)) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const int nx = sa.nx, ny = sa.ny;
  const AMap mp = admm_tiled_map(tx, ty, degree);
  const int S = mp.cb * BX + 2, plane = (mp.rb * AT_K + 2) * S;
  for (int k = threadIdx.x; k < AT_PLANES * plane; k += AT_THREADS)
    smem[k] = 0.f;  // the rings stay zero: no stage writes them
  __syncthreads();

  AWin a;
  a.nx = nx;
  a.ny = ny;
  a.h = degree + 1;
  a.alpha = alpha;
  a.oma = oma;
  a.dataterm = dataterm;
  a.rb = mp.rb;
  const int wp = threadIdx.x / BX;
  // the carries: slot B's 8 planes, consecutive from sb.xh (slot_b)
  const size_t n = (size_t)nx * ny;
  const bool fin_b = (count == 1) == (start == 0);
  Planes& pl = *reinterpret_cast<Planes*>(smem + AT_PLANES * plane);
  if (threadIdx.x == 0)
    pl = Planes{slot_of(sa, sb, start != 0), slot_of(sa, sb, fin_b),
                {sb.xh, sb.xh + 4 * n}, sa.f, sa.w, sa.zp, 0, 0,
                (ny + ty - 1) / ty, (nx + tx - 1) / tx * ((ny + ty - 1) / ty)};
  for (int it = 0; it < count; ++it) {
    a.scale = pending && it == 0;
    a.first = it == 0;
    a.last = it == count - 1;
    __syncthreads();  // pl, the first time
    for (int tile = blockIdx.x; tile < pl.nwin; tile += gridDim.x) {
      if (threadIdx.x == 0) {
        pl.R0 = tile / pl.ntc * tx;
        pl.C0 = tile % pl.ntc * ty;
      }
      __syncthreads();  // the corner before any stage reads it
      tiled_window<CB>(pl, a, smem, plane, degree, coeffs, sa.sc, it, tx,
                       ty);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }  // admm_norm_partial's 32x8 tiles of the slot written last, a warp to a
  // tile: lane l sums its column's eight rows as block_partial's tree pairs
  // them (rows r and r + 4, then r and r + 2, then 0 and 1; two rows at a
  // time, so that few values are live), then the lanes by shuffles (16, 8,
  // 4, 2, 1), the same additions in the same order as the tree's
  const State& fin = fin_b ? sb : sa;
  const int ntx = (ny + BX - 1) / BX;
  const int ntiles = (nx + BY - 1) / BY * ntx;
  const int lane = threadIdx.x % BX;
  for (int tile = blockIdx.x * AT_WARPS + wp; tile < ntiles;
       tile += gridDim.x * AT_WARPS) {
    const int i0 = tile / ntx * BY, j = tile % ntx * BX + lane;
    float b0[4], s[4];
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float b[4];
#pragma unroll 1
      for (int q = 0; q < 2; ++q) {  // rows r and r + 4, r = half + 2 q
        const int r = i0 + half + 2 * q;
        float v[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
        if (j < ny && r < nx && r >= fin.rows.own_lo && r < fin.rows.own_hi)
          norm_terms_at(fin, r, j, v);
        if (j < ny && r + 4 < nx && r + 4 >= fin.rows.own_lo
            && r + 4 < fin.rows.own_hi)
          norm_terms_at(fin, r + 4, j, w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float a = v[k] + w[k];
          b[k] = q == 0 ? a : b[k] + a;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (half == 0)
          b0[k] = b[k];
        else
          s[k] = b0[k] + b[k];
      }
    }
#pragma unroll
    for (int o = BX / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k) fin.partial[PS * tile + k] = s[k];
  }
}

// After a tiled chunk (multi 0) whose flag was not set at entry and whose
// count was 1: slot B's state into the caller's planes.  After a tiled
// multichunk (multi 1) that ran a chunk: the last executed chunk's dual
// rescale, x_dual and z_dual times sc[S_FAC] (admm_rescale's product),
// from slot B where its last iteration wrote there (a count of 1 and an
// odd number of chunks run).
__global__ void admm_tiled_settle(State sa, State sb, int count, int multi) {
  const float* sc = sa.sc;
  const int done = multi ? (int)sc[S_DONE] : (sc[S_CONV] != 0.f ? 0 : 1);
  if (done == 0) return;
  const bool from_b = count == 1 && (done & 1) != 0;
  if (!from_b && !multi) return;
  const float fac = sc[S_FAC];
  const State& s = from_b ? sb : sa;
  const size_t n = (size_t)sa.nx * sa.ny;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (size_t)gridDim.x * blockDim.x) {
    if (from_b) {
      sa.xh[k] = s.xh[k];
      sa.xp[k] = s.xp[k];
      sa.zh[k] = s.zh[k];
      sa.zh[n + k] = s.zh[n + k];
      sa.warm[k] = s.warm[k];
    }
    float xd = s.xd[k], zdx = s.zd[k], zdy = s.zd[n + k];
    if (multi) {
      xd = xd * fac;
      zdx = zdx * fac;
      zdy = zdy * fac;
    }
    sa.xd[k] = xd;
    sa.zd[k] = zdx;
    sa.zd[n + k] = zdy;
  }
}

#define LAUNCH_CHECK()                                  \
  do {                                                  \
    cudaError_t e_ = cudaGetLastError();                \
    if (e_ != cudaSuccess) return (int)e_;              \
  } while (0)

dim3 grid_of(int nx, int ny) {
  return dim3((ny + BX - 1) / BX, (nx + BY - 1) / BY);
}

int num_blocks(int nx, int ny) {
  dim3 g = grid_of(nx, ny);
  return (int)(g.x * g.y);
}

State state_of(void* xh, void* xp, void* xd, void* zh, void* zp, void* zd,
               void* warm, const void* f, const void* w, void* scratch,
               void* sc, void* partial, int nx, int ny) {
  State b;
  size_t n = (size_t)nx * ny;
  float* s = (float*)scratch;  // 8 planes
  b.xh = (float*)xh;
  b.xp = (float*)xp;
  b.xd = (float*)xd;
  b.zh = (float*)zh;
  b.zp = (float*)zp;
  b.zd = (float*)zd;
  b.warm = (float*)warm;
  b.f = (const float*)f;
  b.w = (const float*)w;
  b.t1 = s;
  b.dd = s + n;        // planes 1-2
  b.x = s + 3 * n;
  b.r = s + 4 * n;     // Chebyshev
  b.v0 = s + 5 * n;
  b.v1 = s + 6 * n;
  b.p = s + 4 * n;     // CGLS
  b.q = s + 5 * n;     // planes 5-6
  b.s = s + 7 * n;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.nx = nx;
  b.ny = ny;
  b.rows = Rows{0, nx, 0, nx};
  b.zn = n;
  return b;
}

// One outer iteration: degree > 0 selects the Chebyshev projection with
// the (c_prev, c_r) host coefficients of its degree - 1 steps, degree == 0
// the masked CGLS of maxit steps at tolerance tols[tix].
int iteration(const State& b, int dataterm, int degree, const float* coeffs,
              int maxit, const float* tols, int tix, float alpha, float oma,
              cudaStream_t st) {
  dim3 grid = grid_of(b.nx, b.ny), block(BX, BY);
  int nblocks = num_blocks(b.nx, b.ny);
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f};
  int cgls = degree == 0;
  admm_rhs<<<grid, block, 0, st>>>(b, alpha, oma, cgls);
  LAUNCH_CHECK();
  const float* v = nullptr;
  if (!cgls) {
    cheby_init<<<grid, block, 0, st>>>(b);
    LAUNCH_CHECK();
    float* cur = b.v0;
    float* nxt = b.v1;
    for (int k = 0; k < degree - 1; ++k) {
      cheby_step<<<grid, block, 0, st>>>(b, cur, nxt, coeffs[2 * k],
                                         coeffs[2 * k + 1]);
      LAUNCH_CHECK();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    v = cur;
  } else {
    cg_init<<<grid, block, 0, st>>>(b);
    LAUNCH_CHECK();
    admm_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, nblocks, OP_CG_INIT, 0,
                                   0.f, tols, tix, none);
    LAUNCH_CHECK();
    for (int k = 0; k < maxit; ++k) {
      int par = k & 1;
      cg_q<<<grid, block, 0, st>>>(b, par);
      LAUNCH_CHECK();
      admm_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, nblocks, OP_CG_ALPHA,
                                     par, 0.f, tols, tix, none);
      LAUNCH_CHECK();
      cg_xr<<<grid, block, 0, st>>>(b, par);
      LAUNCH_CHECK();
      cg_s<<<grid, block, 0, st>>>(b, par);
      LAUNCH_CHECK();
      admm_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, nblocks, OP_CG_BETA,
                                     par, 0.f, tols, tix, none);
      LAUNCH_CHECK();
      cg_p<<<grid, block, 0, st>>>(b, par);
      LAUNCH_CHECK();
    }
  }
  admm_update<<<grid, block, 0, st>>>(b, v, dataterm);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// Number of per-block partials (PS floats each) for an (nx, ny) plane.
int prost_admm_num_blocks(int nx, int ny) { return num_blocks(nx, ny); }

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// admm_fused_chunk: `count` outer iterations on the 7 state arrays in
// place, the 4 SQUARED residual norms of the last one into sc[S_NORM..].
// `cg_tols` (device, count floats) is read by the CGLS projection only.
// No-op when sc[S_CONV] is set.
int prost_admm_chunk(void* xh, void* xp, void* xd, void* zh, void* zp,
                     void* zd, void* warm, const void* f, const void* w,
                     void* scratch, void* sc, void* partial, int nx, int ny,
                     const void* cg_tols, int count, int dataterm,
                     int degree, const float* coeffs, int maxit, float alpha,
                     float oma, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  State b = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  dim3 grid = grid_of(nx, ny), block(BX, BY);
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f};
  admm_seed<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  for (int k = 0; k < count; ++k) {
    int rc = iteration(b, dataterm, degree, coeffs, maxit,
                       (const float*)cg_tols, k, alpha, oma, st);
    if (rc) return rc;
  }
  admm_norm_partial<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  admm_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, num_blocks(nx, ny),
                                 OP_NORMS, 0, 0.f, nullptr, 0, none);
  LAUNCH_CHECK();
  return 0;
}

// admm_fused_multichunk: up to k_chunks Chebyshev chunks, each followed by
// the Boyd adaptation and stopping test on the device and the dual
// rescale; every kernel after convergence returns at once (the lax.cond
// skip).  sc[S_NORM..] ends with the last executed chunk's sqrt'd norms.
int prost_admm_multichunk(void* xh, void* xp, void* xd, void* zh, void* zp,
                          void* zd, void* warm, const void* f, const void* w,
                          void* scratch, void* sc, void* partial, int nx,
                          int ny, int count, int k_chunks, int dataterm,
                          int degree, const float* coeffs, float alpha,
                          float oma, float sqrt_nrows, float sqrt_ncols,
                          float arb_tau, float arb_gamma, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  State b = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  dim3 grid = grid_of(nx, ny), block(BX, BY);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arb_tau, arb_gamma};
  admm_seed<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  for (int ch = 0; ch < k_chunks; ++ch) {
    for (int k = 0; k < count; ++k) {
      int rc = iteration(b, dataterm, degree, coeffs, 0, nullptr, 0, alpha,
                         oma, st);
      if (rc) return rc;
    }
    admm_norm_partial<<<grid, block, 0, st>>>(b);
    LAUNCH_CHECK();
    admm_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, num_blocks(nx, ny),
                                   OP_ADAPT, 0, (float)((ch + 1) * count),
                                   nullptr, 0, c);
    LAUNCH_CHECK();
    admm_rescale<<<grid, block, 0, st>>>(b);
    LAUNCH_CHECK();
  }
  return 0;
}

// admm_banded_iter on one halo-extended shard of a plane of nx_global rows
// (local row 0 is global row row_offset, [own_lo, own_hi) the owned rows):
// one Chebyshev outer iteration on the 7 state arrays in place and, with
// `with_norms`, the 4 SQUARED residual norms of the owned rows into
// sc[S_NORM..] (zeros otherwise), as one cooperative launch
// (admm_iter_coop).  `coeffs` is a device array of the (c_prev, c_r) of
// each of the degree - 1 Chebyshev steps, so any degree >= 1 runs.  No-op
// when sc[S_CONV] is set.  A launch the card cannot hold at once returns
// cudaErrorCooperativeLaunchTooLarge.
int prost_admm_iter_halo(void* xh, void* xp, void* xd, void* zh, void* zp,
                         void* zd, void* warm, const void* f, const void* w,
                         void* scratch, void* sc, void* partial, int nx,
                         int ny, int dataterm, int degree,
                         const void* coeffs, float alpha, float oma,
                         int nx_global, int row_offset, int own_lo,
                         int own_hi, int with_norms, void* stream) {
  if (degree < 1) return (int)cudaErrorInvalidValue;
  State b = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  b.rows = Rows{row_offset, nx_global, own_lo, own_hi};
  const float* cf = (const float*)coeffs;
  int blocks = 0;
  if (int rc = coop_blocks(&blocks)) return rc;
  void* args[] = {&b, &alpha, &oma, &dataterm, &degree, &cf, &with_norms};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)admm_iter_coop, dim3(blocks), dim3(CO_THREADS), args,
      CO_SMEM, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  return 0;
}

// The dynamic shared memory a block of admm_multichunk_resident and
// admm_chunk_resident may opt into on the current device (the opt-in limit
// less the kernels' static shared memory, the smaller of the two), or minus
// the error.
int prost_admm_resident_smem() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes multi, one;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&multi, (const void*)admm_multichunk_resident);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&one, (const void*)admm_chunk_resident);
  if (e != cudaSuccess) return -(int)e;
  size_t fixed = multi.sharedSizeBytes > one.sharedSizeBytes
                     ? multi.sharedSizeBytes
                     : one.sharedSizeBytes;
  return optin - (int)fixed;
}

}  // extern "C"

namespace {

// One grid-resident launch of `kernel` with `args` (whose rmax entry points
// at `rmax`): one block of RES_THREADS on each SM, the largest band's
// windows in dynamic shared memory; a band that does not fit is refused
// with cudaErrorInvalidValue, a grid the card cannot hold at once by the
// card (cudaErrorCooperativeLaunchTooLarge).
template <typename K>
int resident_launch(K kernel, void** args, int& rmax, int nx, int ny,
                    int dataterm, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  rmax = (nx + sms - 1) / sms;
  size_t smem = admm_resident_floats(rmax, ny, dataterm == DT_WSQUARE)
                * sizeof(float);
  int limit = prost_admm_resident_smem();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute((const void*)kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(RES_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  return 0;
}

// The dynamic shared memory a block of the tiled launch may opt into on
// the current device (the opt-in limit less its static shared memory), or
// minus the error.
int admm_tiled_limit() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes a;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, (const void*)admm_tiled<2>);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)a.sharedSizeBytes;
}

// Slot B of the tiled launch: xh, xp, xd, zh (2), zd (2) and warm in the 8
// scratch planes (which also hold the two carries); z_proj, which only the
// last iteration writes, is the caller's.
State slot_b(const State& a, void* scratch) {
  const size_t n = (size_t)a.nx * a.ny;
  float* s = (float*)scratch;
  State b = a;
  b.xh = s;
  b.xp = s + n;
  b.xd = s + 2 * n;
  b.zh = s + 3 * n;
  b.zd = s + 5 * n;
  b.warm = s + 7 * n;
  return b;
}

// One tiled launch of `count` iterations from slot `start`: AT_BLOCKS
// blocks of AT_THREADS on each SM; a tile that is not a multiple of the
// 32x8 norm tiles, whose map needs more than a block's warps or AT_MAX_CB
// column blocks, or whose planes do not fit in a block's shared memory is
// refused with cudaErrorInvalidValue, a grid the card cannot hold at once
// by the card (cudaErrorCooperativeLaunchTooLarge).
int tiled_launch(State& a, State& b, float alpha, float oma, int dataterm,
                 int degree, const float* cf, int count, int start,
                 int pending, int tx, int ty, cudaStream_t st) {
  if (tx < BY || tx % BY || ty < BX || ty % BX || degree < 1 || count < 1)
    return (int)cudaErrorInvalidValue;
  const AMap m = admm_tiled_map(tx, ty, degree);
  if (m.cb * m.rb > AT_WARPS || m.cb > AT_MAX_CB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = admm_tiled_smem(tx, ty, degree);
  const int limit = admm_tiled_limit();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  void (*kernel)(State, State, float, float, int, int, const float*, int,
                 int, int, int, int) =
      m.cb == 2   ? admm_tiled<2>
      : m.cb == 3 ? admm_tiled<3>
      : m.cb == 4 ? admm_tiled<4>
      : m.cb == 5 ? admm_tiled<5>
                  : admm_tiled<6>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      AT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < AT_BLOCKS) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &alpha, &oma, &dataterm, &degree, &cf,
                  &count, &start, &pending, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3(sms * AT_BLOCKS),
                                  dim3(AT_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  return 0;
}

int tiled_settle(const State& a, const State& b, int count, int multi,
                 cudaStream_t st) {
  admm_tiled_settle<<<264, 512, 0, st>>>(a, b, count, multi);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// admm_fused_multichunk as one grid-resident cooperative launch
// (admm_multichunk_resident): the arguments of prost_admm_multichunk, with
// the Chebyshev coefficients as a device array (any degree >= 1) and
// `scratch` of 12 planes (the 8 of the launch sequence, whose first rows
// the blocks exchange, and the norms' 4 term planes).  Bit-equal to
// prost_admm_multichunk in the 7 state arrays and in sc.  A launch whose
// bands do not fit in one block's shared memory on each SM is refused
// (cudaErrorInvalidValue, or the card's refusal of the cooperative
// launch).
int prost_admm_multichunk_resident(void* xh, void* xp, void* xd, void* zh,
                                   void* zp, void* zd, void* warm,
                                   const void* f, const void* w,
                                   void* scratch, void* sc, void* partial,
                                   int nx, int ny, int count, int k_chunks,
                                   int dataterm, int degree,
                                   const void* coeffs, float alpha,
                                   float oma, float sqrt_nrows,
                                   float sqrt_ncols, float arb_tau,
                                   float arb_gamma, void* stream) {
  if (degree < 1) return (int)cudaErrorInvalidValue;
  State b = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  float* terms = (float*)scratch + (size_t)8 * nx * ny;
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arb_tau, arb_gamma};
  const float* cf = (const float*)coeffs;
  int rmax = 0;
  void* args[] = {&b, &alpha, &oma, &dataterm, &degree, &cf, &count,
                  &k_chunks, &c, &terms, &rmax};
  return resident_launch(admm_multichunk_resident, args, rmax, nx, ny,
                         dataterm, (cudaStream_t)stream);
}

// admm_fused_chunk with the Chebyshev projection as one grid-resident
// cooperative launch (admm_chunk_resident): the arguments of
// prost_admm_chunk without the CGLS ones, the coefficients as a device
// array (any degree >= 1), `scratch` of 12 planes as for
// prost_admm_multichunk_resident.  Bit-equal to prost_admm_chunk in the 7
// state arrays and the 4 squared norms.  No-op when sc[S_CONV] is set.  A
// launch that does not fit is refused as the multichunk's is.
int prost_admm_chunk_resident(void* xh, void* xp, void* xd, void* zh,
                              void* zp, void* zd, void* warm, const void* f,
                              const void* w, void* scratch, void* sc,
                              void* partial, int nx, int ny, int count,
                              int dataterm, int degree, const void* coeffs,
                              float alpha, float oma, void* stream) {
  if (degree < 1) return (int)cudaErrorInvalidValue;
  State b = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  float* terms = (float*)scratch + (size_t)8 * nx * ny;
  const float* cf = (const float*)coeffs;
  int rmax = 0;
  void* args[] = {&b, &alpha, &oma, &dataterm, &degree, &cf, &count, &terms,
                  &rmax};
  return resident_launch(admm_chunk_resident, args, rmax, nx, ny, dataterm,
                         (cudaStream_t)stream);
}

// admm_banded_chunk's counterpart for planes no grid-resident band holds:
// the arguments of prost_admm_chunk_resident and the owned tile (tx rows,
// a multiple of 8; ty columns, of 32), `scratch` of 8 planes (slot B).  One
// tiled cooperative launch (admm_tiled), admm_finish's OP_NORMS and, after
// a count of 1, the copy back (admm_tiled_settle).  Bit-equal to
// prost_admm_chunk in the 7 state arrays and the 4 squared norms.  No-op
// when sc[S_CONV] is set.  A tile the launch cannot take is refused
// (cudaErrorInvalidValue, or the card's refusal of the cooperative
// launch).
int prost_admm_chunk_tiled(void* xh, void* xp, void* xd, void* zh, void* zp,
                           void* zd, void* warm, const void* f,
                           const void* w, void* scratch, void* sc,
                           void* partial, int nx, int ny, int count,
                           int dataterm, int degree, const void* coeffs,
                           float alpha, float oma, int tx, int ty,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  State a = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  State b = slot_b(a, scratch);
  if (int rc = tiled_launch(a, b, alpha, oma, dataterm, degree,
                            (const float*)coeffs, count, 0, 0, tx, ty, st))
    return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f};
  admm_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, num_blocks(nx, ny),
                                 OP_NORMS, 0, 0.f, nullptr, 0, none);
  LAUNCH_CHECK();
  return count == 1 ? tiled_settle(a, b, count, 0, st) : 0;
}

// admm_fused_multichunk by tiled launches: the arguments of
// prost_admm_multichunk_resident and the owned tile, `scratch` of 8 planes
// (slot B).  Chunk c is a tiled launch from slot A (slot c mod 2 for a
// count of 1), its loads applying the rescale chunk c - 1 decided, and
// admm_finish's OP_ADAPT_HOLD; then admm_tiled_settle.  Bit-equal to
// prost_admm_multichunk in the 7 state arrays, the norms and sout (S_FAC
// ends as the last executed chunk's factor, not -1).  Refuses a tile as
// prost_admm_chunk_tiled does.
int prost_admm_multichunk_tiled(void* xh, void* xp, void* xd, void* zh,
                                void* zp, void* zd, void* warm,
                                const void* f, const void* w, void* scratch,
                                void* sc, void* partial, int nx, int ny,
                                int count, int k_chunks, int dataterm,
                                int degree, const void* coeffs, float alpha,
                                float oma, float sqrt_nrows,
                                float sqrt_ncols, float arb_tau,
                                float arb_gamma, int tx, int ty,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  State a = state_of(xh, xp, xd, zh, zp, zd, warm, f, w, scratch, sc,
                     partial, nx, ny);
  State b = slot_b(a, scratch);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arb_tau, arb_gamma};
  for (int ch = 0; ch < k_chunks; ++ch) {
    if (int rc = tiled_launch(a, b, alpha, oma, dataterm, degree,
                              (const float*)coeffs, count,
                              count == 1 ? ch & 1 : 0, ch > 0, tx, ty, st))
      return rc;
    admm_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, num_blocks(nx, ny),
                                   OP_ADAPT_HOLD, 0,
                                   (float)((ch + 1) * count), nullptr, 0, c);
    LAUNCH_CHECK();
  }
  return tiled_settle(a, b, count, 1, st);
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device, or minus the error.
int prost_admm_tiled_smem() { return admm_tiled_limit(); }

// The dynamic shared memory the tiled launch asks for with tx x ty tiles
// at Chebyshev degree `degree`, or -1 where it refuses the tile whatever
// the card (not a multiple of the 32x8 norm tiles, or a map beyond a
// block's warps or AT_MAX_CB column blocks).
int prost_admm_tiled_bytes(int tx, int ty, int degree) {
  if (tx < BY || tx % BY || ty < BX || ty % BX || degree < 1) return -1;
  const AMap m = admm_tiled_map(tx, ty, degree);
  if (m.cb * m.rb > AT_WARPS || m.cb > AT_MAX_CB) return -1;
  return (int)admm_tiled_smem(tx, ty, degree);
}

// The blocks of admm_iter_halo's cooperative launch on the current device,
// or minus the error that refuses it.
int prost_admm_coop_blocks() {
  int blocks = 0;
  int rc = coop_blocks(&blocks);
  return rc ? -rc : blocks;
}

}  // extern "C"
