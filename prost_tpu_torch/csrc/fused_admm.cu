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
// window the Chebyshev steps are stencils over shared memory.
//
// Design.  One cooperative launch a chunk, one block of AT_THREADS on each
// SM (32 rows of 32 threads), a grid barrier between iterations: iteration
// t reads slot t mod 2 (slot A the caller's planes, slot B the launch
// sequence's 8 scratch planes) and writes the other.  The blocks walk the
// plane's tiles (tx rows, a multiple of 8, by ty columns, of 32); a tile's
// window is the tile and h = degree + 1 pixels on every side, clamped at
// the plane's edges (ops/fused_admm.py admm_tiled_halo: u = x + v is exact
// degree pixels inside a window side that lies in the plane, z_proj one
// pixel less below and right; tests/test_torch_tiled_admm.py holds the
// plain twin exact with h and not with h - 1).  In shared memory five
// planes of the window, no more, which take these values in turn:
//   1. cp.async loads of xh, xp, xd, zh, zd (x parts), then of the y parts
//      and warm, combined pixel by pixel into t1 (T), t2 (R, V0) and warm
//      (X); the dead duals zeroed (admm_seed) and, in a multichunk's later
//      chunk, x_dual and z_dual times the rescale they still owe (S_FAC,
//      admm_rescale's product);
//   2. d = t2 - c_K grad t1 in place (admm_rhs);
//   3. r = c_K grad^T d - M(warm) into V1, x = warm, then v = r / theta into
//      V0 (cheby_init);
//   4. the degree - 1 steps, v between V0 and R (cheby_step);
//   5. u = x + v into X, x_proj = sqrt(Tau) (u + t1) into the free
//      direction plane;
//   6. the update of the owned pixels (update_val, t2 read again from the
//      slot) into the other slot, z_proj into the caller's planes on the
//      chunk's last iteration only (no iteration reads it).
// Every mask is decided by the pixel's place in the plane (the State's
// Rows), never by its place in the window; a neighbour outside the window
// inside the plane is taken as 0, which only pixels outside the exact
// region read.  The per-pixel expressions are the launch sequence's (t1_at,
// rhs_dx, ckt_at, m_at, cheby_step_val, update_at), so the planes are its
// own bit for bit.  After the last iteration and a grid barrier the
// blocks reduce admm_norm_partial's 32x8 tiles of the written slot
// (norm_terms_at, block_partial's tree, four tiles at a time) for the
// finish: the norms are the launch sequence's bit for bit too.  A chunk is
// this launch, admm_finish's OP_NORMS and, after an odd count, the copy
// back (admm_tiled_settle); a multichunk is k_chunks launches, each
// followed by admm_finish's OP_ADAPT_HOLD, the next chunk's loads applying
// the rescale the adaptation decided, and one settle that applies the last
// executed chunk's rescale (and copies slot B back where it ended there).
// A launch made after convergence returns at once.
// ---------------------------------------------------------------------------

constexpr int AT_THREADS = 1024;  // a block: 32 rows of 32 threads
constexpr int AT_ROWS = AT_THREADS / BX;
constexpr int AT_PLANES = 5;
constexpr int AT_RED = (AT_THREADS / NT) * 4 * NT;  // the norm pass's trees

// The dynamic shared memory of a block of the tiled launch (mirrored by
// ops/fused_admm.py admm_tiled_bytes).
inline size_t admm_tiled_smem(int tx, int ty, int degree) {
  const size_t h = 2 * ((size_t)degree + 1);
  const size_t planes = (size_t)AT_PLANES * (tx + h) * (ty + h);
  return (planes > (size_t)AT_RED ? planes : (size_t)AT_RED) * sizeof(float);
}

// A window: rows [r0, r0 + wh) and columns [c0, c0 + ww) of the plane, the
// owned tile its rows [oi0, oi1) and columns [oj0, oj1).
struct AWin {
  int r0, c0, wh, ww;
  int oi0, oi1, oj0, oj1;
};

// m_at on a window plane of row stride ww at window pixel (wi, wj), plane
// pixel (i, j).
__device__ __forceinline__ float m_win(const float* v, const State& b,
                                       const AWin& a, int wi, int wj, int i,
                                       int j, int p) {
  const int ww = a.ww;
  float c = v[p];
  float gxm =
      wi > 0 && above(b, i) && below(b, i - 1) ? c - v[p - ww] : 0.f;
  float gx = wi < a.wh - 1 && below(b, i) ? v[p + ww] - c : 0.f;
  float gym = wj > 0 && j > 0 ? c - v[p - 1] : 0.f;
  float gy = wj < ww - 1 && j < b.ny - 1 ? v[p + 1] - c : 0.f;
  return c + C2 * ((gxm - gx) + (gym - gy));
}

// The window's pixels, a row of 32 threads to a window row.
#define FOR_WINDOW(a, wi, wj)                                            \
  for (int wi = threadIdx.x / BX; wi < (a).wh; wi += AT_ROWS)            \
    for (int wj = threadIdx.x % BX; wj < (a).ww; wj += BX)

// One iteration on tile `tile` of the tiles of tx x ty: the window from
// slot `src`, the owned pixels into slot `dst` (z_proj into dst.zp with
// `last`); `scale` applies `fac` to x_dual and z_dual as they are loaded.
__device__ __forceinline__ void tiled_iteration(
    const State& src, const State& dst, float* smem, float alpha, float oma,
    int dataterm, int degree, const float* __restrict__ coeffs, int tile,
    int tx, int ty, bool scale, float fac, bool last, const UpdScal& us) {
  const int nx = src.nx, ny = src.ny;
  const size_t n = (size_t)nx * ny;
  const int h = degree + 1;
  const int ntc = (ny + ty - 1) / ty;
  const int R0 = tile / ntc * tx, C0 = tile % ntc * ty;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
  AWin a;
  a.r0 = max(R0 - h, 0);
  a.c0 = max(C0 - h, 0);
  a.wh = min(R1 + h, nx) - a.r0;
  a.ww = min(C1 + h, ny) - a.c0;
  a.oi0 = R0 - a.r0;
  a.oi1 = R1 - a.r0;
  a.oj0 = C0 - a.c0;
  a.oj1 = C1 - a.c0;
  const int m = a.wh * a.ww, ww = a.ww;
  float* T = smem;
  float* X = smem + m;
  float* R = smem + 2 * m;
  float* V0 = smem + 3 * m;
  float* V1 = smem + 4 * m;

  // 1. t1, t2 and warm
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    const size_t g = (size_t)(a.r0 + wi) * ny + a.c0 + wj;
    cp_async4(T + p, src.xh + g);
    cp_async4(X + p, src.xp + g);
    cp_async4(R + p, src.xd + g);
    cp_async4(V0 + p, src.zh + g);
    cp_async4(V1 + p, src.zd + g);
  }
  cp_async_wait();
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    const float xd = scale ? R[p] * fac : R[p];
    T[p] = ((alpha * T[p] + oma * X[p]) + xd) * INV_SQRT_T;
    const float zd = scale ? V1[p] * fac : V1[p];
    R[p] = dead_row(src, a.r0 + wi) ? 0.f : SQRT_S * (V0[p] + zd);
  }
  __syncthreads();  // X, V0 and V1 read before the next copies land
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    const size_t g = (size_t)(a.r0 + wi) * ny + a.c0 + wj;
    cp_async4(V0 + p, src.zh + n + g);
    cp_async4(V1 + p, src.zd + n + g);
    cp_async4(X + p, src.warm + g);
  }
  cp_async_wait();
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    const float zd = scale ? V1[p] * fac : V1[p];
    V0[p] = a.c0 + wj == ny - 1 ? 0.f : SQRT_S * (V0[p] + zd);
  }
  __syncthreads();

  // 2. d = t2 - c_K grad t1 in place of t2
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj, i = a.r0 + wi, j = a.c0 + wj;
    const float t1 = T[p];
    const float gx = wi < a.wh - 1 && below(src, i) ? T[p + ww] - t1 : 0.f;
    const float gy = wj < ww - 1 && j < ny - 1 ? T[p + 1] - t1 : 0.f;
    R[p] = R[p] - C_K * gx;
    V0[p] = V0[p] - C_K * gy;
  }
  __syncthreads();

  // 3. r = c_K grad^T d - M(warm); x = warm stays in X
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj, i = a.r0 + wi, j = a.c0 + wj;
    const float vxm = wi > 0 && above(src, i) ? R[p - ww] : 0.f;
    const float vym = wj > 0 && j > 0 ? V0[p - 1] : 0.f;
    const float rhs = C_K * ((vxm - R[p]) + (vym - V0[p]));
    V1[p] = rhs - m_win(X, src, a, wi, wj, i, j, p);
  }
  __syncthreads();
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    V0[p] = V1[p] * INV_THETA;
  }
  __syncthreads();

  // 4. the degree - 1 Chebyshev steps
  float* cur = V0;
  float* nxt = R;
  for (int s = 0; s < degree - 1; ++s) {
    const float cp = coeffs[2 * s], cr = coeffs[2 * s + 1];
    FOR_WINDOW(a, wi, wj) {
      const int p = wi * ww + wj, i = a.r0 + wi, j = a.c0 + wj;
      const float vv = cur[p];
      const float x = X[p] + vv;
      const float r = V1[p] - m_win(cur, src, a, wi, wj, i, j, p);
      X[p] = x;
      V1[p] = r;
      nxt[p] = cp * vv + cr * r;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // 5. u = x + v, x_proj = sqrt(Tau) (u + t1)
  FOR_WINDOW(a, wi, wj) {
    const int p = wi * ww + wj;
    const float u = X[p] + cur[p];
    X[p] = u;
    nxt[p] = SQRT_T * (u + T[p]);
  }
  __syncthreads();

  // 6. the owned pixels' update into the other slot
  const float* xp = nxt;
  for (int wi = a.oi0 + (int)threadIdx.x / BX; wi < a.oi1; wi += AT_ROWS)
    for (int wj = a.oj0 + (int)threadIdx.x % BX; wj < a.oj1; wj += BX) {
      const int p = wi * ww + wj, i = a.r0 + wi, j = a.c0 + wj;
      const size_t g = (size_t)i * ny + j;
      const float xpn = xp[p];
      const float zpx = below(src, i) ? xp[p + ww] - xpn : 0.f;
      const float zpy = j < ny - 1 ? xp[p + 1] - xpn : 0.f;
      float t2x = 0.f, t2y = 0.f;
      if (!dead_row(src, i)) {
        const float zd = scale ? src.zd[g] * fac : src.zd[g];
        t2x = SQRT_S * (src.zh[g] + zd);
      }
      if (j < ny - 1) {
        const float zd = scale ? src.zd[n + g] * fac : src.zd[n + g];
        t2y = SQRT_S * (src.zh[n + g] + zd);
      }
      const Upd o = update_val(
          xpn, T[p], zpx, zpy, t2x, t2y, __ldg(src.f + g),
          dataterm == DT_WSQUARE ? __ldg(src.w + g) : 0.f, dataterm, us);
      dst.xh[g] = o.xh;
      dst.xp[g] = xpn;
      dst.xd[g] = o.xd;
      dst.zh[g] = o.zhx;
      dst.zh[n + g] = o.zhy;
      dst.zd[g] = o.zdx;
      dst.zd[n + g] = o.zdy;
      dst.warm[g] = X[p];
      if (last) {
        dst.zp[g] = zpx;
        dst.zp[n + g] = zpy;
      }
    }
}

// `count` iterations from slot `start` (0: A, the caller's planes; 1: B),
// then admm_norm_partial's tiles of the slot written last.  `pending`: the
// planes owe sc[S_FAC] on x_dual and z_dual (a multichunk's later chunk).
// sb.zp is sa.zp.
__global__ void __launch_bounds__(AT_THREADS, 1)
    admm_tiled(State sa, State sb, float alpha, float oma, int dataterm,
               int degree, const float* __restrict__ coeffs, int count,
               int start, int pending, int tx, int ty) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (conv_set(sa.sc)) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const int nx = sa.nx, ny = sa.ny;
  const float fac = sa.sc[S_FAC];
  const UpdScal us = upd_scal(sa.sc);
  const int nwin = ((nx + tx - 1) / tx) * ((ny + ty - 1) / ty);
  for (int it = 0; it < count; ++it) {
    const bool b_in = ((start + it) & 1) != 0;
    const State& src = b_in ? sb : sa;
    const State& dst = b_in ? sa : sb;
    for (int tile = blockIdx.x; tile < nwin; tile += gridDim.x) {
      tiled_iteration(src, dst, smem, alpha, oma, dataterm, degree, coeffs,
                      tile, tx, ty, pending && it == 0, fac,
                      it == count - 1, us);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }

  // admm_norm_partial's tiles, four at a time (block_partial's tree)
  const State& fin = ((start + count) & 1) ? sb : sa;
  const int ntx = (ny + BX - 1) / BX;
  const int ntiles = (nx + BY - 1) / BY * ntx;
  const int group = threadIdx.x / NT, t = threadIdx.x % NT;
  const int groups = AT_THREADS / NT;
  float* red = smem + group * 4 * NT;  // red[k * NT + t]
  for (int base = groups * blockIdx.x; base < ntiles;
       base += groups * gridDim.x) {
    const int tile = base + group;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < ntiles) {
      int i = tile / ntx * BY + t / BX, j = tile % ntx * BX + t % BX;
      if (i < nx && j < ny && i >= fin.rows.own_lo && i < fin.rows.own_hi)
        norm_terms_at(fin, i, j, v);
    }
    for (int k = 0; k < 4; ++k) red[k * NT + t] = v[k];
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int k = 0; k < 4; ++k) red[k * NT + t] += red[k * NT + t + s];
      __syncthreads();
    }
    if (t == 0 && tile < ntiles)
      for (int k = 0; k < 4; ++k) fin.partial[PS * tile + k] = red[k * NT];
    __syncthreads();  // the next pass overwrites red
  }
}

// After a tiled chunk (multi 0) whose flag was not set at entry and whose
// count was odd: slot B's state into the caller's planes.  After a tiled
// multichunk (multi 1) that ran a chunk: the last executed chunk's dual
// rescale, x_dual and z_dual times sc[S_FAC] (admm_rescale's product),
// from slot B where its last iteration wrote there (an odd total count).
__global__ void admm_tiled_settle(State sa, State sb, int count, int multi) {
  const float* sc = sa.sc;
  const int done = multi ? (int)sc[S_DONE] : (sc[S_CONV] != 0.f ? 0 : 1);
  if (done == 0) return;
  const bool from_b = (((long long)done * count) & 1) != 0;
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
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, (const void*)admm_tiled);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)a.sharedSizeBytes;
}

// Slot B of the tiled launch: xh, xp, xd, zh (2), zd (2) and warm in the 8
// scratch planes; z_proj, which only the last iteration writes, is the
// caller's.
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

// One tiled launch of `count` iterations from slot `start`: one block of
// AT_THREADS on each SM; a tile that is not a multiple of the 32x8 norm
// tiles or whose window does not fit in a block's shared memory is refused
// with cudaErrorInvalidValue, a grid the card cannot hold at once by the
// card (cudaErrorCooperativeLaunchTooLarge).
int tiled_launch(State& a, State& b, float alpha, float oma, int dataterm,
                 int degree, const float* cf, int count, int start,
                 int pending, int tx, int ty, cudaStream_t st) {
  if (tx < BY || tx % BY || ty < BX || ty % BX || degree < 1 || count < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = admm_tiled_smem(tx, ty, degree);
  const int limit = admm_tiled_limit();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)admm_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, admm_tiled,
                                                      AT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &alpha, &oma, &dataterm, &degree, &cf,
                  &count, &start, &pending, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)admm_tiled, dim3(sms),
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
// an odd count, the copy back (admm_tiled_settle).  Bit-equal to
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
  return count & 1 ? tiled_settle(a, b, count, 0, st) : 0;
}

// admm_fused_multichunk by tiled launches: the arguments of
// prost_admm_multichunk_resident and the owned tile, `scratch` of 8 planes
// (slot B).  Chunk c is a tiled launch from slot (c count) mod 2, its
// loads applying the rescale chunk c - 1 decided, and admm_finish's
// OP_ADAPT_HOLD; then admm_tiled_settle.  Bit-equal to
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
                              (int)(((long long)ch * count) & 1), ch > 0,
                              tx, ty, st))
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

// The blocks of admm_iter_halo's cooperative launch on the current device,
// or minus the error that refuses it.
int prost_admm_coop_blocks() {
  int blocks = 0;
  int rc = coop_blocks(&blocks);
  return rc ? -rc : blocks;
}

}  // extern "C"
