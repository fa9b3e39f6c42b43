// Fused fast-multilabel PDHG chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package's multilabel routes:
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk      -> _ml_chunk_kernel
//   prost_tpu/ops/fused_multilabel.py  ml_fused_multichunk -> _ml_multichunk_kernel
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk_batched
//                                      -> _ml_chunk_kernel_batched
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk_halo
//                                      -> _ml_chunk_kernel (halo=True)
// whose math is _ml_chunk_core, _ml_update, _shift_ops_3d (whole plane,
// maskless adjoint) and _project_dead_dual_3d in the same file, and
// adapt_scalars in fused_rof.py.  They also serve the JAX package's banded
// variants (ml_fused_chunk_banded, ml_fused_multichunk_banded), which exist
// only because a TPU core's VMEM cannot hold the planes at 512x512x8: here
// the planes stay in device memory at every size.  The plain PyTorch
// versions live beside their wrappers in prost_tpu_torch/ops/fused_multilabel.py.
//
// Layout (the JAX package's): u, f are (L, nx, ny) row-major f32 label
// planes; q and the carried gradient g are 2L such planes, [x part; y part];
// s and the carried label sum su are (nx, ny) planes.  A batched launch
// takes B such instances back to back on the z axis of the grid, with
// S_LEN scalars per instance (pdhg_chunk.cuh).  A halo launch takes one
// shard of a row-partitioned plane extended by `halo` rows of each
// neighbour, with the row context of pdhg_chunk.cuh (global row masks,
// owned-row norms); the whole-plane launches are its case (0, nx, 0, nx).
//
// What bounds it on this card.  An iteration streams about 14L + 5 planes
// (primal: u, 2L q, s, f in, u out; dual: u, 2L q, 2L g, s, su in, 2L q,
// 2L g, s, su out), 117 at L = 8: 30 MB at 256x256, 122 MB at 512x512.
// The TPU kernels hold that state in VMEM for a chunk; here it lives in
// device memory (in the 50 MB L2 at 256x256x8, beyond it at 512x512x8), so
// every kernel is bound by memory traffic, and a chunk of ri iterations is
// 2*ri + 3 launches.
//
// Design.  One thread per pixel, 32x8 blocks with threadIdx.x along the
// contiguous y axis (pdhg_chunk.cuh), and each thread loops over the L
// labels: the per-pixel reductions (su = sum_l u_l and the squared norm of
// the 2L-component dual vector) are over labels, so a pixel's labels
// belong in one thread.  As in fused_rof.cu, dx u, dy u and su are carried
// from one iteration to the next, every kernel updates its planes in place,
// and a kernel reads neighbours only from a plane it does not write: the
// primal step writes u and reads q's neighbours, the dual step writes q, g,
// s, su and reads u's.  The dual step holds the pixel's 2L projected
// components in registers (template on L up to 8) between the norm and the
// scaling; beyond 8 labels it writes them unscaled and rescales them in a
// second loop over its own entries.  The scalars live in the device buffer
// `sc` (pdhg_chunk.cuh), and every kernel returns at once once sc[S_CONV]
// is set, so a multichunk launch is a host loop of launches without a sync.
//
// Rounding.  Built with -fmad=false; each constant is rounded once from
// double as the plain version rounds its Python constants: 0.2, 0.5,
// sqrt(1/5) and sqrt(1/2) here, 1/L and sqrt(1/L) computed by the wrapper.
// The differences to the plain version are rsqrtf in the ball projection,
// the order of the label sums (left to right here) and of the norm sums.
// A zero dual vector keeps scale 1 (its projection is itself), where the
// JAX form gives NaN for radius 0.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "pdhg_chunk.cuh"

namespace {

// the family's two scalars in the buffer's slots 3 and 4
enum { S_BALL = S_ARG3, S_DS = S_ARG4 };  // ball radius, multiplier shift

constexpr float TAU_C = (float)0.2;                  // Tau = 1/5
constexpr float SIG_Q = (float)0.5;                  // Sigma_q = 1/2
constexpr float SQRT_T = (float)0.4472135954999579;  // sqrt(Tau)
constexpr float SQRT_S_Q = (float)0.7071067811865476;  // sqrt(Sigma_q)
constexpr int MAX_REG_L = 8;  // labels held in registers by ml_dual

struct ML {
  float* u;    // (L, nx, ny) iterate, updated in place
  float* q;    // (2L, nx, ny) gradient duals, updated in place
  float* s;    // (nx, ny) multiplier, updated in place
  float* up;   // u, q, s before the chunk's last (aligned) iteration
  float* qp;
  float* sp;
  float* g;    // (2L, nx, ny) [dx u; dy u] carried between iterations
  float* gp;   // the same of u_prev
  float* su;   // (nx, ny) sum_l u carried between iterations
  float* sup;  // the same of u_prev
  const float* f;
  float* sc;
  float* partial;  // 4 per block
  int L, nx, ny;
  int nxg;           // rows of the global plane of a halo launch; 0: whole
  float inv_l;       // Sigma_s = 1/L
  float sqrt_inv_l;  // sqrt(Sigma_s)
};

// The buffers of this block's instance (blockIdx.z) of a batched launch,
// each moved by its per-instance size with 64-bit offsets: the dual of
// 4096 instances of 256x256x8 holds 2^32 entries.
__device__ __forceinline__ ML instance_of(ML b) {
  size_t z = blockIdx.z, n = (size_t)b.nx * b.ny, nl = n * b.L;
  b.u += z * nl;
  b.q += 2 * z * nl;
  b.s += z * n;
  b.up += z * nl;
  b.qp += 2 * z * nl;
  b.sp += z * n;
  b.g += 2 * z * nl;
  b.gp += 2 * z * nl;
  b.su += z * n;
  b.sup += z * n;
  b.f += z * nl;
  b.sc += z * S_LEN;
  return b;
}

// Seed of a launch: g = [dx u; dy u], su = sum_l u, and the dead dual
// coordinates zeroed in every label plane (_project_dead_dual_3d at chunk
// entry; the dual step keeps them zero).
// Bound: memory, L planes read, 2L + 1 written.  Runs once per launch.
__global__ void ml_seed(ML b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  int nx = b.nx, ny = b.ny;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * b.L;
  RowCtx r = row_ctx(b.sc, nx, b.nxg);
  bool below = has_below(r, i, nx), dead = dead_row(r, i);
  float acc = 0.f;
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float uv = b.u[pl];
    b.g[pl] = below ? b.u[pl + ny] - uv : 0.f;
    b.g[nl + pl] = j < ny - 1 ? b.u[pl + 1] - uv : 0.f;
    acc = l == 0 ? uv : acc + uv;
    if (dead) b.q[pl] = 0.f;
    if (j == ny - 1) b.q[nl + pl] = 0.f;
  }
  b.su[p] = acc;
}

// Primal step (_ml_update, first half): for every label,
// kty = dxt(q_x) + dyt(q_y) + s and u <- max(u - tau/5 kty - tau/5 f, 0).
// The bounds-checked neighbours equal the JAX package's maskless roll
// adjoint because the dead coordinates are zero.
// Bound: memory, 4L + 1 planes read (u, q, f, s), L written (2L on the
// aligned iteration, which also saves u_prev).
__global__ void ml_primal(ML b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  int ny = b.ny;
  size_t n = (size_t)b.nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * b.L;
  float tau = b.sc[S_TAU] * TAU_C;  // tau * Tau
  float sv = b.s[p];
  bool above = has_above(row_ctx(b.sc, b.nx, b.nxg), i);
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float qx = b.q[pl], qy = b.q[nl + pl];
    float lx = above ? b.q[pl - ny] : 0.f;
    float ly = j > 0 ? b.q[nl + pl - 1] : 0.f;
    float kty = ((lx - qx) + (ly - qy)) + sv;
    float uv = b.u[pl];
    float tf = tau * b.f[pl];
    float un = fmaxf((uv - tau * kty) - tf, 0.f);
    if (save_prev) b.up[pl] = uv;
    b.u[pl] = un;
  }
}

// Dual step (_ml_update, second half): the gradient of the new u and its
// label sum, q <- proj of the extrapolated q onto the per-pixel
// radius-lmb ball over all 2L components, and s <- s + sig_s ((1 + theta)
// su_new - theta su) - sig_s d_s.  The new gradient and sum are carried
// into g and su.  LT > 0: L == LT, the pixel's components in registers;
// LT == 0: any L, two passes over the pixel's own q entries.
// Bound: memory, 5L + 2 planes read (u, q, g, s, su), 4L + 2 written (8L
// + 4 on the aligned iteration, which saves q, s, g and su of u_prev).
template <int LT>
__global__ void ml_dual(ML b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  const int L = LT > 0 ? LT : b.L;
  int nx = b.nx, ny = b.ny;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * L;
  float sigma = b.sc[S_SIGMA], theta = b.sc[S_THETA];
  float sig_q = sigma * SIG_Q;      // sigma * Sigma_q
  float sig_s = sigma * b.inv_l;    // sigma * Sigma_s
  float tp = 1.f + theta;
  float ax[LT > 0 ? LT : 1], ay[LT > 0 ? LT : 1];
  float su2 = 0.f, nrm2 = 0.f;
  bool below = has_below(row_ctx(b.sc, nx, b.nxg), i, nx);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    size_t pl = l * n + p;
    float uv = b.u[pl];
    float gx2 = below ? b.u[pl + ny] - uv : 0.f;
    float gy2 = j < ny - 1 ? b.u[pl + 1] - uv : 0.f;
    su2 = l == 0 ? uv : su2 + uv;
    float qx = b.q[pl], qy = b.q[nl + pl];
    float gx = b.g[pl], gy = b.g[nl + pl];
    float axv = qx + sig_q * (tp * gx2 - theta * gx);
    float ayv = qy + sig_q * (tp * gy2 - theta * gy);
    float t = axv * axv + ayv * ayv;
    nrm2 = l == 0 ? t : nrm2 + t;
    if (save_prev) {
      b.qp[pl] = qx;
      b.qp[nl + pl] = qy;
      b.gp[pl] = gx;
      b.gp[nl + pl] = gy;
    }
    b.g[pl] = gx2;
    b.g[nl + pl] = gy2;
    if constexpr (LT > 0) {
      ax[l] = axv;
      ay[l] = ayv;
    } else {
      b.q[pl] = axv;
      b.q[nl + pl] = ayv;
    }
  }
  float scale = nrm2 > 0.f ? fminf(1.f, b.sc[S_BALL] * rsqrtf(nrm2)) : 1.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    size_t pl = l * n + p;
    if constexpr (LT > 0) {
      b.q[pl] = ax[l] * scale;
      b.q[nl + pl] = ay[l] * scale;
    } else {
      b.q[pl] = b.q[pl] * scale;
      b.q[nl + pl] = b.q[nl + pl] * scale;
    }
  }
  float sv = b.s[p], suv = b.su[p];
  if (save_prev) {
    b.sp[p] = sv;
    b.sup[p] = suv;
  }
  b.s[p] = (sv + sig_s * (tp * su2 - theta * suv)) - sig_s * b.sc[S_DS];
  b.su[p] = su2;
}

// K^T y at label plane l of pixel (i, j) from duals (q, s).
__device__ __forceinline__ float kty_at(const float* q, float sv, size_t pl,
                                        size_t nl, bool above, int j,
                                        int ny) {
  float qx = q[pl], qy = q[nl + pl];
  float lx = above ? q[pl - ny] : 0.f;
  float ly = j > 0 ? q[nl + pl - 1] : 0.f;
  return ((lx - qx) + (ly - qy)) + sv;
}

// First pass of the four preconditioned residual norms (_ml_chunk_core
// after the aligned iteration): per pixel the terms of |pd|^2, |z_hat|^2,
// |dd|^2 and |w_hat|^2 over the 2L + 1 dual planes and the L primal
// planes, then per-block tree sums into partial[4 * block].
// Bound: memory, 10L + 4 planes read once per chunk.
__global__ void ml_norm_partial(ML b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  if (pixel(b.nx, b.ny, i, j) && owned_row(r, i)) {
    int ny = b.ny;
    size_t n = (size_t)b.nx * ny, p = (size_t)i * ny + j;
    size_t nl = n * b.L;
    bool above = has_above(r, i);
    float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
    float theta = b.sc[S_THETA];
    float tp = 1.f + theta;
    float inv_q = 1.f / (sigma_raw * SQRT_S_Q);
    float inv_s = 1.f / (sigma_raw * b.sqrt_inv_l);
    float inv_t = 1.f / (tau_raw * SQRT_T);
    float s2 = b.s[p], spv = b.sp[p];
    for (int l = 0; l < b.L; ++l) {
      size_t pl = l * n + p;
      float gx2 = b.g[pl], gy2 = b.g[nl + pl];
      float zx = (b.qp[pl] - b.q[pl]) * inv_q
                 + SQRT_S_Q * (tp * gx2 - theta * b.gp[pl]);
      float zy = (b.qp[nl + pl] - b.q[nl + pl]) * inv_q
                 + SQRT_S_Q * (tp * gy2 - theta * b.gp[nl + pl]);
      float pdx = zx - SQRT_S_Q * gx2;
      float pdy = zy - SQRT_S_Q * gy2;
      float kty2 = kty_at(b.q, s2, pl, nl, above, j, ny);
      float ktyp = kty_at(b.qp, spv, pl, nl, above, j, ny);
      float wh = (b.up[pl] - b.u[pl]) * inv_t - SQRT_T * ktyp;
      float dd = wh + SQRT_T * kty2;
      v[0] += pdx * pdx + pdy * pdy;
      v[1] += zx * zx + zy * zy;
      v[2] += dd * dd;
      v[3] += wh * wh;
    }
    float su2 = b.su[p];
    float zs = (spv - s2) * inv_s
               + b.sqrt_inv_l * (tp * su2 - theta * b.sup[p]);
    float pds = zs - b.sqrt_inv_l * su2;
    v[0] += pds * pds;
    v[1] += zs * zs;
  }
  block_partials(v, b.partial);
}

template <int LT>
void launch_dual(const ML& b, dim3 grid, dim3 block, int last,
                 cudaStream_t s) {
  ml_dual<LT><<<grid, block, 0, s>>>(b, last);
}

void dual(const ML& b, dim3 grid, dim3 block, int last, cudaStream_t s) {
  switch (b.L) {
    case 1: launch_dual<1>(b, grid, block, last, s); break;
    case 2: launch_dual<2>(b, grid, block, last, s); break;
    case 3: launch_dual<3>(b, grid, block, last, s); break;
    case 4: launch_dual<4>(b, grid, block, last, s); break;
    case 5: launch_dual<5>(b, grid, block, last, s); break;
    case 6: launch_dual<6>(b, grid, block, last, s); break;
    case 7: launch_dual<7>(b, grid, block, last, s); break;
    case MAX_REG_L: launch_dual<MAX_REG_L>(b, grid, block, last, s); break;
    default: launch_dual<0>(b, grid, block, last, s);
  }
}

// One chunk of `count` iterations of `batch` instances without the seed:
// count-1 plain iterations, the aligned iteration saving the previous
// iterate and its carried planes, and the per-block norm partials.
int chunk_body(const ML& b, int count, int batch, cudaStream_t s) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  for (int k = 0; k < count; ++k) {
    int last = k == count - 1;
    ml_primal<<<grid, block, 0, s>>>(b, last);
    LAUNCH_CHECK();
    dual(b, grid, block, last, s);
    LAUNCH_CHECK();
  }
  ml_norm_partial<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  return 0;
}

// One chunk of `batch` instances: the seed, the chunk body, and the
// squared norms of every instance into its scalars (one finish block each).
int chunk(const ML& b, int count, int batch, cudaStream_t st) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  ml_seed<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  int rc = chunk_body(b, count, batch, st);
  if (rc) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, st>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                     count, 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

ML ml_of(void* u, void* q, void* s, void* up, void* qp, void* sp, void* g,
         void* gp, void* su, void* sup, const void* f, void* sc,
         void* partial, int L, int nx, int ny, float inv_l,
         float sqrt_inv_l) {
  ML b;
  b.u = (float*)u;
  b.q = (float*)q;
  b.s = (float*)s;
  b.up = (float*)up;
  b.qp = (float*)qp;
  b.sp = (float*)sp;
  b.g = (float*)g;
  b.gp = (float*)gp;
  b.su = (float*)su;
  b.sup = (float*)sup;
  b.f = (const float*)f;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.L = L;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  b.inv_l = inv_l;
  b.sqrt_inv_l = sqrt_inv_l;
  return b;
}

}  // namespace

extern "C" {

// Number of per-block norm partials (4 floats each) for an (nx, ny) plane.
int prost_ml_num_blocks(int nx, int ny) {
  dim3 g = grid_of(nx, ny);
  return (int)(g.x * g.y);
}

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ml_fused_chunk: `count` iterations on (u, q, s) in place, the previous
// iterate of the aligned iteration into (up, qp, sp), the 4 SQUARED norms
// into sc[S_NORM..].  No-op when sc[S_CONV] is set.
int prost_ml_chunk(void* u, void* q, void* s, void* up, void* qp, void* sp,
                   void* g, void* gp, void* su, void* sup, const void* f,
                   void* sc, void* partial, int L, int nx, int ny,
                   float inv_l, float sqrt_inv_l, int count, void* stream) {
  ML b = ml_of(u, q, s, up, qp, sp, g, gp, su, sup, f, sc, partial, L, nx,
               ny, inv_l, sqrt_inv_l);
  return chunk(b, count, 1, (cudaStream_t)stream);
}

// ml_fused_chunk_batched: the same for `batch` instances in one launch
// sequence; sc holds S_LEN scalars per instance, partial 4 per block per
// instance.  An instance whose sc[S_CONV] is set is a no-op.
int prost_ml_chunk_batched(void* u, void* q, void* s, void* up, void* qp,
                           void* sp, void* g, void* gp, void* su, void* sup,
                           const void* f, void* sc, void* partial, int L,
                           int nx, int ny, float inv_l, float sqrt_inv_l,
                           int count, int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  ML b = ml_of(u, q, s, up, qp, sp, g, gp, su, sup, f, sc, partial, L, nx,
               ny, inv_l, sqrt_inv_l);
  return chunk(b, count, batch, (cudaStream_t)stream);
}

// ml_fused_multichunk: up to k_chunks chunks, the carried planes kept
// across chunks, adaptation + stopping test on the device after each
// chunk, and every kernel after convergence returning at once (the
// lax.cond skip).  sc[S_NORM..] ends with the last executed chunk's sqrt'd
// norms.
// ml_fused_chunk_halo: ml_chunk on one halo-extended shard of a plane of
// nx_global rows; sc holds the row context and the squared norms cover the
// owned rows only.
int prost_ml_chunk_halo(void* u, void* q, void* s, void* up, void* qp,
                        void* sp, void* g, void* gp, void* su, void* sup,
                        const void* f, void* sc, void* partial, int L, int nx,
                        int ny, float inv_l, float sqrt_inv_l, int nx_global,
                        int count, void* stream) {
  ML b = ml_of(u, q, s, up, qp, sp, g, gp, su, sup, f, sc, partial, L, nx,
               ny, inv_l, sqrt_inv_l);
  b.nxg = nx_global;
  return chunk(b, count, 1, (cudaStream_t)stream);
}

int prost_ml_multichunk(void* u, void* q, void* s, void* up, void* qp,
                        void* sp, void* g, void* gp, void* su, void* sup,
                        const void* f, void* sc, void* partial, int L, int nx,
                        int ny, float inv_l, float sqrt_inv_l, int count,
                        int k_chunks, int stepsize, float sqrt_nrows,
                        float sqrt_ncols, float arg_delta, float arg_nu,
                        float arb_delta, float arb_tau, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ML b = ml_of(u, q, s, up, qp, sp, g, gp, su, sup, f, sc, partial, L, nx,
               ny, inv_l, sqrt_inv_l);
  dim3 grid = grid_of(nx, ny), block(BX, BY);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  ml_seed<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  for (int k = 0; k < k_chunks; ++k) {
    int rc = chunk_body(b, count, 1, st);
    if (rc) return rc;
    pdhg_finish<<<1, FIN, 0, st>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                   count, 1, stepsize, c);
    LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
