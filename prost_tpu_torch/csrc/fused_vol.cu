// Fused volumetric-TV PDHG chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package's volumetric routes:
//   prost_tpu/ops/fused_vol.py  vol_fused_chunk      -> _vol_chunk_kernel
//   prost_tpu/ops/fused_vol.py  vol_fused_multichunk -> _vol_multichunk_kernel
//   prost_tpu/ops/fused_vol.py  vol_fused_chunk_batched
//                               -> _vol_chunk_kernel_batched
//   prost_tpu/ops/fused_vol.py  vol_fused_chunk_halo
//                               -> _vol_chunk_kernel (halo=True)
// whose math is _vol_chunk_core, _vol_update, _vol_ops (whole volume,
// maskless x/y adjoints) and _project_dead_dual_vol in the same file, and
// adapt_scalars in fused_rof.py.  They also serve the JAX package's banded
// variants (vol_fused_chunk_banded, vol_fused_multichunk_banded), which
// exist only because a TPU core's VMEM holds volumes of up to about 1.1 M
// voxels: here the volume stays in device memory at every size.  The plain
// PyTorch versions live beside their wrappers in
// prost_tpu_torch/ops/fused_vol.py.
//
// Layout (the JAX package's): u, f, w are (L, nx, ny) row-major f32
// volumes; q and the carried gradient g are three such volumes back to
// back, [x part; y part; label part] (BlockGradient3D's segment order).  A
// batched launch takes B such instances back to back on the z axis of the
// grid, with S_LEN scalars per instance (pdhg_chunk.cuh).  A halo launch
// takes one shard of the nx axis extended by `halo` rows of each
// neighbour, with the row context of pdhg_chunk.cuh (global row masks,
// owned-row norms); the label axis keeps its Dirichlet ends, and the
// whole-volume launches are the case (0, nx, 0, nx).
//
// The stencils: x and y forward differences with a Neumann boundary (zero
// last difference), the label difference with a Dirichlet far boundary,
// dl(u)[l] = (l < L-1 ? u[l+1] : 0) - u[l], and its adjoint dlt(p)[l] =
// (l > 0 ? p[l-1] : 0) - p[l].  q_x's last row and q_y's last column are
// dead (they multiply zero rows of K) and are zeroed by vol_seed, so the x
// and y adjoints read plain bounds-checked neighbours; q_l's last label
// plane is live (it couples to -u_last) and is never zeroed.
//
// What bounds it on this card.  A chunk at 256x256x8 reads u, q (3
// volumes) and f and writes u, q and their previous iterate: 13 volumes of
// 2 MiB; an iteration streams about 16 volumes (primal: u, 3 q, f in, u
// out; dual: u, 3 q, 3 g in, 3 q, 3 g out), 33.5 MB at 256x256x8, which
// fits the 50 MB L2, and 134 MB at 512x512x8, which does not.  The TPU
// kernels hold that state in VMEM for a chunk; here it lives in device
// memory, so every kernel is bound by memory traffic and, at these sizes,
// by launch latency: a chunk of ri iterations is 2*ri + 3 launches.
//
// Design.  One thread per (i, j) pixel of the 32x8 pixel grid of
// pdhg_chunk.cuh, looping over the L labels, as in fused_multilabel.cu: the
// label neighbours (u[l+1] in the dual step and the seed, q_l[l-1] in the
// primal step and the norms) ride in a register along the loop, and the
// grid, the block tree of the norm partials and pdhg_finish serve
// unchanged.  The gradient of u is carried from one iteration to the next
// in g (saves 3 of 9 stencils), and every kernel updates its volumes in
// place: the primal step writes only u and reads q's neighbours, the dual
// step writes only q and g and reads u's.  The scalars live in the device
// buffer `sc`, and every kernel returns at once once sc[S_CONV] is set, so
// a multichunk launch is a host loop of launches without a sync.
//
// Rounding.  Built with -fmad=false; Tau = 1/6, sqrt(1/2) and sqrt(1/6)
// are rounded once from double, as the plain version rounds its Python
// constants.  The differences to the plain version are rsqrtf in the ball
// projection and the order of the norm sums (per voxel over x, y and label
// terms, over labels, then block trees, where the JAX package and the
// plain version take three whole-volume sums).  A zero dual vector keeps
// scale 1 (its projection is itself), where the JAX form gives NaN for
// radius 0.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "pdhg_chunk.cuh"

namespace {

// the family's two scalars in the buffer's slots 3 and 4
enum { S_LMB = S_ARG3, S_RADIUS = S_ARG4 };

enum { DT_SQUARE = 0, DT_WSQUARE = 1, DT_ABS = 2 };

constexpr float TAU_C = (float)(1.0 / 6.0);            // Tau = 1/6
constexpr float SQRT_S = (float)0.7071067811865476;    // sqrt(Sigma)
constexpr float SQRT_T = (float)0.4082482904638631;    // sqrt(Tau)

struct Vol {
  float* u;    // (L, nx, ny) iterate, updated in place
  float* q;    // (3, L, nx, ny) dual, updated in place
  float* up;   // u before the chunk's last (aligned) iteration
  float* qp;   // q before the aligned iteration
  float* g;    // grad3 u carried between iterations
  float* gp;   // grad3 u_prev
  const float* f;
  const float* w;
  float* sc;
  float* partial;  // 4 per block
  int L, nx, ny;
  int nxg;  // rows of the global plane of a halo launch; 0: the whole plane
};

// The buffers of this block's instance (blockIdx.z) of a batched launch,
// each moved by its per-instance size with 64-bit offsets.
__device__ __forceinline__ Vol instance_of(Vol b) {
  size_t z = blockIdx.z, nl = (size_t)b.nx * b.ny * b.L;
  b.u += z * nl;
  b.q += 3 * z * nl;
  b.up += z * nl;
  b.qp += 3 * z * nl;
  b.g += 3 * z * nl;
  b.gp += 3 * z * nl;
  b.f += z * nl;
  b.w += z * nl;
  b.sc += z * S_LEN;
  return b;
}

// K^T q at voxel (l, i, j): the maskless x and y adjoints (exact, the dead
// coordinates being zero) plus the masked label adjoint, whose neighbour
// q_l[l-1] the caller carries as `ql_below` (0 at l = 0).
__device__ __forceinline__ float kty_at(const float* q, size_t pl,
                                        size_t nl, bool above, int j, int ny,
                                        float ql_below) {
  float qx = q[pl], qy = q[nl + pl], ql = q[2 * nl + pl];
  float lx = above ? q[pl - ny] : 0.f;
  float ly = j > 0 ? q[nl + pl - 1] : 0.f;
  return ((lx - qx) + (ly - qy)) + (ql_below - ql);
}

// Seed of a launch: g = grad3 u, and the dead dual coordinates zeroed in
// every label plane (_project_dead_dual_vol at chunk entry; the dual step
// keeps them zero).  Replaces the seed stencils of _vol_chunk_core.
// Bound: memory, L volumes' worth of u read, 3 written.  Once per launch.
__global__ void vol_seed(Vol b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  int nx = b.nx, ny = b.ny, L = b.L;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * L;
  RowCtx r = row_ctx(b.sc, nx, b.nxg);
  bool below = has_below(r, i, nx), dead = dead_row(r, i);
  float un = b.u[p];
  for (int l = 0; l < L; ++l) {
    size_t pl = l * n + p;
    float uv = un;
    un = l < L - 1 ? b.u[pl + n] : 0.f;
    b.g[pl] = below ? b.u[pl + ny] - uv : 0.f;
    b.g[nl + pl] = j < ny - 1 ? b.u[pl + 1] - uv : 0.f;
    b.g[2 * nl + pl] = un - uv;
    if (dead) b.q[pl] = 0.f;
    if (j == ny - 1) b.q[nl + pl] = 0.f;
  }
}

// Primal step (_vol_update, first half): u <- prox_g(u - tau/6 K^T q) for
// every label, with the data term hoisted as in _vol_chunk_core.
// Bound: memory, 5 volumes read (u, 3 q, f; +w for wsquare), 1 written (2
// on the aligned iteration, which also saves u_prev).
__global__ void vol_primal(Vol b, int dataterm, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  int ny = b.ny;
  size_t n = (size_t)b.nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * b.L;
  float tau = b.sc[S_TAU] * TAU_C;  // tau * Tau
  float tl = tau * b.sc[S_LMB];
  bool above = has_above(row_ctx(b.sc, b.nx, b.nxg), i);
  float ql_below = 0.f;
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float kty = kty_at(b.q, pl, nl, above, j, ny, ql_below);
    ql_below = b.q[2 * nl + pl];
    float uv = b.u[pl];
    float arg = uv - tau * kty;
    float un;
    if (dataterm == DT_SQUARE) {
      float dt0 = tl * b.f[pl];
      float dt1 = 1.f / (1.f + tl);
      un = (arg + dt0) * dt1;
    } else if (dataterm == DT_WSQUARE) {
      float tw = tl * b.w[pl];
      float dt0 = tw * b.f[pl];
      float dt1 = 1.f / (1.f + tw);
      un = (arg + dt0) * dt1;
    } else {  // abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
      float d = arg - b.f[pl];
      un = arg - fminf(fmaxf(d, -tl), tl);
    }
    if (save_prev) b.up[pl] = uv;
    b.u[pl] = un;
  }
}

// Dual step (_vol_update, second half): q <- proj_{|.|<=r}(q + sig_p grad3
// u_new - sig_t grad3 u) voxel by voxel over the 3 components, grad3 u_new
// carried into g.
// Bound: memory, 7 volumes read (u, 3 q, 3 g), 6 written (12 on the
// aligned iteration, which saves q_prev and grad3 u_prev).
__global__ void vol_dual(Vol b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  int nx = b.nx, ny = b.ny, L = b.L;
  size_t n = (size_t)nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * L;
  float sigma_p = b.sc[S_SIGMA] * 0.5f;  // sigma * Sigma
  float theta = b.sc[S_THETA];
  float sig_p = sigma_p * (1.f + theta);
  float sig_t = sigma_p * theta;
  float radius = b.sc[S_RADIUS];
  bool below = has_below(row_ctx(b.sc, nx, b.nxg), i, nx);
  float un = b.u[p];
  for (int l = 0; l < L; ++l) {
    size_t pl = l * n + p;
    float uv = un;
    un = l < L - 1 ? b.u[pl + n] : 0.f;
    float gxn = below ? b.u[pl + ny] - uv : 0.f;
    float gyn = j < ny - 1 ? b.u[pl + 1] - uv : 0.f;
    float gln = un - uv;
    float qx = b.q[pl], qy = b.q[nl + pl], ql = b.q[2 * nl + pl];
    float gx = b.g[pl], gy = b.g[nl + pl], gl = b.g[2 * nl + pl];
    float ax = (qx + sig_p * gxn) - sig_t * gx;
    float ay = (qy + sig_p * gyn) - sig_t * gy;
    float al = (ql + sig_p * gln) - sig_t * gl;
    float nn = (ax * ax + ay * ay) + al * al;
    float scale = nn > 0.f ? fminf(1.f, radius * rsqrtf(nn)) : 1.f;
    if (save_prev) {
      b.qp[pl] = qx;
      b.qp[nl + pl] = qy;
      b.qp[2 * nl + pl] = ql;
      b.gp[pl] = gx;
      b.gp[nl + pl] = gy;
      b.gp[2 * nl + pl] = gl;
    }
    b.q[pl] = ax * scale;
    b.q[nl + pl] = ay * scale;
    b.q[2 * nl + pl] = al * scale;
    b.g[pl] = gxn;
    b.g[nl + pl] = gyn;
    b.g[2 * nl + pl] = gln;
  }
}

// First pass of the four preconditioned residual norms (_vol_chunk_core
// after the aligned iteration): per voxel the x, y and label terms of
// |pd|^2, |z_hat|^2 and the |dd|^2, |w_hat|^2 terms, summed over the
// pixel's labels, then per-block tree sums into partial[4 * block].
// Bound: memory, 16 volumes read once per chunk.
__global__ void vol_norm_partial(Vol b) {
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
    float inv_s = 1.f / (sigma_raw * SQRT_S);
    float inv_t = 1.f / (tau_raw * SQRT_T);
    float ql2_below = 0.f, qlp_below = 0.f;
    for (int l = 0; l < b.L; ++l) {
      size_t pl = l * n + p;
      float kty2 = kty_at(b.q, pl, nl, above, j, ny, ql2_below);
      float ktyp = kty_at(b.qp, pl, nl, above, j, ny, qlp_below);
      ql2_below = b.q[2 * nl + pl];
      qlp_below = b.qp[2 * nl + pl];
      float z[3], pd[3];
      for (int c = 0; c < 3; ++c) {
        size_t pc = c * nl + pl;
        float g2 = b.g[pc];
        z[c] = (b.qp[pc] - b.q[pc]) * inv_s
               + SQRT_S * (tp * g2 - theta * b.gp[pc]);
        pd[c] = z[c] - SQRT_S * g2;
      }
      float wh = (b.up[pl] - b.u[pl]) * inv_t - SQRT_T * ktyp;
      float dd = wh + SQRT_T * kty2;
      v[0] += (pd[0] * pd[0] + pd[1] * pd[1]) + pd[2] * pd[2];
      v[1] += (z[0] * z[0] + z[1] * z[1]) + z[2] * z[2];
      v[2] += dd * dd;
      v[3] += wh * wh;
    }
  }
  block_partials(v, b.partial);
}

// One chunk of `count` iterations of `batch` instances without the seed:
// count-1 plain iterations, the aligned iteration saving u_prev / q_prev /
// grad3 u_prev, and the per-block norm partials.
int chunk_body(const Vol& b, int count, int dataterm, int batch,
               cudaStream_t s) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  for (int k = 0; k < count; ++k) {
    int last = k == count - 1;
    vol_primal<<<grid, block, 0, s>>>(b, dataterm, last);
    LAUNCH_CHECK();
    vol_dual<<<grid, block, 0, s>>>(b, last);
    LAUNCH_CHECK();
  }
  vol_norm_partial<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  return 0;
}

// One chunk of `batch` instances: the seed, the chunk body, and the
// squared norms of every instance into its scalars (one finish block each).
int chunk(const Vol& b, int count, int dataterm, int batch, cudaStream_t s) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  vol_seed<<<grid, block, 0, s>>>(b);
  LAUNCH_CHECK();
  int rc = chunk_body(b, count, dataterm, batch, s);
  if (rc) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, s>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                    count, 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

Vol vol_of(void* u, void* q, void* up, void* qp, void* g, void* gp,
           const void* f, const void* w, void* sc, void* partial, int L,
           int nx, int ny) {
  Vol b;
  b.u = (float*)u;
  b.q = (float*)q;
  b.up = (float*)up;
  b.qp = (float*)qp;
  b.g = (float*)g;
  b.gp = (float*)gp;
  b.f = (const float*)f;
  b.w = (const float*)w;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.L = L;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  return b;
}

}  // namespace

extern "C" {

// Number of per-block norm partials (4 floats each) for an (nx, ny) plane
// of pixels (each thread covers its pixel's L labels).
int prost_vol_num_blocks(int nx, int ny) {
  dim3 g = grid_of(nx, ny);
  return (int)(g.x * g.y);
}

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// vol_fused_chunk: `count` iterations on (u, q) in place, u_prev / q_prev
// of the aligned iteration into (up, qp), the 4 SQUARED norms into
// sc[S_NORM..].  No-op when sc[S_CONV] is set.
int prost_vol_chunk(void* u, void* q, void* up, void* qp, void* g, void* gp,
                    const void* f, const void* w, void* sc, void* partial,
                    int L, int nx, int ny, int count, int dataterm,
                    void* stream) {
  Vol b = vol_of(u, q, up, qp, g, gp, f, w, sc, partial, L, nx, ny);
  return chunk(b, count, dataterm, 1, (cudaStream_t)stream);
}

// vol_fused_chunk_batched: the same for `batch` instances in one launch
// sequence; sc holds S_LEN scalars per instance, partial 4 per block per
// instance.  An instance whose sc[S_CONV] is set is a no-op.
int prost_vol_chunk_batched(void* u, void* q, void* up, void* qp, void* g,
                            void* gp, const void* f, const void* w, void* sc,
                            void* partial, int L, int nx, int ny, int count,
                            int dataterm, int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  Vol b = vol_of(u, q, up, qp, g, gp, f, w, sc, partial, L, nx, ny);
  return chunk(b, count, dataterm, batch, (cudaStream_t)stream);
}

// vol_fused_chunk_halo: vol_chunk on one halo-extended shard of the nx
// axis of a volume of nx_global rows; sc holds the row context and the
// squared norms cover the owned rows only.
int prost_vol_chunk_halo(void* u, void* q, void* up, void* qp, void* g,
                         void* gp, const void* f, const void* w, void* sc,
                         void* partial, int L, int nx, int ny, int nx_global,
                         int count, int dataterm, void* stream) {
  Vol b = vol_of(u, q, up, qp, g, gp, f, w, sc, partial, L, nx, ny);
  b.nxg = nx_global;
  return chunk(b, count, dataterm, 1, (cudaStream_t)stream);
}

// vol_fused_multichunk: up to k_chunks chunks, the gradient carried across
// chunks, adaptation + stopping test on the device after each chunk, and
// every kernel after convergence returning at once (the lax.cond skip).
// sc[S_NORM..] ends with the last executed chunk's sqrt'd norms.
int prost_vol_multichunk(void* u, void* q, void* up, void* qp, void* g,
                         void* gp, const void* f, const void* w, void* sc,
                         void* partial, int L, int nx, int ny, int count,
                         int k_chunks, int dataterm, int stepsize,
                         float sqrt_nrows, float sqrt_ncols, float arg_delta,
                         float arg_nu, float arb_delta, float arb_tau,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Vol b = vol_of(u, q, up, qp, g, gp, f, w, sc, partial, L, nx, ny);
  dim3 grid = grid_of(nx, ny), block(BX, BY);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  vol_seed<<<grid, block, 0, s>>>(b);
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
