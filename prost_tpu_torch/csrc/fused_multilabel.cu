// Fused fast-multilabel PDHG chunk kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package's multilabel routes:
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk      -> _ml_chunk_kernel
//   prost_tpu/ops/fused_multilabel.py  ml_fused_multichunk -> _ml_multichunk_kernel
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk_batched
//                                      -> _ml_chunk_kernel_batched
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk_halo
//                                      -> _ml_chunk_kernel (halo=True)
//   prost_tpu/ops/fused_multilabel.py  ml_fused_chunk_banded
//                                      -> _ml_banded_kernel, _ml_banded_db_kernel
//   prost_tpu/ops/fused_multilabel.py  ml_fused_multichunk_banded
//                                      -> _ml_banded_mc_kernel
// whose math is _ml_chunk_core, _ml_update, _shift_ops_3d (whole plane,
// maskless adjoint) and _project_dead_dual_3d in the same file, and
// adapt_scalars in fused_rof.py.  The banded variants exist because a TPU
// core's VMEM cannot hold the planes at 512x512x8; here they are the tiled
// chunk (ml_tiled, further down), which the wrapper's shape rule takes
// where no grid-resident band holds the planes.  The plain PyTorch
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
// 2*ri + 3 launches of the streaming sequence.  Where a chunk's planes fit
// in the shared memory of one block per SM (the wrapper's shape rule:
// 256x256x8 and its one-shard halo band, not 512x512x8), the chunk and its
// halo mode run instead as one grid-resident cooperative launch
// (ml_resident, further down), bit-equal to the sequence; the batched
// chunk runs its instances one after another in one such launch
// (ml_resident_batched): B = 8 of 256x256x8 stream 240 MB an iteration,
// beyond the L2, where one instance's 13 MB of state stays on chip; and
// the multichunk runs all its chunks and their adaptation in one such
// launch (ml_multichunk_resident), where the launch sequence takes 177.
// Where the bands do not fit (512x512x8 and its one-shard halo band), the
// chunk, its halo mode and the multichunk run one tiled cooperative launch
// a chunk (ml_tiled), one pass over device memory an iteration.
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

#include "cp_async.cuh"
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
  float* terms;    // the resident chunk's norm terms, 4 (nx, ny) planes
  int L, nx, ny;
  int nxg;           // rows of the global plane of a halo launch; 0: whole
  float inv_l;       // Sigma_s = 1/L
  float sqrt_inv_l;  // sqrt(Sigma_s)
  // floats from one instance to the next of (u, up), (q, qp) and (s, sp)
  // in a batched launch: L n, 2 L n and n where each buffer holds its
  // instances back to back; a route's flat y = [q; s] rows give q and s
  // the stride 2 L n + n
  long long zu, zq, zs;
};

// The buffers of instance z of a batched launch, each moved by its
// per-instance stride with 64-bit offsets: the dual of 4096 instances of
// 256x256x8 holds 2^32 entries.
__device__ __forceinline__ ML instance_at(ML b, size_t z) {
  size_t n = (size_t)b.nx * b.ny, nl = n * b.L;
  b.u += z * b.zu;
  b.q += z * b.zq;
  b.s += z * b.zs;
  b.up += z * b.zu;
  b.qp += z * b.zq;
  b.sp += z * b.zs;
  b.g += 2 * z * nl;
  b.gp += 2 * z * nl;
  b.su += z * n;
  b.sup += z * n;
  b.f += z * nl;
  b.sc += z * S_LEN;
  return b;
}

// This block's instance (blockIdx.z) of a streaming batched launch.
__device__ __forceinline__ ML instance_of(ML b) {
  return instance_at(b, blockIdx.z);
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

// The four terms of the preconditioned residual norms at pixel (i, j) of
// an owned row (_ml_chunk_core after the aligned iteration): those of
// |pd|^2, |z_hat|^2, |dd|^2 and |w_hat|^2 over the 2L + 1 dual planes and
// the L primal planes, K^T y of the current and previous duals
// recomputed.  CARRIED: the gradients and label sums of u and u_prev read
// from the carried planes; else recomputed from u and u_prev by the same
// expressions (ml_seed's, ml_dual's), which gives the same bits.
template <bool CARRIED>
__device__ __forceinline__ void ml_norm_terms(const ML& b, const RowCtx& r,
                                              int i, int j, float v[4]) {
  int ny = b.ny;
  size_t n = (size_t)b.nx * ny, p = (size_t)i * ny + j;
  size_t nl = n * b.L;
  bool above = has_above(r, i);
  bool below = has_below(r, i, b.nx), right = j < ny - 1;
  float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
  float theta = b.sc[S_THETA];
  float tp = 1.f + theta;
  float inv_q = 1.f / (sigma_raw * SQRT_S_Q);
  float inv_s = 1.f / (sigma_raw * b.sqrt_inv_l);
  float inv_t = 1.f / (tau_raw * SQRT_T);
  float s2 = b.s[p], spv = b.sp[p];
  float su2 = 0.f, sup = 0.f;
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float gx2, gy2, gpx, gpy;
    if constexpr (CARRIED) {
      gx2 = b.g[pl];
      gy2 = b.g[nl + pl];
      gpx = b.gp[pl];
      gpy = b.gp[nl + pl];
    } else {
      float uv = b.u[pl], upv = b.up[pl];
      gx2 = below ? b.u[pl + ny] - uv : 0.f;
      gy2 = right ? b.u[pl + 1] - uv : 0.f;
      gpx = below ? b.up[pl + ny] - upv : 0.f;
      gpy = right ? b.up[pl + 1] - upv : 0.f;
      su2 = l == 0 ? uv : su2 + uv;
      sup = l == 0 ? upv : sup + upv;
    }
    float zx = (b.qp[pl] - b.q[pl]) * inv_q
               + SQRT_S_Q * (tp * gx2 - theta * gpx);
    float zy = (b.qp[nl + pl] - b.q[nl + pl]) * inv_q
               + SQRT_S_Q * (tp * gy2 - theta * gpy);
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
  if constexpr (CARRIED) {
    su2 = b.su[p];
    sup = b.sup[p];
  }
  float zs = (spv - s2) * inv_s + b.sqrt_inv_l * (tp * su2 - theta * sup);
  float pds = zs - b.sqrt_inv_l * su2;
  v[0] += pds * pds;
  v[1] += zs * zs;
}

// First pass of the four preconditioned residual norms: per pixel of the
// owned rows the terms (ml_norm_terms, from the carried planes), then
// per-block tree sums into partial[4 * block].
// Bound: memory, 10L + 4 planes read once per chunk.
__global__ void ml_norm_partial(ML b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  if (pixel(b.nx, b.ny, i, j) && owned_row(r, i))
    ml_norm_terms<true>(b, r, i, j, v);
  block_partials(v, b.partial);
}

// ---------------------------------------------------------------------------
// The grid-resident chunk (ml_resident): one cooperative launch runs what
// chunk() runs in 2 count + 3 launches, for the whole plane and for a halo
// band alike (the row context of pdhg_chunk.cuh).  Its batched form
// (ml_resident_batched) runs the same chunk on B instances one after
// another in one launch, and its multichunk form (ml_multichunk_resident)
// runs what prost_ml_multichunk runs in 1 + k_chunks (2 count + 2)
// launches.
//
// What bounds it.  At config 3's shape (256x256x8, ri 10) the streaming
// sequence passes over 14L + 5 planes in device memory an iteration and
// pays a launch and a tail for each of its 2 count + 3 passes; the chunk's
// state (u, q, g, s, su, f: 6L + 2 planes, 13 MB at L = 8) fits in the
// shared memory of the card's SMs.
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// band_of(nx, b, G) and holds them in shared memory (MLRes) from the load
// to the norms: u with 1 row below, q_x with 1 row above (the stencils'
// reach), and the band's rows of q_y, g, f, s and su.  Each half-step
// updates the band in shared memory and writes the planes its neighbours
// read to their device buffers (u after the primal step, q_x after the
// dual step; q_y and s on the aligned iteration), which are the exchange;
// after a grid barrier every block copies in the one neighbour row its
// next half-step reads.  (One barrier an iteration, the primal step
// recomputed on the row below the band and q and s exchanged through
// buffers per parity of the iteration, measured slower on an H100: 0.1000
// against 0.0861 ms a chunk at 256x256x8; the extra row costs more than
// the barrier.)  The aligned primal step writes u_prev and keeps
// w_hat in f's rows (f is not read again in a chunk); the aligned dual
// step writes q_prev and s_prev and the terms of |pd|^2 and |z_hat|^2 (the
// previous gradient held in registers); after the last exchange K^T y of
// the new duals completes |dd|^2 and |w_hat|^2.  The per-pixel expressions
// are ml_seed's, ml_primal's, ml_dual<LT>'s and ml_norm_partial's, the norms
// reduce through the same tiles and finish (coop_tile_partials,
// finish_block): the launch is bit-equal to the streaming sequence.  Up to
// MAX_REG_L labels (a pixel's 2L components and its previous gradient in
// registers); the wrapper's shape rule streams more.  Barriers: one after
// the load, two an iteration, one before the tiles, one before the finish.
// The pieces (ml_res_load_seed, ml_res_iteration, ml_res_norms) also make
// the multichunk: the load and the seed once, then for each chunk the
// scalars read anew (the last finish adapted them), `count` iterations,
// the norms and finish_block's adaptation in block 0, and after a barrier
// the flag, on which the whole grid leaves together; w_hat takes a window
// of its own (f is read in the next chunk), which the tiles and the finish
// borrow as their reduction array; q_y and s go to device memory once,
// after the last chunk.
// ---------------------------------------------------------------------------

struct MLRes {
  LWin u, qx, qy, gx, gy, f;
  LWin s, su;  // one plane each
  LWin wh;     // w_hat of the aligned primal step: f's rows in a chunk (f is
               // not read again), a window of its own in a multichunk
  float* red;  // RES_RED floats for the tiles and the finish: the start of
               // the windows in a chunk (all read by then), w_hat's window
               // in a multichunk (read by then, rewritten in the next chunk)
};

constexpr int RES_RED = RES_RED_BYTES / (int)sizeof(float);

// Floats of MLRes for bands of at most rmax rows (with `multi`, w_hat's
// window, at least the reductions' array), mirrored by
// ops/fused_multilabel.py resident_bytes.
__host__ __device__ __forceinline__ size_t ml_resident_floats(int L,
                                                              int rmax,
                                                              int ny,
                                                              int multi = 0) {
  size_t floats =
      ((size_t)2 * L * (rmax + 1) + (size_t)4 * L * rmax + 2 * rmax) * ny;
  if (multi) {
    size_t wh = (size_t)L * rmax * ny;
    floats += wh > (size_t)RES_RED ? wh : (size_t)RES_RED;
  }
  return floats;
}

__device__ __forceinline__ MLRes ml_layout(float* smem, int L, int lo,
                                           int rmax, int ny, bool multi) {
  MLRes w;
  float* p = smem;
  w.u = take(p, L, lo, rmax + 1, ny);
  w.qx = take(p, L, lo - 1, rmax + 1, ny);
  w.qy = take(p, L, lo, rmax, ny);
  w.gx = take(p, L, lo, rmax, ny);
  w.gy = take(p, L, lo, rmax, ny);
  w.f = take(p, L, lo, rmax, ny);
  w.s = take(p, 1, lo, rmax, ny);
  w.su = take(p, 1, lo, rmax, ny);
  w.wh = multi ? take(p, L, lo, rmax, ny) : w.f;
  w.red = multi ? w.wh.a : smem;
  return w;
}

// The launch's scalars and the constants the pixel loops share, each the
// same expression of them as in the streaming kernels; read through a
// volatile pointer, since a multichunk's finish in block 0 changes them
// between chunks.
struct MLStep {
  float theta, ball, ds, tau, inv_t, sig_q, sig_s, tp, inv_q, inv_s;
};

__device__ __forceinline__ MLStep ml_step(const ML& b) {
  const volatile float* s = b.sc;
  MLStep k;
  const float tau_raw = s[S_TAU], sigma = s[S_SIGMA];
  k.theta = s[S_THETA];
  k.ball = s[S_BALL];
  k.ds = s[S_DS];
  k.tau = tau_raw * TAU_C;  // tau * Tau
  k.inv_t = 1.f / (tau_raw * SQRT_T);
  k.sig_q = sigma * SIG_Q;    // sigma * Sigma_q
  k.sig_s = sigma * b.inv_l;  // sigma * Sigma_s
  k.tp = 1.f + k.theta;
  k.inv_q = 1.f / (sigma * SQRT_S_Q);
  k.inv_s = 1.f / (sigma * b.sqrt_inv_l);
  return k;
}

// The band's rows of u (and the row below), q (q_x with the row above), f
// and s into their windows, then ml_seed: the dead duals zeroed (also on
// the q_x row above the band), g and su of the band; a grid barrier.
template <int L>
__device__ __forceinline__ void ml_res_load_seed(
    const ML& b, const MLRes& w, const RowCtx& r, int lo, int hi,
    cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t nl = (size_t)nx * ny * L;
  load_rows(w.u, b.u, L, lo, hi + 1, nx);
  load_rows(w.qx, b.q, L, lo - 1, hi, nx);
  load_rows(w.qy, b.q + nl, L, lo, hi, nx);
  load_rows(w.f, b.f, L, lo, hi, nx);
  load_rows(w.s, b.s, 1, lo, hi, nx);
  __syncthreads();
  const int top = lo > 0 ? lo - 1 : lo;
  for (int k = threadIdx.x, i = top + k / ny, j = k % ny; k < (hi - top) * ny;
       k += RES_THREADS, next_pixel(i, j, ny)) {
    bool dead = dead_row(r, i);
    if (i < lo) {
      if (dead)
        for (int l = 0; l < L; ++l) w.qx.at(l, i, j) = 0.f;
      continue;
    }
    bool below = has_below(r, i, nx);
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      float uv = w.u.at(l, i, j);
      w.gx.at(l, i, j) = below ? w.u.at(l, i + 1, j) - uv : 0.f;
      w.gy.at(l, i, j) = j < ny - 1 ? w.u.at(l, i, j + 1) - uv : 0.f;
      acc = l == 0 ? uv : acc + uv;
      if (dead) w.qx.at(l, i, j) = 0.f;
      if (j == ny - 1) w.qy.at(l, i, j) = 0.f;
    }
    w.su.at(0, i, j) = acc;
  }
  grid.sync();
}

// One iteration on the band: ml_primal, the row of u below exchanged,
// ml_dual<L>, the row of q_x above exchanged.  The aligned (`last`)
// iteration also writes u_prev, q_prev, s_prev, w_hat and the |pd|^2 and
// |z_hat|^2 terms, and with `put` q_y and s to device memory (a chunk's
// band is then stored; a multichunk stores q_y and s after its last
// chunk).
template <int L>
__device__ __forceinline__ void ml_res_iteration(
    const ML& b, const MLRes& w, const RowCtx& r, const MLStep& k, int lo,
    int hi, bool last, bool put, cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny, nl = n * L;
  const int npx = (hi - lo) * ny;
  // ml_primal
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    size_t p = (size_t)i * ny + j;
    float sv = w.s.at(0, i, j);
    bool above = has_above(r, i);
    for (int l = 0; l < L; ++l) {
      size_t pl = l * n + p;
      float qx = w.qx.at(l, i, j), qy = w.qy.at(l, i, j);
      float lx = above ? w.qx.at(l, i - 1, j) : 0.f;
      float ly = j > 0 ? w.qy.at(l, i, j - 1) : 0.f;
      float kty = ((lx - qx) + (ly - qy)) + sv;
      float uv = w.u.at(l, i, j);
      float tf = k.tau * w.f.at(l, i, j);
      float un = fmaxf((uv - k.tau * kty) - tf, 0.f);
      if (last) {
        b.up[pl] = uv;
        w.wh.at(l, i, j) = (uv - un) * k.inv_t - SQRT_T * kty;  // w_hat
      }
      w.u.at(l, i, j) = un;
      b.u[pl] = un;
    }
  }
  grid.sync();
  load_rows(w.u, b.u, L, hi, hi + 1, nx);
  __syncthreads();
  // ml_dual<L>
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    size_t p = (size_t)i * ny + j;
    float ax[L], ay[L], gpx[L], gpy[L];
    float su2 = 0.f, nrm2 = 0.f;
    bool below = has_below(r, i, nx);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      size_t pl = l * n + p;
      float uv = w.u.at(l, i, j);
      float gx2 = below ? w.u.at(l, i + 1, j) - uv : 0.f;
      float gy2 = j < ny - 1 ? w.u.at(l, i, j + 1) - uv : 0.f;
      su2 = l == 0 ? uv : su2 + uv;
      float qx = w.qx.at(l, i, j), qy = w.qy.at(l, i, j);
      float gx = w.gx.at(l, i, j), gy = w.gy.at(l, i, j);
      float axv = qx + k.sig_q * (k.tp * gx2 - k.theta * gx);
      float ayv = qy + k.sig_q * (k.tp * gy2 - k.theta * gy);
      float t2 = axv * axv + ayv * ayv;
      nrm2 = l == 0 ? t2 : nrm2 + t2;
      if (last) {
        b.qp[pl] = qx;
        b.qp[nl + pl] = qy;
      }
      gpx[l] = gx;
      gpy[l] = gy;
      w.gx.at(l, i, j) = gx2;
      w.gy.at(l, i, j) = gy2;
      ax[l] = axv;
      ay[l] = ayv;
    }
    float scale = nrm2 > 0.f ? fminf(1.f, k.ball * rsqrtf(nrm2)) : 1.f;
    const bool own = last && owned_row(r, i);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      size_t pl = l * n + p;
      float qxn = ax[l] * scale, qyn = ay[l] * scale;
      if (own) {  // ml_norm_partial's terms of the q planes
        float gx2 = w.gx.at(l, i, j), gy2 = w.gy.at(l, i, j);
        float zx = (w.qx.at(l, i, j) - qxn) * k.inv_q
                   + SQRT_S_Q * (k.tp * gx2 - k.theta * gpx[l]);
        float zy = (w.qy.at(l, i, j) - qyn) * k.inv_q
                   + SQRT_S_Q * (k.tp * gy2 - k.theta * gpy[l]);
        float pdx = zx - SQRT_S_Q * gx2;
        float pdy = zy - SQRT_S_Q * gy2;
        v0 += pdx * pdx + pdy * pdy;
        v1 += zx * zx + zy * zy;
      }
      w.qx.at(l, i, j) = qxn;
      w.qy.at(l, i, j) = qyn;
      b.q[pl] = qxn;
      if (last && put) b.q[nl + pl] = qyn;
    }
    float sv = w.s.at(0, i, j), suv = w.su.at(0, i, j);
    float sn = (sv + k.sig_s * (k.tp * su2 - k.theta * suv)) - k.sig_s * k.ds;
    w.s.at(0, i, j) = sn;
    w.su.at(0, i, j) = su2;
    if (last) {
      b.sp[p] = sv;
      if (put) b.s[p] = sn;
    }
    if (own) {  // ml_norm_partial's terms of the multiplier plane
      float zs = (sv - sn) * k.inv_s
                 + b.sqrt_inv_l * (k.tp * su2 - k.theta * suv);
      float pds = zs - b.sqrt_inv_l * su2;
      v0 += pds * pds;
      v1 += zs * zs;
    }
    if (last) {
      b.terms[p] = v0;
      b.terms[n + p] = v1;
    }
  }
  grid.sync();
  load_rows(w.qx, b.q, L, lo - 1, lo, nx);
  __syncthreads();
}

// After the aligned iteration: |dd|^2 and |w_hat|^2 from K^T y of the new
// duals, then the 32x8 tiles' partials of the four terms; every block
// leaves after a grid barrier, so that block 0 may run the finish.
template <int L>
__device__ __forceinline__ void ml_res_norms(
    const ML& b, const MLRes& w, const RowCtx& r, int lo, int hi,
    cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny;
  const int npx = (hi - lo) * ny;
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    size_t p = (size_t)i * ny + j;
    float v2 = 0.f, v3 = 0.f;
    if (owned_row(r, i)) {
      bool above = has_above(r, i);
      float s2 = w.s.at(0, i, j);
      for (int l = 0; l < L; ++l) {
        float qx = w.qx.at(l, i, j), qy = w.qy.at(l, i, j);
        float lx = above ? w.qx.at(l, i - 1, j) : 0.f;
        float ly = j > 0 ? w.qy.at(l, i, j - 1) : 0.f;
        float kty2 = ((lx - qx) + (ly - qy)) + s2;
        float wh = w.wh.at(l, i, j);
        float dd = wh + SQRT_T * kty2;
        v2 += dd * dd;
        v3 += wh * wh;
      }
    }
    b.terms[2 * n + p] = v2;
    b.terms[3 * n + p] = v3;
  }
  grid.sync();
  coop_tile_partials(b.terms, nx, ny, b.partial, w.red);
  grid.sync();
}

// The band's q_y and s into device memory (u and q_x are there after
// every half-step).
template <int L>
__device__ __forceinline__ void ml_res_store(const ML& b, const MLRes& w,
                                             int lo, int hi) {
  const int ny = b.ny;
  const size_t n = (size_t)b.nx * ny, nl = n * L;
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < (hi - lo) * ny;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    size_t p = (size_t)i * ny + j;
    for (int l = 0; l < L; ++l) b.q[nl + l * n + p] = w.qy.at(l, i, j);
    b.s[p] = w.s.at(0, i, j);
  }
}

// One chunk of one instance by the whole grid (the body of ml_resident and
// ml_resident_batched), the instance's flag found clear by every block:
// load, seed, `count` iterations, the norms' terms and tiles, and the
// finish in block 0, which leaves `smem` to the next instance only after a
// grid barrier.
template <int L>
__device__ __forceinline__ void ml_resident_chunk(
    const ML& b, int count, int rmax, float* smem,
    cooperative_groups::grid_group& grid) {
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const MLRes w = ml_layout(smem, L, lo, rmax, b.ny, false);
  ml_res_load_seed<L>(b, w, r, lo, hi, grid);
  const MLStep k = ml_step(b);
  for (int it = 0; it < count; ++it)
    ml_res_iteration<L>(b, w, r, k, lo, hi, it == count - 1, true, grid);
  ml_res_norms<L>(b, w, r, lo, hi, grid);
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    dim3 g = grid_of(b.nx, b.ny);
    finish_block(reinterpret_cast<float(*)[FIN]>(w.red), b.sc, b.partial,
                 (int)(g.x * g.y), count, 0, STEP_NONE, none);
  }
}

template <int LT>
__global__ void __launch_bounds__(RES_THREADS, 1)
    ml_resident(ML b, int count, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  ml_resident_chunk<LT>(b, count, rmax, smem, grid);
}

// The batched chunk (ml_fused_chunk_batched) grid-resident: the instances
// one after another, each as ml_resident runs it alone, so each keeps its
// planes in shared memory for its whole chunk (the streaming batched
// sequence passes over all B instances' planes each half-step, beyond the
// L2 at B = 8 of 256x256x8).  Every block reads instance z's flag before
// any barrier of z (no chunk writes a flag, so all read the same value)
// and skips a flagged instance whole.  Instance z's norm partials lie at
// z times one instance's tiles; the terms planes are reused, written by
// z's last iteration only after every block has passed z - 1's tiles.  A
// grid barrier between instances keeps block 0's finish of the one off
// the shared memory the next one loads into.
template <int LT>
__global__ void __launch_bounds__(RES_THREADS, 1)
    ml_resident_batched(ML b, int count, int rmax, int batch) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float smem[];
  const dim3 g = grid_of(b.nx, b.ny);
  const size_t tiles = (size_t)g.x * g.y;
  bool first = true;
  for (int z = 0; z < batch; ++z) {
    ML bz = instance_at(b, z);
    if (bz.sc[S_CONV] != 0.f) continue;
    bz.partial += (size_t)z * 4 * tiles;
    if (!first) grid.sync();
    first = false;
    ml_resident_chunk<LT>(bz, count, rmax, smem, grid);
  }
}

// The multichunk (ml_fused_multichunk) grid-resident: load and seed once,
// then up to k_chunks chunks, each `count` iterations, the norms' terms and
// tiles and, in block 0, finish_block's adaptation and stopping test;
// after a grid barrier every block reads the new scalars and the flag, and
// the grid leaves together once it is set.  The state and the carried
// gradient and label sum stay in shared memory across chunks (w_hat in a
// window of its own: f is read again in the next chunk, with the new tau);
// u and q_x go to device memory every half-step (the exchange), u_prev,
// q_prev and s_prev on every chunk's aligned iteration, and q_y and s
// once after the last chunk.  Bit-equal to prost_ml_multichunk.
template <int LT>
__global__ void __launch_bounds__(RES_THREADS, 1)
    ml_multichunk_resident(ML b, int count, int k_chunks, int stepsize,
                           AdaptConsts c, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const MLRes w = ml_layout(smem, LT, lo, rmax, b.ny, true);
  const dim3 g = grid_of(b.nx, b.ny);
  ml_res_load_seed<LT>(b, w, r, lo, hi, grid);
  for (int ch = 0; ch < k_chunks; ++ch) {
    const MLStep k = ml_step(b);  // as the last finish left them
    for (int it = 0; it < count; ++it)
      ml_res_iteration<LT>(b, w, r, k, lo, hi, it == count - 1, false, grid);
    ml_res_norms<LT>(b, w, r, lo, hi, grid);
    if (blockIdx.x == 0)
      finish_block(reinterpret_cast<float(*)[FIN]>(w.red), b.sc, b.partial,
                   (int)(g.x * g.y), count, 1, stepsize, c);
    grid.sync();
    if (*(volatile float*)&b.sc[S_CONV] != 0.f) break;
  }
  ml_res_store<LT>(b, w, lo, hi);
}

// The resident chunk's kernels for L labels, or null beyond MAX_REG_L.
using MLResKernel = void (*)(ML, int, int);
using MLResBatchedKernel = void (*)(ML, int, int, int);
using MLResMultiKernel = void (*)(ML, int, int, int, AdaptConsts, int);

MLResKernel ml_resident_kernel(int L) {
  switch (L) {
    case 1: return ml_resident<1>;
    case 2: return ml_resident<2>;
    case 3: return ml_resident<3>;
    case 4: return ml_resident<4>;
    case 5: return ml_resident<5>;
    case 6: return ml_resident<6>;
    case 7: return ml_resident<7>;
    case MAX_REG_L: return ml_resident<MAX_REG_L>;
    default: return nullptr;
  }
}

MLResBatchedKernel ml_resident_batched_kernel(int L) {
  switch (L) {
    case 1: return ml_resident_batched<1>;
    case 2: return ml_resident_batched<2>;
    case 3: return ml_resident_batched<3>;
    case 4: return ml_resident_batched<4>;
    case 5: return ml_resident_batched<5>;
    case 6: return ml_resident_batched<6>;
    case 7: return ml_resident_batched<7>;
    case MAX_REG_L: return ml_resident_batched<MAX_REG_L>;
    default: return nullptr;
  }
}

MLResMultiKernel ml_multichunk_resident_kernel(int L) {
  switch (L) {
    case 1: return ml_multichunk_resident<1>;
    case 2: return ml_multichunk_resident<2>;
    case 3: return ml_multichunk_resident<3>;
    case 4: return ml_multichunk_resident<4>;
    case 5: return ml_multichunk_resident<5>;
    case 6: return ml_multichunk_resident<6>;
    case 7: return ml_multichunk_resident<7>;
    case MAX_REG_L: return ml_multichunk_resident<MAX_REG_L>;
    default: return nullptr;
  }
}

// The dynamic shared memory of a resident launch on nx rows: MLRes for the
// largest band (with `multi` the multichunk's), at least the reductions'
// array; or 0 where `kernel` may not hold it on the current device (then
// `rc` holds the error, if any).
template <typename K>
size_t resident_smem(K kernel, int L, int nx, int ny, int& rmax, int& rc,
                     int multi = 0) {
  int sms = 0;
  rc = device_sms(&sms);
  if (rc) return 0;
  rmax = band_rows(nx, sms);
  size_t smem = ml_resident_floats(L, rmax, ny, multi) * sizeof(float);
  if (smem < (size_t)RES_RED_BYTES) smem = RES_RED_BYTES;
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

// ---------------------------------------------------------------------------
// The tiled chunk and multichunk (ml_fused_chunk_banded -> _ml_banded_kernel,
// _ml_banded_db_kernel; ml_fused_multichunk_banded -> _ml_banded_mc_kernel),
// for the planes whose bands no grid-resident launch holds: 512x512x8 and
// its one-shard halo band.  The TPU kernels run one launch a chunk over row
// bands, each band's window with 2 count + 2 rows of halo DMAed into VMEM
// and the whole chunk run there.
//
// What bounds it.  A chunk's window would need a halo of 2 count + 1
// pixels (21 at ri 10) and about 5L + 2 floats a pixel: at L = 8 even an
// 8x32 tile's window does not fit in a block's shared memory.  One
// iteration needs only one pixel around a tile: the dual step at a pixel
// reads the new and the old u one row below and one column right, the new
// u there K^T q, which reads q_x one row up and q_y one column left.  So
// each iteration is one pass over device memory: u, q, s and f read (4L +
// 1 planes, through the windows' overlap), u, q and s written (3L + 1):
// 60.8 MB at 512x512x8, 18 us at the card's memory rate, where the
// streaming sequence moves 14L + 5 planes in two launches; the state (25
// MB at L = 8) fits in the 50 MB L2.
//
// Design.  One cooperative launch a chunk, one block of MT_THREADS on each
// SM, a grid barrier between iterations: iteration t reads slot (start +
// t) mod 2 (slot A the caller's u, q and s, slot B 3L + 1 planes of
// scratch) and writes the other.  The blocks walk the plane's tiles (tx
// rows, a multiple of 8, by ty columns, of 32); a tile's window is the
// tile and ml_tiled_halo() = 1 pixel on every side, zero outside the plane
// (ops/fused_multilabel.py ml_tiled_halo; tests/test_torch_tiled_ml.py
// holds the plain twin exact with it and not without it).  In shared
// memory 4L + 1 planes of the window:
//   1. cp.async loads of u, q_x, q_y, f and s, the dead duals zeroed
//      (ml_seed's projection: q_x on the global last row, q_y on the last
//      column; the dual step keeps them zero, so every load may do it);
//   2. ml_primal's step on the tile and one row below and one column right
//      of it, the new u into f's plane (f is read only there);
//   3. ml_dual<L>'s step at the owned pixels into the other slot: dx u, dy
//      u and sum_l u of the old u, which the streaming sequence carries in
//      2L + 1 planes, recomputed from the window by the same expressions,
//      which give the same bits; on the chunk's last iteration the old u,
//      q and s also into the caller's previous-iterate planes.
// Every mask is decided by the pixel's place in the plane (the row context
// RowCtx of a halo band included), never by its place in the window.
// After the last iteration and a grid barrier the blocks reduce
// ml_norm_partial's 32x8 tiles of the written slot (ml_norm_terms, the
// gradients and label sums recomputed; MT_THREADS / NT tiles at a time in
// block_partials' tree) for pdhg_finish.  Planes, previous iterates and
// norms are the streaming sequence's bit for bit.  A chunk is the launch,
// the finish and, after an odd count, the copy back of slot B
// (ml_tiled_settle); a multichunk is up to k_chunks launches, chunk c from
// slot (c count) mod 2, each followed by pdhg_finish's adaptation and
// stopping test, and one settle where the count is odd.  A launch whose
// flag is set at entry returns before its first barrier.
// ---------------------------------------------------------------------------

constexpr int MT_THREADS = 512;  // a block: 16 rows of 32 threads
constexpr int MT_RED = (MT_THREADS / NT) * 4 * NT;  // the norm pass's trees

// The dynamic shared memory of a block of the tiled launch on tx x ty
// tiles of L labels (mirrored by ops/fused_multilabel.py ml_tiled_bytes):
// 4L + 1 planes of the window, at least the norm pass's trees.
inline size_t ml_tiled_smem(int L, int tx, int ty) {
  const size_t planes = (size_t)(4 * L + 1) * (tx + 2) * (ty + 2);
  return (planes > (size_t)MT_RED ? planes : (size_t)MT_RED) * sizeof(float);
}

// One iteration on tile `tile` of the tiles of tx x ty: the window from
// slot `src`, the owned pixels into slot `dst`; with `last` the old u, q
// and s also into the previous-iterate planes (a's up, qp, sp).  `a` holds
// f and the shapes.
template <int L>
__device__ __forceinline__ void ml_tiled_iteration(
    const ML& src, const ML& dst, const ML& a, const RowCtx& r,
    const MLStep& k, int tile, int tx, int ty, bool last, float* smem) {
  const int nx = a.nx, ny = a.ny;
  const size_t n = (size_t)nx * ny, nl = n * L;
  const int ntc = (ny + ty - 1) / ty;
  const int R0 = tile / ntc * tx, C0 = tile % ntc * ty;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
  const int r0 = R0 - 1, c0 = C0 - 1;
  const int ww = C1 + 1 - c0, m = (R1 + 1 - r0) * ww;
  const MWin U{smem, r0, c0, ww, m}, QX{smem + L * m, r0, c0, ww, m};
  const MWin QY{smem + 2 * L * m, r0, c0, ww, m};
  const MWin F{smem + 3 * L * m, r0, c0, ww, m};  // f, then the new u
  const MWin S{smem + 4 * L * m, r0, c0, ww, m};

  // 1. the window of the state and f, zero outside the plane, the dead
  //    duals zero
  for (int p = threadIdx.x; p < m; p += MT_THREADS) {
    const int i = r0 + p / ww, j = c0 + p % ww;
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const size_t g = (size_t)i * ny + j;
      const bool dead = dead_row(r, i), last_col = j == ny - 1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const size_t gl = l * n + g;
        cp_async4(U.a + l * m + p, src.u + gl);
        cp_async4(F.a + l * m + p, a.f + gl);
        if (dead)
          QX.a[l * m + p] = 0.f;
        else
          cp_async4(QX.a + l * m + p, src.q + gl);
        if (last_col)
          QY.a[l * m + p] = 0.f;
        else
          cp_async4(QY.a + l * m + p, src.q + nl + gl);
      }
      cp_async4(S.a + p, src.s + g);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        U.a[l * m + p] = 0.f;
        F.a[l * m + p] = 0.f;
        QX.a[l * m + p] = 0.f;
        QY.a[l * m + p] = 0.f;
      }
      S.a[p] = 0.f;
    }
  }
  cp_async_wait();
  __syncthreads();

  // 2. ml_primal on rows [R0, R1] and columns [C0, C1] inside the plane
  const int pw = min(C1, ny - 1) + 1 - C0;
  const int np = (min(R1, nx - 1) + 1 - R0) * pw;
  for (int p = threadIdx.x; p < np; p += MT_THREADS) {
    const int i = R0 + p / pw, j = C0 + p % pw;
    const float sv = S.at(0, i, j);
    const bool above = has_above(r, i);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float qx = QX.at(l, i, j), qy = QY.at(l, i, j);
      const float lx = above ? QX.at(l, i - 1, j) : 0.f;
      const float ly = j > 0 ? QY.at(l, i, j - 1) : 0.f;
      const float kty = ((lx - qx) + (ly - qy)) + sv;
      const float uv = U.at(l, i, j);
      const float tf = k.tau * F.at(l, i, j);
      F.at(l, i, j) = fmaxf((uv - k.tau * kty) - tf, 0.f);
    }
  }
  __syncthreads();

  // 3. ml_dual<L> at the owned pixels, into slot dst
  const int ow = C1 - C0, no = (R1 - R0) * ow;
  for (int p = threadIdx.x; p < no; p += MT_THREADS) {
    const int i = R0 + p / ow, j = C0 + p % ow;
    const size_t g = (size_t)i * ny + j;
    const bool below = has_below(r, i, nx), right = j < ny - 1;
    float ax[L], ay[L];
    float su2 = 0.f, suv = 0.f, nrm2 = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t gl = l * n + g;
      const float uv = F.at(l, i, j), uo = U.at(l, i, j);
      const float gx2 = below ? F.at(l, i + 1, j) - uv : 0.f;
      const float gy2 = right ? F.at(l, i, j + 1) - uv : 0.f;
      const float gx = below ? U.at(l, i + 1, j) - uo : 0.f;  // carried g
      const float gy = right ? U.at(l, i, j + 1) - uo : 0.f;
      su2 = l == 0 ? uv : su2 + uv;
      suv = l == 0 ? uo : suv + uo;  // the carried su
      const float qx = QX.at(l, i, j), qy = QY.at(l, i, j);
      const float axv = qx + k.sig_q * (k.tp * gx2 - k.theta * gx);
      const float ayv = qy + k.sig_q * (k.tp * gy2 - k.theta * gy);
      const float t = axv * axv + ayv * ayv;
      nrm2 = l == 0 ? t : nrm2 + t;
      ax[l] = axv;
      ay[l] = ayv;
      dst.u[gl] = uv;
      if (last) {
        a.up[gl] = uo;
        a.qp[gl] = qx;
        a.qp[nl + gl] = qy;
      }
    }
    const float scale =
        nrm2 > 0.f ? fminf(1.f, k.ball * rsqrtf(nrm2)) : 1.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      dst.q[l * n + g] = ax[l] * scale;
      dst.q[nl + l * n + g] = ay[l] * scale;
    }
    const float sv = S.at(0, i, j);
    dst.s[g] = (sv + k.sig_s * (k.tp * su2 - k.theta * suv)) - k.sig_s * k.ds;
    if (last) a.sp[g] = sv;
  }
}

// `count` iterations from slot `start` (0: a's planes, 1: b's), then
// ml_norm_partial's tiles of the slot written last into a's partials.
template <int L>
__global__ void __launch_bounds__(MT_THREADS, 1)
    ml_tiled(ML a, ML b, int count, int start, int tx, int ty) {
  if (a.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const RowCtx r = row_ctx(a.sc, a.nx, a.nxg);
  const MLStep k = ml_step(a);
  const int nx = a.nx, ny = a.ny;
  const int ntiles = ((nx + tx - 1) / tx) * ((ny + ty - 1) / ty);
  for (int it = 0; it < count; ++it) {
    const bool from_b = ((start + it) & 1) != 0;
    const ML& src = from_b ? b : a;
    const ML& dst = from_b ? a : b;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      ml_tiled_iteration<L>(src, dst, a, r, k, tile, tx, ty,
                            it == count - 1, smem);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }

  // ml_norm_partial's tiles, MT_THREADS / NT at a time (block_partials'
  // tree), of the written slot (b holds a's previous-iterate planes too)
  const ML& fin = ((start + count) & 1) != 0 ? b : a;
  tiled_tile_partials<MT_THREADS>(nx, ny, a.partial, smem,
                                  [&](int i, int j, float v[4]) {
    if (owned_row(r, i)) ml_norm_terms<false>(fin, r, i, j, v);
  });
}

// After a tiled chunk (multi 0) whose flag was not set at entry, or a
// tiled multichunk (multi 1) that ran an odd number of chunks, of an odd
// count: slot B's u, q and s into a's planes.
__global__ void ml_tiled_settle(ML a, ML b, int multi) {
  const bool copy =
      multi ? ((int)a.sc[S_DONE] & 1) != 0 : a.sc[S_CONV] == 0.f;
  if (!copy) return;
  const size_t n = (size_t)a.nx * a.ny, nl = n * a.L;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < 3 * nl + n; t += (size_t)gridDim.x * blockDim.x) {
    if (t < nl)
      a.u[t] = b.u[t];
    else if (t < 3 * nl)
      a.q[t - nl] = b.q[t - nl];
    else
      a.s[t - 3 * nl] = b.s[t - 3 * nl];
  }
}

using MLTiledKernel = void (*)(ML, ML, int, int, int, int);

// The tiled kernel for L labels, or null beyond MAX_REG_L.
MLTiledKernel ml_tiled_kernel(int L) {
  switch (L) {
    case 1: return ml_tiled<1>;
    case 2: return ml_tiled<2>;
    case 3: return ml_tiled<3>;
    case 4: return ml_tiled<4>;
    case 5: return ml_tiled<5>;
    case 6: return ml_tiled<6>;
    case 7: return ml_tiled<7>;
    case MAX_REG_L: return ml_tiled<MAX_REG_L>;
    default: return nullptr;
  }
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device: the smallest of its kernels' limits, or minus the error.
int ml_tiled_limit() {
  int limit = -1;
  for (int L = 1; L <= MAX_REG_L; ++L) {
    int l = resident_smem_limit(ml_tiled_kernel(L));
    if (l < 0) return l;
    limit = limit < 0 || l < limit ? l : limit;
  }
  return limit;
}

// Slot B of the tiled launch: u, q and s in the 3L + 1 scratch planes.
ML slot_b(const ML& a, void* scratch) {
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  ML b = a;
  b.u = (float*)scratch;
  b.q = b.u + nl;
  b.s = b.q + 2 * nl;
  return b;
}

// One tiled launch of `count` iterations from slot `start`: one block of
// MT_THREADS on each SM.  Up to MAX_REG_L labels; a tile that is not a
// multiple of the 32x8 norm tiles or whose window does not fit in a
// block's shared memory is refused with cudaErrorInvalidValue, a grid the
// card cannot hold at once by the card
// (cudaErrorCooperativeLaunchTooLarge).
int tiled_launch(ML& a, ML& b, int count, int start, int tx, int ty,
                 cudaStream_t st) {
  MLTiledKernel kernel = ml_tiled_kernel(a.L);
  if (kernel == nullptr || tx < BY || tx % BY || ty < BX || ty % BX ||
      count < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ml_tiled_smem(a.L, tx, ty);
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
                                                      MT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &count, &start, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(MT_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  return 0;
}

int tiled_settle(const ML& a, const ML& b, int multi, cudaStream_t st) {
  ml_tiled_settle<<<264, 512, 0, st>>>(a, b, multi);
  LAUNCH_CHECK();
  return 0;
}

// One tiled chunk: the launch, the finish, and after an odd count the
// copy back.
int tiled_chunk(ML& a, void* scratch, int count, int tx, int ty,
                cudaStream_t st) {
  ML b = slot_b(a, scratch);
  if (int rc = tiled_launch(a, b, count, 0, tx, ty, st)) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const dim3 g = grid_of(a.nx, a.ny);
  pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return count & 1 ? tiled_settle(a, b, 0, st) : 0;
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
  b.terms = nullptr;
  b.L = L;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  b.inv_l = inv_l;
  b.sqrt_inv_l = sqrt_inv_l;
  b.zs = (long long)nx * ny;
  b.zu = b.zs * L;
  b.zq = 2 * b.zu;
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
// instance; instance z of (u, up), (q, qp) and (s, sp) lies zu, zq and zs
// floats after instance z - 1 (f and the carried planes back to back).
// An instance whose sc[S_CONV] is set is a no-op.
int prost_ml_chunk_batched(void* u, void* q, void* s, void* up, void* qp,
                           void* sp, void* g, void* gp, void* su, void* sup,
                           const void* f, void* sc, void* partial, int L,
                           int nx, int ny, float inv_l, float sqrt_inv_l,
                           long long zu, long long zq, long long zs,
                           int count, int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  ML b = ml_of(u, q, s, up, qp, sp, g, gp, su, sup, f, sc, partial, L, nx,
               ny, inv_l, sqrt_inv_l);
  b.zu = zu;
  b.zq = zq;
  b.zs = zs;
  return chunk(b, count, batch, (cudaStream_t)stream);
}

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

// ml_fused_chunk and ml_fused_chunk_halo as one grid-resident cooperative
// launch (ml_resident): the whole plane with nx_global = 0, else one
// halo-extended shard as prost_ml_chunk_halo takes it; the previous
// iterate into (up, qp, sp), the 4 SQUARED norms into sc[S_NORM..];
// `terms` holds 4 (nx, ny) planes of scratch.  Up to MAX_REG_L labels; a
// band's planes that do not fit in one block's shared memory are refused
// (cudaErrorCooperativeLaunchTooLarge or cudaErrorInvalidValue).  No-op
// when sc[S_CONV] is set.
int prost_ml_chunk_resident(void* u, void* q, void* s, void* up, void* qp,
                            void* sp, const void* f, void* sc, void* partial,
                            void* terms, int L, int nx, int ny, float inv_l,
                            float sqrt_inv_l, int nx_global, int count,
                            void* stream) {
  MLResKernel kernel = ml_resident_kernel(L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  ML b = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  b.terms = (float*)terms;
  b.nxg = nx_global;
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, L, nx, ny, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &rmax};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// ml_fused_chunk_batched as one grid-resident cooperative launch
// (ml_resident_batched): the instances one after another, each bit-equal
// to prost_ml_chunk_resident on it alone; buffers, strides and flags as
// prost_ml_chunk_batched takes them, `terms` 4 (nx, ny) planes of scratch
// shared by the instances.  Refused as prost_ml_chunk_resident is.
int prost_ml_chunk_batched_resident(void* u, void* q, void* s, void* up,
                                    void* qp, void* sp, const void* f,
                                    void* sc, void* partial, void* terms,
                                    int L, int nx, int ny, float inv_l,
                                    float sqrt_inv_l, long long zu,
                                    long long zq, long long zs, int count,
                                    int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  MLResBatchedKernel kernel = ml_resident_batched_kernel(L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  ML b = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  b.terms = (float*)terms;
  b.zu = zu;
  b.zq = zq;
  b.zs = zs;
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, L, nx, ny, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &rmax, &batch};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// The dynamic shared memory ml_resident's blocks (`kind` 1:
// ml_resident_batched's, 2: ml_multichunk_resident's) may hold on the
// current device (for L labels), or minus the error.
int prost_ml_resident_smem(int L, int kind) {
  if (kind == 1) {
    MLResBatchedKernel kernel = ml_resident_batched_kernel(L);
    if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
    return resident_smem_limit(kernel);
  }
  if (kind == 2) {
    MLResMultiKernel kernel = ml_multichunk_resident_kernel(L);
    if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
    return resident_smem_limit(kernel);
  }
  MLResKernel kernel = ml_resident_kernel(L);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return resident_smem_limit(kernel);
}

// ml_fused_multichunk: up to k_chunks chunks, the carried planes kept
// across chunks, adaptation + stopping test on the device after each
// chunk, and every kernel after convergence returning at once (the
// lax.cond skip).  sc[S_NORM..] ends with the last executed chunk's sqrt'd
// norms.
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

// ml_fused_multichunk as one grid-resident cooperative launch
// (ml_multichunk_resident), bit-equal to prost_ml_multichunk in the planes,
// the previous iterates and sc: its arguments without the carried planes,
// `terms` 4 (nx, ny) planes of scratch.  Up to MAX_REG_L labels; a band's
// planes that do not fit in one block's shared memory are refused
// (cudaErrorCooperativeLaunchTooLarge or cudaErrorInvalidValue).  No-op
// when sc[S_CONV] is set.
int prost_ml_multichunk_resident(void* u, void* q, void* s, void* up,
                                 void* qp, void* sp, const void* f, void* sc,
                                 void* partial, void* terms, int L, int nx,
                                 int ny, float inv_l, float sqrt_inv_l,
                                 int count, int k_chunks, int stepsize,
                                 float sqrt_nrows, float sqrt_ncols,
                                 float arg_delta, float arg_nu,
                                 float arb_delta, float arb_tau,
                                 void* stream) {
  MLResMultiKernel kernel = ml_multichunk_resident_kernel(L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  ML b = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  b.terms = (float*)terms;
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, L, nx, ny, rmax, rc, 1);
  if (rc) return rc;
  void* args[] = {&b, &count, &k_chunks, &stepsize, &c, &rmax};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// ml_fused_chunk_banded for the planes no grid-resident band holds: one
// tiled cooperative launch (ml_tiled), the finish and, after an odd count,
// the copy back.  The arguments of prost_ml_chunk_resident without
// nx_global, `scratch` (3L + 1 (nx, ny) planes, slot B) for `terms`, and
// the owned tile (tx rows, a multiple of 8; ty columns, of 32).
// Bit-equal to prost_ml_chunk in the planes, the previous iterates and the
// 4 squared norms.  No-op when sc[S_CONV] is set.  Up to MAX_REG_L labels;
// a tile the launch cannot take is refused (cudaErrorInvalidValue, or the
// card's refusal of the cooperative launch).
int prost_ml_chunk_tiled(void* u, void* q, void* s, void* up, void* qp,
                         void* sp, const void* f, void* sc, void* partial,
                         void* scratch, int L, int nx, int ny, float inv_l,
                         float sqrt_inv_l, int count, int tx, int ty,
                         void* stream) {
  ML a = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  return tiled_chunk(a, scratch, count, tx, ty, (cudaStream_t)stream);
}

// prost_ml_chunk_tiled on one halo-extended shard of a plane of nx_global
// rows, as prost_ml_chunk_halo takes it (the row context in sc, the norms
// over the owned rows).  Bit-equal to prost_ml_chunk_halo.
int prost_ml_chunk_halo_tiled(void* u, void* q, void* s, void* up,
                              void* qp, void* sp, const void* f, void* sc,
                              void* partial, void* scratch, int L, int nx,
                              int ny, float inv_l, float sqrt_inv_l,
                              int nx_global, int count, int tx, int ty,
                              void* stream) {
  ML a = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  a.nxg = nx_global;
  return tiled_chunk(a, scratch, count, tx, ty, (cudaStream_t)stream);
}

// ml_fused_multichunk_banded as up to k_chunks tiled launches, chunk c
// from slot (c count) mod 2, each followed by pdhg_finish's adaptation and
// stopping test, and after an odd count the copy back where an odd number
// of chunks ran; the arguments of prost_ml_multichunk_resident, `scratch`
// 3L + 1 (nx, ny) planes for `terms`, and the tile.  Bit-equal to
// prost_ml_multichunk in the planes, the previous iterates and sc.
// Refuses a tile as prost_ml_chunk_tiled does.  No-op when sc[S_CONV] is
// set.
int prost_ml_multichunk_tiled(void* u, void* q, void* s, void* up, void* qp,
                              void* sp, const void* f, void* sc,
                              void* partial, void* scratch, int L, int nx,
                              int ny, float inv_l, float sqrt_inv_l,
                              int count, int k_chunks, int stepsize,
                              float sqrt_nrows, float sqrt_ncols,
                              float arg_delta, float arg_nu, float arb_delta,
                              float arb_tau, int tx, int ty, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ML a = ml_of(u, q, s, up, qp, sp, nullptr, nullptr, nullptr, nullptr, f,
               sc, partial, L, nx, ny, inv_l, sqrt_inv_l);
  ML b = slot_b(a, scratch);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  const dim3 g = grid_of(nx, ny);
  for (int ch = 0; ch < k_chunks; ++ch) {
    if (int rc = tiled_launch(a, b, count,
                              (int)(((long long)ch * count) & 1), tx, ty,
                              st))
      return rc;
    pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                   1, stepsize, c);
    LAUNCH_CHECK();
  }
  return count & 1 ? tiled_settle(a, b, 1, st) : 0;
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device (the least of its kernels' for 1 to MAX_REG_L labels),
// or minus the error.
int prost_ml_tiled_smem() { return ml_tiled_limit(); }

}  // extern "C"
