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
// adapt_scalars in fused_rof.py; and the JAX package's banded variants
//   prost_tpu/ops/fused_vol.py  vol_fused_chunk_banded
//                               -> _vol_banded_kernel, _vol_banded_db_kernel
//   prost_tpu/ops/fused_vol.py  vol_fused_multichunk_banded
//                               -> _vol_banded_mc_kernel
// (a TPU core's VMEM holds volumes of up to about 1.1 M voxels) with the
// tiled chunk (vol_tiled, further down).  The plain PyTorch versions live
// beside their wrappers in prost_tpu_torch/ops/fused_vol.py.
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
// by launch latency: a chunk of ri iterations is 2*ri + 3 launches.  The
// batched sequence streams all B instances' volumes at once, 268 MB an
// iteration at B = 8 of 256x256x8, beyond the L2.  Where one instance's
// volumes fit in the shared memory of one block per SM (the wrapper's
// shape rule: 256x256x8 and its one-shard halo band, not 512x512x8), the
// chunk and its halo mode run instead as one grid-resident cooperative
// launch (vol_resident, further down), the batched chunk as one such
// launch that takes the instances one after another
// (vol_resident_batched), and the multichunk as one such launch for all
// its chunks with the adaptation between them (vol_multichunk_resident),
// each bit-equal to the sequence.  Where they do not (512x512x8 and its
// one-shard halo band), the chunk, its halo mode and the multichunk run
// one tiled cooperative launch a chunk (vol_tiled), one pass over device
// memory an iteration.
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

#include "cp_async.cuh"
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
  float* terms;    // the resident chunk's norm terms, 4 (nx, ny) planes
  int L, nx, ny;
  int nxg;  // rows of the global plane of a halo launch; 0: the whole plane
  // floats from one instance to the next of (u, up) and (q, qp) in a
  // batched launch: L n and 3 L n where each buffer holds its instances
  // back to back, or the rows of a route's flat x and y
  long long zu, zq;
};

// The buffers of instance z of a batched launch, each moved by its
// per-instance stride with 64-bit offsets.
__device__ __forceinline__ Vol instance_at(Vol b, size_t z) {
  size_t nl = (size_t)b.nx * b.ny * b.L;
  b.u += z * b.zu;
  b.q += z * b.zq;
  b.up += z * b.zu;
  b.qp += z * b.zq;
  b.g += 3 * z * nl;
  b.gp += 3 * z * nl;
  b.f += z * nl;
  b.w += z * nl;
  b.sc += z * S_LEN;
  return b;
}

// The buffers of this block's instance (blockIdx.z) of a streaming launch.
__device__ __forceinline__ Vol instance_of(const Vol& b) {
  return instance_at(b, blockIdx.z);
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

// ---------------------------------------------------------------------------
// The grid-resident chunks: one cooperative launch runs what chunk() runs
// in 2 count + 3 launches, for one volume or one halo band (vol_resident)
// and for B instances one after another (vol_resident_batched), and what
// prost_vol_multichunk runs in 1 + k_chunks (2 count + 2) launches
// (vol_multichunk_resident: 177 at vol256x8's 8 chunks of ri 10).
//
// What bounds it.  At vol256x8's shape (256x256x8, ri 10) the streaming
// sequence is 23 launches of 5-6 us each, mostly latency and tails; the
// batched sequence passes over all B instances' volumes each half-step:
// about 16 volumes of 2 MiB an iteration per instance, 268 MB an
// iteration at B = 8, beyond the 50 MB L2, so it is bound by device
// memory.  One instance's chunk state (u, q, g, f: 8 volumes, 16 MB; 9
// with wsquare's w) fits in the shared memory of the card's SMs, and so
// does that of its one-shard halo band (300 rows: bands of 3 rows, 212992
// bytes a block; with wsquare 237568, beyond the card's 232448, so that
// band streams).
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// band_of(nx, b, G) of every label plane of an instance and holds them in
// shared memory (VolRes) from the load to the norms: u with 1 row below,
// q_x with 1 row above (the stencils' reach), and the band's rows of q_y,
// q_l, g_x, g_y, g_l and f (and w).  The label neighbours (u[l+1] in the
// dual step, q_l[l-1] in the primal step and the norms) ride in a
// register along the l loop, as in vol_primal and vol_dual, so the only
// exchange is u's row below after the primal step and q_x's row above
// after the dual step: each half-step writes the plane its neighbours
// read to its device buffer (u, q_x; q_y and q_l on the aligned
// iteration), and after a grid barrier every block copies in the one row
// its next half-step reads.  The aligned primal step writes u_prev and
// keeps w_hat in f's rows (f is not read again); the aligned dual step
// writes q_prev and the terms of |pd|^2 and |z_hat|^2 (the previous
// gradient in registers); after the last exchange K^T q of the new duals
// completes |dd|^2 and |w_hat|^2.  The per-voxel expressions are
// vol_seed's, vol_primal's, vol_dual's and vol_norm_partial's, in the
// same order, and the norms reduce through the same tiles and finish
// (coop_tile_partials, finish_block): each instance is bit-equal to the
// streaming sequence in the volumes and the norms.  The instances run one
// after another, each as one chunk of the whole grid: every block reads
// instance z's flag before any barrier of z (no chunk writes a flag, so
// all read the same value) and skips a flagged instance whole; instance
// z's norm partials lie at z times one instance's tiles; the terms planes
// are shared, written by z's last iteration only after every block has
// passed z - 1's tiles; a grid barrier between instances keeps block 0's
// finish of one off the shared memory the next one loads into.  Up to
// MAX_RES_L labels (the loops over them unrolled); the wrapper's shape
// rule streams more.  Barriers: one after the load, two an iteration, one
// before the tiles, one before the finish, one between instances.  The
// pieces (vol_res_load_seed, vol_res_iteration, vol_res_norms) also make
// the multichunk: the load and the seed once, then for each chunk the
// scalars read anew (the last finish adapted them), `count` iterations,
// the norms and finish_block's adaptation in block 0, and after a barrier
// the flag, on which the whole grid leaves together; w_hat takes a window
// of its own (f is read in the next chunk), which the tiles and the
// finish borrow as their reduction array.
// ---------------------------------------------------------------------------

constexpr int MAX_RES_L = 8;  // mirrored by ops/fused_vol.py
constexpr int RES_RED = RES_RED_BYTES / (int)sizeof(float);

struct VolRes {
  LWin u, qx, qy, ql, gx, gy, gl;
  LWin f;
  LWin w;   // wsquare's weights (f again for the other data terms)
  LWin wh;  // w_hat of the aligned primal step: f's rows in a chunk (f is
            // not read again), a window of its own in a multichunk
  float* red;  // RES_RED floats for the tiles and the finish: the start of
               // the windows in a chunk (all read by then), w_hat's window
               // in a multichunk (read by then, rewritten in the next chunk)
};

// Floats of VolRes for bands of at most rmax rows (with w where wsq; with
// `multi`, w_hat's window, at least the reductions' array).
__host__ __device__ __forceinline__ size_t vol_resident_floats(
    int L, int rmax, int ny, int wsq, int multi = 0) {
  size_t floats = ((size_t)2 * L * (rmax + 1)
                   + (size_t)(6 + (wsq ? 1 : 0)) * L * rmax) * ny;
  if (multi) {
    size_t wh = (size_t)L * rmax * ny;
    floats += wh > (size_t)RES_RED ? wh : (size_t)RES_RED;
  }
  return floats;
}

__device__ __forceinline__ VolRes vol_layout(float* smem, int L, int lo,
                                             int rmax, int ny, bool wsq,
                                             bool multi) {
  VolRes v;
  float* p = smem;
  v.u = take(p, L, lo, rmax + 1, ny);
  v.qx = take(p, L, lo - 1, rmax + 1, ny);
  v.qy = take(p, L, lo, rmax, ny);
  v.ql = take(p, L, lo, rmax, ny);
  v.gx = take(p, L, lo, rmax, ny);
  v.gy = take(p, L, lo, rmax, ny);
  v.gl = take(p, L, lo, rmax, ny);
  v.f = take(p, L, lo, rmax, ny);
  v.w = wsq ? take(p, L, lo, rmax, ny) : v.f;
  v.wh = multi ? take(p, L, lo, rmax, ny) : v.f;
  v.red = multi ? v.wh.a : smem;
  return v;
}

// The launch's scalars and the constants the voxel loops share, each the
// same expression of them as in the streaming kernels; read through a
// volatile pointer, since a multichunk's finish in block 0 changes them
// between chunks.
struct VolStep {
  float tau_raw, sigma_raw, theta, radius;
  float tau, tl, sig_p, sig_t, tp, inv_s, inv_t;
};

__device__ __forceinline__ VolStep vol_step(const float* sc) {
  const volatile float* s = sc;
  VolStep k;
  k.tau_raw = s[S_TAU];
  k.sigma_raw = s[S_SIGMA];
  k.theta = s[S_THETA];
  k.radius = s[S_RADIUS];
  k.tau = k.tau_raw * TAU_C;  // tau * Tau
  k.tl = k.tau * s[S_LMB];
  const float sigma_p = k.sigma_raw * 0.5f;  // sigma * Sigma
  k.sig_p = sigma_p * (1.f + k.theta);
  k.sig_t = sigma_p * k.theta;
  k.tp = 1.f + k.theta;
  k.inv_s = 1.f / (k.sigma_raw * SQRT_S);
  k.inv_t = 1.f / (k.tau_raw * SQRT_T);
  return k;
}

// The band's rows of u (and the row below), q (q_x with the row above), f
// and w into their windows, then vol_seed: the dead duals zeroed (also on
// the q_x row above the band), grad3 u of the band; a grid barrier.
template <int L>
__device__ __forceinline__ void vol_res_load_seed(
    const Vol& b, const VolRes& v, const RowCtx& r, int lo, int hi,
    bool wsq, cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t nl = (size_t)nx * ny * L;
  load_rows(v.u, b.u, L, lo, hi + 1, nx);
  load_rows(v.qx, b.q, L, lo - 1, hi, nx);
  load_rows(v.qy, b.q + nl, L, lo, hi, nx);
  load_rows(v.ql, b.q + 2 * nl, L, lo, hi, nx);
  load_rows(v.f, b.f, L, lo, hi, nx);
  if (wsq) load_rows(v.w, b.w, L, lo, hi, nx);
  __syncthreads();
  const int top = lo > 0 ? lo - 1 : lo;
  for (int k = threadIdx.x, i = top + k / ny, j = k % ny; k < (hi - top) * ny;
       k += RES_THREADS, next_pixel(i, j, ny)) {
    const bool dead = dead_row(r, i);
    if (i < lo) {
      if (dead) {
#pragma unroll
        for (int l = 0; l < L; ++l) v.qx.at(l, i, j) = 0.f;
      }
      continue;
    }
    const bool below = has_below(r, i, nx);
    float un = v.u.at(0, i, j);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float uv = un;
      un = l < L - 1 ? v.u.at(l + 1, i, j) : 0.f;
      v.gx.at(l, i, j) = below ? v.u.at(l, i + 1, j) - uv : 0.f;
      v.gy.at(l, i, j) = j < ny - 1 ? v.u.at(l, i, j + 1) - uv : 0.f;
      v.gl.at(l, i, j) = un - uv;
      if (dead) v.qx.at(l, i, j) = 0.f;
      if (j == ny - 1) v.qy.at(l, i, j) = 0.f;
    }
  }
  grid.sync();
}

// One iteration on the band: vol_primal, the row of u below exchanged,
// vol_dual, the row of q_x above exchanged.  The aligned (`last`)
// iteration also writes u_prev, q_prev, w_hat and the |pd|^2 and |z_hat|^2
// terms, and q's other parts to device memory.
template <int L>
__device__ __forceinline__ void vol_res_iteration(
    const Vol& b, const VolRes& v, const RowCtx& r, const VolStep& k,
    int dataterm, int lo, int hi, bool last,
    cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny, nl = n * L;
  const int npx = (hi - lo) * ny;
  // vol_primal
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    const bool above = has_above(r, i);
    float ql_below = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t pl = l * n + p;
      float qx = v.qx.at(l, i, j), qy = v.qy.at(l, i, j);
      float ql = v.ql.at(l, i, j);
      float lx = above ? v.qx.at(l, i - 1, j) : 0.f;
      float ly = j > 0 ? v.qy.at(l, i, j - 1) : 0.f;
      float kty = ((lx - qx) + (ly - qy)) + (ql_below - ql);
      ql_below = ql;
      float uv = v.u.at(l, i, j);
      float arg = uv - k.tau * kty;
      float fv = v.f.at(l, i, j);
      float un;
      if (dataterm == DT_SQUARE) {
        float dt0 = k.tl * fv;
        float dt1 = 1.f / (1.f + k.tl);
        un = (arg + dt0) * dt1;
      } else if (dataterm == DT_WSQUARE) {
        float tw = k.tl * v.w.at(l, i, j);
        float dt0 = tw * fv;
        float dt1 = 1.f / (1.f + tw);
        un = (arg + dt0) * dt1;
      } else {  // abs
        float d = arg - fv;
        un = arg - fminf(fmaxf(d, -k.tl), k.tl);
      }
      if (last) {
        b.up[pl] = uv;
        v.wh.at(l, i, j) = (uv - un) * k.inv_t - SQRT_T * kty;  // w_hat
      }
      v.u.at(l, i, j) = un;
      b.u[pl] = un;
    }
  }
  grid.sync();
  load_rows(v.u, b.u, L, hi, hi + 1, nx);
  __syncthreads();
  // vol_dual
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    const bool below = has_below(r, i, nx);
    const bool own = last && owned_row(r, i);
    float v0 = 0.f, v1 = 0.f;
    float un = v.u.at(0, i, j);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t pl = l * n + p;
      float uv = un;
      un = l < L - 1 ? v.u.at(l + 1, i, j) : 0.f;
      float gxn = below ? v.u.at(l, i + 1, j) - uv : 0.f;
      float gyn = j < ny - 1 ? v.u.at(l, i, j + 1) - uv : 0.f;
      float gln = un - uv;
      float qx = v.qx.at(l, i, j), qy = v.qy.at(l, i, j);
      float ql = v.ql.at(l, i, j);
      float gx = v.gx.at(l, i, j), gy = v.gy.at(l, i, j);
      float gl = v.gl.at(l, i, j);
      float ax = (qx + k.sig_p * gxn) - k.sig_t * gx;
      float ay = (qy + k.sig_p * gyn) - k.sig_t * gy;
      float al = (ql + k.sig_p * gln) - k.sig_t * gl;
      float nn = (ax * ax + ay * ay) + al * al;
      float scale = nn > 0.f ? fminf(1.f, k.radius * rsqrtf(nn)) : 1.f;
      float qxn = ax * scale, qyn = ay * scale, qln = al * scale;
      if (last) {
        b.qp[pl] = qx;
        b.qp[nl + pl] = qy;
        b.qp[2 * nl + pl] = ql;
      }
      if (own) {  // vol_norm_partial's |pd|^2 and |z_hat|^2 terms
        const float th = k.theta, tp = k.tp, inv_s = k.inv_s;
        float z0 = (qx - qxn) * inv_s + SQRT_S * (tp * gxn - th * gx);
        float z1 = (qy - qyn) * inv_s + SQRT_S * (tp * gyn - th * gy);
        float z2 = (ql - qln) * inv_s + SQRT_S * (tp * gln - th * gl);
        float pd0 = z0 - SQRT_S * gxn;
        float pd1 = z1 - SQRT_S * gyn;
        float pd2 = z2 - SQRT_S * gln;
        v0 += (pd0 * pd0 + pd1 * pd1) + pd2 * pd2;
        v1 += (z0 * z0 + z1 * z1) + z2 * z2;
      }
      v.qx.at(l, i, j) = qxn;
      v.qy.at(l, i, j) = qyn;
      v.ql.at(l, i, j) = qln;
      v.gx.at(l, i, j) = gxn;
      v.gy.at(l, i, j) = gyn;
      v.gl.at(l, i, j) = gln;
      b.q[pl] = qxn;
      if (last) {
        b.q[nl + pl] = qyn;
        b.q[2 * nl + pl] = qln;
      }
    }
    if (last) {
      b.terms[p] = v0;
      b.terms[n + p] = v1;
    }
  }
  grid.sync();
  load_rows(v.qx, b.q, L, lo - 1, lo, nx);
  __syncthreads();
}

// After the aligned iteration: |dd|^2 and |w_hat|^2 from K^T q of the new
// duals, then the 32x8 tiles' partials of the four terms; every block
// leaves after a grid barrier, so that block 0 may run the finish.
template <int L>
__device__ __forceinline__ void vol_res_norms(
    const Vol& b, const VolRes& v, const RowCtx& r, int lo, int hi,
    cooperative_groups::grid_group& grid) {
  const int nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny;
  const int npx = (hi - lo) * ny;
  for (int t = threadIdx.x, i = lo + t / ny, j = t % ny; t < npx;
       t += RES_THREADS, next_pixel(i, j, ny)) {
    const size_t p = (size_t)i * ny + j;
    float v2 = 0.f, v3 = 0.f;
    if (owned_row(r, i)) {
      const bool above = has_above(r, i);
      float ql_below = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float qx = v.qx.at(l, i, j), qy = v.qy.at(l, i, j);
        float ql = v.ql.at(l, i, j);
        float lx = above ? v.qx.at(l, i - 1, j) : 0.f;
        float ly = j > 0 ? v.qy.at(l, i, j - 1) : 0.f;
        float kty2 = ((lx - qx) + (ly - qy)) + (ql_below - ql);
        ql_below = ql;
        float wh = v.wh.at(l, i, j);
        float dd = wh + SQRT_T * kty2;
        v2 += dd * dd;
        v3 += wh * wh;
      }
    }
    b.terms[2 * n + p] = v2;
    b.terms[3 * n + p] = v3;
  }
  grid.sync();
  coop_tile_partials(b.terms, nx, ny, b.partial, v.red);
  grid.sync();
}

// One chunk of one instance by the whole grid, the instance's flag found
// clear by every block: load, seed, `count` iterations, the norms' terms
// and tiles, and the finish in block 0, which leaves `smem` to the next
// instance only after a grid barrier.
template <int L>
__device__ __forceinline__ void vol_resident_chunk(
    const Vol& b, int count, int dataterm, int rmax, float* smem,
    cooperative_groups::grid_group& grid) {
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  const bool wsq = dataterm == DT_WSQUARE;
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const VolRes v = vol_layout(smem, L, lo, rmax, b.ny, wsq, false);
  vol_res_load_seed<L>(b, v, r, lo, hi, wsq, grid);
  const VolStep k = vol_step(b.sc);
  for (int it = 0; it < count; ++it)
    vol_res_iteration<L>(b, v, r, k, dataterm, lo, hi, it == count - 1,
                         grid);
  vol_res_norms<L>(b, v, r, lo, hi, grid);
  if (blockIdx.x == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    dim3 g = grid_of(b.nx, b.ny);
    finish_block(reinterpret_cast<float(*)[FIN]>(v.red), b.sc, b.partial,
                 (int)(g.x * g.y), count, 0, STEP_NONE, none);
  }
}

// The chunk (vol_fused_chunk, and its halo mode on one band: the row
// context of pdhg_chunk.cuh, which vol_resident_chunk reads for every row
// mask, every dead row and the owned rows of the norms) grid-resident: one
// instance as vol_resident_batched runs each of its instances.
template <int L>
__global__ void __launch_bounds__(RES_THREADS, 1)
    vol_resident(Vol b, int count, int dataterm, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  vol_resident_chunk<L>(b, count, dataterm, rmax, smem, grid);
}

template <int L>
__global__ void __launch_bounds__(RES_THREADS, 1)
    vol_resident_batched(Vol b, int count, int dataterm, int rmax,
                         int batch) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float smem[];
  const dim3 g = grid_of(b.nx, b.ny);
  const size_t tiles = (size_t)g.x * g.y;
  bool first = true;
  for (int z = 0; z < batch; ++z) {
    Vol bz = instance_at(b, z);
    if (bz.sc[S_CONV] != 0.f) continue;
    bz.partial += (size_t)z * 4 * tiles;
    if (!first) grid.sync();
    first = false;
    vol_resident_chunk<L>(bz, count, dataterm, rmax, smem, grid);
  }
}

// The multichunk (vol_fused_multichunk) grid-resident: load and seed once,
// then up to k_chunks chunks, each `count` iterations, the norms' terms and
// tiles and, in block 0, finish_block's adaptation and stopping test;
// after a grid barrier every block reads the new scalars and the flag, and
// the grid leaves together once it is set.  The state and the carried
// gradient stay in shared memory across chunks (w_hat in a window of its
// own: f is read again in the next chunk); u, q_x and, on every aligned
// iteration, q's other parts, u_prev and q_prev go to device memory as the
// chunk writes them.  Bit-equal to prost_vol_multichunk.
template <int L>
__global__ void __launch_bounds__(RES_THREADS, 1)
    vol_multichunk_resident(Vol b, int count, int k_chunks, int dataterm,
                            int stepsize, AdaptConsts c, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  const RowCtx r = row_ctx(b.sc, b.nx, b.nxg);
  const bool wsq = dataterm == DT_WSQUARE;
  int lo, hi;
  band_of(b.nx, blockIdx.x, gridDim.x, lo, hi);
  const VolRes v = vol_layout(smem, L, lo, rmax, b.ny, wsq, true);
  const dim3 g = grid_of(b.nx, b.ny);
  vol_res_load_seed<L>(b, v, r, lo, hi, wsq, grid);
  for (int ch = 0; ch < k_chunks; ++ch) {
    const VolStep k = vol_step(b.sc);  // as the last finish left them
    for (int it = 0; it < count; ++it)
      vol_res_iteration<L>(b, v, r, k, dataterm, lo, hi, it == count - 1,
                           grid);
    vol_res_norms<L>(b, v, r, lo, hi, grid);
    if (blockIdx.x == 0)
      finish_block(reinterpret_cast<float(*)[FIN]>(v.red), b.sc, b.partial,
                   (int)(g.x * g.y), count, 1, stepsize, c);
    grid.sync();
    if (*(volatile float*)&b.sc[S_CONV] != 0.f) break;
  }
}

// The resident chunk's kernels for L labels, or null beyond MAX_RES_L.
using VolResKernel = void (*)(Vol, int, int, int);
using VolResBatchedKernel = void (*)(Vol, int, int, int, int);
using VolResMultiKernel = void (*)(Vol, int, int, int, int, AdaptConsts,
                                   int);

VolResKernel vol_resident_kernel(int L) {
  switch (L) {
    case 1: return vol_resident<1>;
    case 2: return vol_resident<2>;
    case 3: return vol_resident<3>;
    case 4: return vol_resident<4>;
    case 5: return vol_resident<5>;
    case 6: return vol_resident<6>;
    case 7: return vol_resident<7>;
    case MAX_RES_L: return vol_resident<MAX_RES_L>;
    default: return nullptr;
  }
}

VolResBatchedKernel vol_resident_batched_kernel(int L) {
  switch (L) {
    case 1: return vol_resident_batched<1>;
    case 2: return vol_resident_batched<2>;
    case 3: return vol_resident_batched<3>;
    case 4: return vol_resident_batched<4>;
    case 5: return vol_resident_batched<5>;
    case 6: return vol_resident_batched<6>;
    case 7: return vol_resident_batched<7>;
    case MAX_RES_L: return vol_resident_batched<MAX_RES_L>;
    default: return nullptr;
  }
}

VolResMultiKernel vol_multichunk_resident_kernel(int L) {
  switch (L) {
    case 1: return vol_multichunk_resident<1>;
    case 2: return vol_multichunk_resident<2>;
    case 3: return vol_multichunk_resident<3>;
    case 4: return vol_multichunk_resident<4>;
    case 5: return vol_multichunk_resident<5>;
    case 6: return vol_multichunk_resident<6>;
    case 7: return vol_multichunk_resident<7>;
    case MAX_RES_L: return vol_multichunk_resident<MAX_RES_L>;
    default: return nullptr;
  }
}

// The dynamic shared memory of a resident launch on volumes of nx rows:
// VolRes for the largest band (rmax rows; with `multi` the multichunk's),
// at least the reductions' array; or 0 where `kernel` may not hold it on
// the current device (then `rc` holds the error).
template <typename K>
size_t resident_smem(K kernel, int L, int nx, int ny, int dataterm,
                     int& rmax, int& rc, int multi = 0) {
  int sms = 0;
  rc = device_sms(&sms);
  if (rc) return 0;
  rmax = band_rows(nx, sms);
  size_t smem = vol_resident_floats(L, rmax, ny, dataterm == DT_WSQUARE,
                                    multi) * sizeof(float);
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

// One resident chunk of `b` (the whole volume, or a halo band where b.nxg
// is set).
int resident_chunk(Vol b, int count, int dataterm, cudaStream_t st) {
  VolResKernel kernel = vol_resident_kernel(b.L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, b.L, b.nx, b.ny, dataterm, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &dataterm, &rmax};
  return resident_launch(kernel, args, smem, st);
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

// ---------------------------------------------------------------------------
// The tiled chunk and multichunk (vol_fused_chunk_banded ->
// _vol_banded_kernel, _vol_banded_db_kernel; vol_fused_multichunk_banded ->
// _vol_banded_mc_kernel), for the volumes whose bands no grid-resident
// launch holds: 512x512x8 and its one-shard halo band of 556 rows.  The TPU
// kernels run one launch a chunk over row bands, each band's window with
// 2 count + 2 rows of halo DMAed into VMEM and the whole chunk run there.
//
// What bounds it.  A chunk's window would need a halo of 2 count + 1
// pixels (21 at ri 10) and about 9L floats a pixel: at L = 8 even an 8x32
// tile's window does not fit in a block's shared memory.  One iteration
// needs only one pixel around a tile, as the multilabel chunk's
// (csrc/fused_multilabel.cu ml_tiled): the dual step at a pixel reads the
// new and the old u one row below and one column right, the new u there
// K^T q, which reads q_x one row up and q_y one column left; along the
// label axis a pixel's thread walks its L labels, and the ball is voxel by
// voxel.  So each iteration is one pass over device memory: u, q and f
// read (5L planes, through the windows' overlap; wsquare's w at the
// pixel), u and q written (4L): 9L planes, 75.5 MB at 512x512x8, 22.5 us
// at the card's memory rate, where the streaming sequence moves about 20L
// planes in two launches.  The two slots and f (75 MB) exceed the 50 MB
// L2.
//
// Design.  One cooperative launch a chunk, one block of VT_THREADS on each
// SM, a grid barrier between iterations: iteration t reads u and q from
// slot (start + t) mod 2 (slot A the caller's u and q, slot B 4L planes of
// scratch) and writes the other.  The blocks walk the volume's tiles (tx
// rows, a multiple of 8, by ty columns, of 32); a tile's window is the
// tile and vol_tiled_halo() = 1 pixel on every side (ops/fused_vol.py;
// tests/test_torch_tiled_vol.py holds the plain twin exact with it and not
// without it), and on the chunk's last iteration one more row above and
// column left of it; zero outside the volume.  In shared memory 5L planes
// of the window and L of the tile:
//   1. cp.async loads of u, q_x, q_y, q_l and f, the dead duals zeroed
//      (vol_seed's projection: q_x on the global last row, q_y on the last
//      column; the dual step keeps them zero, so every load may do it);
//   2. vol_primal's step on the tile and one row below and one column
//      right of it (on the last iteration also one row above and one
//      column left), the new u into f's planes (f is read only there;
//      wsquare's w is read from device memory by the pixel's thread);
//   3. vol_dual's step at the owned pixels into the other slot: the
//      carried gradient of the old u, which the streaming sequence keeps
//      in 3L planes, recomputed from the window by vol_seed's expressions,
//      which give the same bits.  On the chunk's last iteration the old q
//      also goes into the caller's previous-iterate planes, and the dual
//      step also runs one row above and one column left of the tile, each
//      new q into the window in place of the old (read there only by its
//      own pixel's thread).
// The norms, from the values the last iteration holds: its primal step
// keeps each owned voxel's w_hat (K^T of the old q at hand) in L shared
// planes of the tile after the window; its dual step makes the |pd|^2 and
// |z_hat|^2 terms; after a block barrier, step 4 takes K^T of the new q
// from the window (the neighbours' new q_x one row up and q_y one column
// left made by the widened dual step) for the |dd|^2 and |w_hat|^2 terms,
// and puts the old u into the previous-iterate plane (w_hat's trip
// through that plane in device memory instead is slower:
// tools/vol_tiled_probe.py times it).  The buffers' pointers are read once
// into registers.  The four terms go into 4 planes after slot B; after a
// grid barrier the blocks reduce
// vol_norm_partial's 32x8 tiles (VT_THREADS / NT at a time, in
// block_partials' tree) for pdhg_finish.  Every mask is decided by the
// pixel's place in the volume (the row context RowCtx of a halo band
// included), never by its place in the window.  Planes, previous iterates
// and norms are the streaming sequence's bit for bit.  A chunk is the
// launch, the finish and, after an odd count, the copy back of slot B
// (vol_tiled_settle); a multichunk is up to k_chunks launches, chunk c
// from slot (c count) mod 2, each followed by pdhg_finish's adaptation and
// stopping test, and one settle where the count is odd.  A launch whose
// flag is set at entry returns before its first barrier.
// ---------------------------------------------------------------------------

constexpr int VT_THREADS = RES_THREADS;  // a block: 16 rows of 32 threads

// The dynamic shared memory of a block of the tiled launch on tx x ty
// tiles of L labels (mirrored by ops/fused_vol.py vol_tiled_bytes): 5L
// planes of the window (the tile, 2 pixels before it and 1 after it on each
// axis) and L planes of the tile (w_hat), at least the norm pass's trees.
inline size_t vol_tiled_smem(int L, int tx, int ty) {
  const size_t planes =
      (size_t)5 * L * (tx + 3) * (ty + 3) + (size_t)L * tx * ty;
  return (planes > (size_t)RES_RED ? planes : (size_t)RES_RED) * sizeof(float);
}

// One iteration on tile `tile` of the tiles of tx x ty: the window from
// slot `src`, the owned pixels into slot `dst`; with `last` the old u and
// q also into the previous-iterate planes (a's up, qp) and the norms'
// terms into a's terms.  `a` holds f, w and the shapes; `smem` the window
// and, after the largest window, the tile's w_hat.
template <int L>
__device__ __forceinline__ void vol_tiled_iteration(
    const Vol& src, const Vol& dst, const Vol& a, const RowCtx& r,
    const VolStep& k, int dataterm, int tile, int tx, int ty, bool last,
    float* smem) {
  const int nx = a.nx, ny = a.ny;
  const size_t n = (size_t)nx * ny, nl = n * L;
  const int ntc = (ny + ty - 1) / ty;
  const int R0 = tile / ntc * tx, C0 = tile % ntc * ty;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
  const int r0 = R0 - 2, c0 = C0 - 2;
  const int ww = C1 + 1 - c0, m = (R1 + 1 - r0) * ww;
  const MWin U{smem, r0, c0, ww, m}, QX{smem + L * m, r0, c0, ww, m};
  const MWin QY{smem + 2 * L * m, r0, c0, ww, m};
  const MWin QL{smem + 3 * L * m, r0, c0, ww, m};
  const MWin F{smem + 4 * L * m, r0, c0, ww, m};  // f, then the new u
  const int tn = tx * ty;  // w_hat of owned voxel (l, i, j): WH[l tn + ...]
  float* const WH = smem + (size_t)5 * L * (tx + 3) * (ty + 3);
  const int e = last ? 1 : 0;  // the last iteration's row and column more
  const float* const su = src.u;
  const float* const sq = src.q;
  const float* const fp = a.f;
  const float* const wv = a.w;
  float* const du = dst.u;
  float* const dq = dst.q;
  float* const up = a.up;
  float* const qp = a.qp;
  float* const terms = a.terms;

  // 1. the window's rows [R0 - 1 - e, R1] and columns [C0 - 1 - e, C1] of
  //    the state and f, zero outside the volume, the dead duals zero
  const int lr = R0 - 1 - e, lc = C0 - 1 - e;
  const int lw = C1 + 1 - lc, lm = (R1 + 1 - lr) * lw;
  for (int p = threadIdx.x; p < lm; p += VT_THREADS) {
    const int i = lr + p / lw, j = lc + p % lw;
    const int wp = (i - r0) * ww + (j - c0);
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const size_t g = (size_t)i * ny + j;
      const bool dead = dead_row(r, i), last_col = j == ny - 1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const size_t gl = l * n + g;
        cp_async4(U.a + l * m + wp, su + gl);
        cp_async4(F.a + l * m + wp, fp + gl);
        if (dead)
          QX.a[l * m + wp] = 0.f;
        else
          cp_async4(QX.a + l * m + wp, sq + gl);
        if (last_col)
          QY.a[l * m + wp] = 0.f;
        else
          cp_async4(QY.a + l * m + wp, sq + nl + gl);
        cp_async4(QL.a + l * m + wp, sq + 2 * nl + gl);
      }
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        U.a[l * m + wp] = 0.f;
        F.a[l * m + wp] = 0.f;
        QX.a[l * m + wp] = 0.f;
        QY.a[l * m + wp] = 0.f;
        QL.a[l * m + wp] = 0.f;
      }
    }
  }
  cp_async_wait();
  __syncthreads();

  // 2. vol_primal on rows [R0 - e, R1] and columns [C0 - e, C1] inside the
  //    volume; the last iteration's w_hat at the owned voxels into WH
  const int pr = max(R0 - e, 0), pc = max(C0 - e, 0);
  const int pw = min(C1, ny - 1) + 1 - pc;
  const int np = (min(R1, nx - 1) + 1 - pr) * pw;
  for (int p = threadIdx.x; p < np; p += VT_THREADS) {
    const int i = pr + p / pw, j = pc + p % pw;
    const size_t g = (size_t)i * ny + j;
    const bool above = has_above(r, i);
    const bool own = last && i >= R0 && i < R1 && j >= C0 && j < C1;
    float ql_below = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float qx = QX.at(l, i, j), qy = QY.at(l, i, j);
      const float ql = QL.at(l, i, j);
      const float lx = above ? QX.at(l, i - 1, j) : 0.f;
      const float ly = j > 0 ? QY.at(l, i, j - 1) : 0.f;
      const float kty = ((lx - qx) + (ly - qy)) + (ql_below - ql);
      ql_below = ql;
      const float uv = U.at(l, i, j);
      const float arg = uv - k.tau * kty;
      const float fv = F.at(l, i, j);
      float un;
      if (dataterm == DT_SQUARE) {
        const float dt0 = k.tl * fv;
        const float dt1 = 1.f / (1.f + k.tl);
        un = (arg + dt0) * dt1;
      } else if (dataterm == DT_WSQUARE) {
        const float tw = k.tl * wv[l * n + g];
        const float dt0 = tw * fv;
        const float dt1 = 1.f / (1.f + tw);
        un = (arg + dt0) * dt1;
      } else {  // abs
        const float d = arg - fv;
        un = arg - fminf(fmaxf(d, -k.tl), k.tl);
      }
      if (own)
        WH[l * tn + (i - R0) * ty + (j - C0)] =
            (uv - un) * k.inv_t - SQRT_T * kty;
      F.at(l, i, j) = un;
    }
  }
  __syncthreads();

  // 3. vol_dual on rows [R0 - e, R1) and columns [C0 - e, C1) inside the
  //    volume, the owned pixels into slot dst
  const int dr = max(R0 - e, 0), dc = max(C0 - e, 0);
  const int dw = C1 - dc, nd = (R1 - dr) * dw;
  for (int p = threadIdx.x; p < nd; p += VT_THREADS) {
    const int i = dr + p / dw, j = dc + p % dw;
    const size_t g = (size_t)i * ny + j;
    const bool own = i >= R0 && j >= C0;
    const bool below = has_below(r, i, nx), right = j < ny - 1;
    float v0 = 0.f, v1 = 0.f;
    float un = F.at(0, i, j), uo = U.at(0, i, j);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t gv = l * n + g;
      const float uv = un, ov = uo;
      un = l < L - 1 ? F.at(l + 1, i, j) : 0.f;
      uo = l < L - 1 ? U.at(l + 1, i, j) : 0.f;
      const float gxn = below ? F.at(l, i + 1, j) - uv : 0.f;
      const float gyn = right ? F.at(l, i, j + 1) - uv : 0.f;
      const float gln = un - uv;
      const float gx = below ? U.at(l, i + 1, j) - ov : 0.f;  // carried g
      const float gy = right ? U.at(l, i, j + 1) - ov : 0.f;
      const float gl = uo - ov;
      const float qx = QX.at(l, i, j), qy = QY.at(l, i, j);
      const float ql = QL.at(l, i, j);
      const float ax = (qx + k.sig_p * gxn) - k.sig_t * gx;
      const float ay = (qy + k.sig_p * gyn) - k.sig_t * gy;
      const float al = (ql + k.sig_p * gln) - k.sig_t * gl;
      const float nn = (ax * ax + ay * ay) + al * al;
      const float scale = nn > 0.f ? fminf(1.f, k.radius * rsqrtf(nn)) : 1.f;
      const float qxn = ax * scale, qyn = ay * scale, qln = al * scale;
      if (own) {
        du[gv] = uv;
        dq[gv] = qxn;
        dq[nl + gv] = qyn;
        dq[2 * nl + gv] = qln;
      }
      if (last) {
        if (own) {  // vol_norm_partial's |pd|^2 and |z_hat|^2 terms
          qp[gv] = qx;
          qp[nl + gv] = qy;
          qp[2 * nl + gv] = ql;
          const float th = k.theta, tp = k.tp, inv_s = k.inv_s;
          const float z0 = (qx - qxn) * inv_s + SQRT_S * (tp * gxn - th * gx);
          const float z1 = (qy - qyn) * inv_s + SQRT_S * (tp * gyn - th * gy);
          const float z2 = (ql - qln) * inv_s + SQRT_S * (tp * gln - th * gl);
          const float pd0 = z0 - SQRT_S * gxn;
          const float pd1 = z1 - SQRT_S * gyn;
          const float pd2 = z2 - SQRT_S * gln;
          v0 += (pd0 * pd0 + pd1 * pd1) + pd2 * pd2;
          v1 += (z0 * z0 + z1 * z1) + z2 * z2;
        }
        QX.at(l, i, j) = qxn;  // read again in step 4 only
        QY.at(l, i, j) = qyn;
        QL.at(l, i, j) = qln;
      }
    }
    if (last && own) {
      terms[g] = v0;
      terms[n + g] = v1;
    }
  }
  if (!last) return;
  __syncthreads();

  // 4. at the owned pixels: K^T of the new q, |dd|^2 and |w_hat|^2; the old
  //    u into up
  const int ow = C1 - C0, no = (R1 - R0) * ow;
  for (int p = threadIdx.x; p < no; p += VT_THREADS) {
    const int i = R0 + p / ow, j = C0 + p % ow;
    const size_t g = (size_t)i * ny + j;
    const bool above = has_above(r, i);
    float v2 = 0.f, v3 = 0.f, ql_below = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t gl = l * n + g;
      const float qx = QX.at(l, i, j), qy = QY.at(l, i, j);
      const float ql = QL.at(l, i, j);
      const float lx = above ? QX.at(l, i - 1, j) : 0.f;
      const float ly = j > 0 ? QY.at(l, i, j - 1) : 0.f;
      const float kty2 = ((lx - qx) + (ly - qy)) + (ql_below - ql);
      ql_below = ql;
      const float wh = WH[l * tn + (i - R0) * ty + (j - C0)];
      const float dd = wh + SQRT_T * kty2;
      v2 += dd * dd;
      v3 += wh * wh;
      up[gl] = U.at(l, i, j);
    }
    terms[2 * n + g] = v2;
    terms[3 * n + g] = v3;
  }
}

// `count` iterations from slot `start` (0: a's planes, 1: b's), then
// vol_norm_partial's tiles of the last iteration's terms into a's
// partials.
template <int L>
__global__ void __launch_bounds__(VT_THREADS, 1)
    vol_tiled(Vol a, Vol b, int count, int start, int dataterm, int tx,
              int ty) {
  if (a.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const RowCtx r = row_ctx(a.sc, a.nx, a.nxg);
  const VolStep k = vol_step(a.sc);
  const int nx = a.nx, ny = a.ny;
  const int ntiles = ((nx + tx - 1) / tx) * ((ny + ty - 1) / ty);
  for (int it = 0; it < count; ++it) {
    const bool from_b = ((start + it) & 1) != 0;
    const Vol& src = from_b ? b : a;
    const Vol& dst = from_b ? a : b;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      vol_tiled_iteration<L>(src, dst, a, r, k, dataterm, tile, tx, ty,
                             it == count - 1, smem);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }

  // vol_norm_partial's tiles, VT_THREADS / NT at a time (block_partials'
  // tree), of the terms over the owned rows
  const size_t n = (size_t)nx * ny;
  tiled_tile_partials<VT_THREADS>(nx, ny, a.partial, smem,
                                  [&](int i, int j, float v[4]) {
    if (!owned_row(r, i)) return;
    const size_t g = (size_t)i * ny + j;
    for (int c = 0; c < 4; ++c) v[c] = a.terms[c * n + g];
  });
}

// After a tiled chunk (multi 0) whose flag was not set at entry, or a
// tiled multichunk (multi 1) that ran an odd number of chunks, of an odd
// count: slot B's u and q into a's planes.
__global__ void vol_tiled_settle(Vol a, Vol b, int multi) {
  const bool copy =
      multi ? ((int)a.sc[S_DONE] & 1) != 0 : a.sc[S_CONV] == 0.f;
  if (!copy) return;
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < 4 * nl;
       t += (size_t)gridDim.x * blockDim.x) {
    if (t < nl)
      a.u[t] = b.u[t];
    else
      a.q[t - nl] = b.q[t - nl];
  }
}

using VolTiledKernel = void (*)(Vol, Vol, int, int, int, int, int);

// The tiled kernel for L labels, or null beyond MAX_RES_L.
VolTiledKernel vol_tiled_kernel(int L) {
  switch (L) {
    case 1: return vol_tiled<1>;
    case 2: return vol_tiled<2>;
    case 3: return vol_tiled<3>;
    case 4: return vol_tiled<4>;
    case 5: return vol_tiled<5>;
    case 6: return vol_tiled<6>;
    case 7: return vol_tiled<7>;
    case MAX_RES_L: return vol_tiled<MAX_RES_L>;
    default: return nullptr;
  }
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device: the smallest of its kernels' limits, or minus the error.
int vol_tiled_limit() {
  int limit = -1;
  for (int L = 1; L <= MAX_RES_L; ++L) {
    int l = resident_smem_limit(vol_tiled_kernel(L));
    if (l < 0) return l;
    limit = limit < 0 || l < limit ? l : limit;
  }
  return limit;
}

// Slot B of the tiled launch: u and q in the first 4L of the scratch's
// 4L + 4 planes; the norm terms in the last 4 (a's terms).
Vol slot_b(Vol& a, void* scratch) {
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  Vol b = a;
  b.u = (float*)scratch;
  b.q = b.u + nl;
  a.terms = b.q + 3 * nl;
  b.terms = a.terms;
  return b;
}

// One tiled launch of `count` iterations from slot `start`: one block of
// VT_THREADS on each SM.  Up to MAX_RES_L labels; a tile that is not a
// multiple of the 32x8 norm tiles or whose window does not fit in a
// block's shared memory is refused with cudaErrorInvalidValue, a grid the
// card cannot hold at once by the card
// (cudaErrorCooperativeLaunchTooLarge).
int tiled_launch(Vol& a, Vol& b, int count, int start, int dataterm, int tx,
                 int ty, cudaStream_t st) {
  VolTiledKernel kernel = vol_tiled_kernel(a.L);
  if (kernel == nullptr || tx < BY || tx % BY || ty < BX || ty % BX ||
      count < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = vol_tiled_smem(a.L, tx, ty);
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
                                                      VT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a, &b, &count, &start, &dataterm, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(VT_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  return 0;
}

int tiled_settle(const Vol& a, const Vol& b, int multi, cudaStream_t st) {
  vol_tiled_settle<<<264, 512, 0, st>>>(a, b, multi);
  LAUNCH_CHECK();
  return 0;
}

// One tiled chunk: the launch, the finish, and after an odd count the
// copy back.
int tiled_chunk(Vol& a, void* scratch, int count, int dataterm, int tx,
                int ty, cudaStream_t st) {
  Vol b = slot_b(a, scratch);
  if (int rc = tiled_launch(a, b, count, 0, dataterm, tx, ty, st)) return rc;
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const dim3 g = grid_of(a.nx, a.ny);
  pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return count & 1 ? tiled_settle(a, b, 0, st) : 0;
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
  b.terms = nullptr;
  b.L = L;
  b.nx = nx;
  b.ny = ny;
  b.nxg = 0;
  b.zu = (long long)nx * ny * L;
  b.zq = 3 * b.zu;
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
// instance; instance z of (u, up) and (q, qp) lies zu and zq floats after
// instance z - 1 (f, w and the carried volumes back to back).  An instance
// whose sc[S_CONV] is set is a no-op.
int prost_vol_chunk_batched(void* u, void* q, void* up, void* qp, void* g,
                            void* gp, const void* f, const void* w, void* sc,
                            void* partial, int L, int nx, int ny,
                            long long zu, long long zq, int count,
                            int dataterm, int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  Vol b = vol_of(u, q, up, qp, g, gp, f, w, sc, partial, L, nx, ny);
  b.zu = zu;
  b.zq = zq;
  return chunk(b, count, dataterm, batch, (cudaStream_t)stream);
}

// vol_fused_chunk_batched as one grid-resident cooperative launch
// (vol_resident_batched): the instances one after another, each bit-equal
// to prost_vol_chunk on it alone; buffers, strides and flags as
// prost_vol_chunk_batched takes them, `terms` 4 (nx, ny) planes of
// scratch shared by the instances.  Up to MAX_RES_L labels; a band's
// volumes that do not fit in one block's shared memory are refused
// (cudaErrorCooperativeLaunchTooLarge or cudaErrorInvalidValue).
int prost_vol_chunk_batched_resident(void* u, void* q, void* up, void* qp,
                                     const void* f, const void* w, void* sc,
                                     void* partial, void* terms, int L,
                                     int nx, int ny, long long zu,
                                     long long zq, int count, int dataterm,
                                     int batch, void* stream) {
  if (int rc = batch_error(batch)) return rc;
  VolResBatchedKernel kernel = vol_resident_batched_kernel(L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  Vol b = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  b.terms = (float*)terms;
  b.zu = zu;
  b.zq = zq;
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, L, nx, ny, dataterm, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &dataterm, &rmax, &batch};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// vol_fused_chunk and vol_fused_chunk_halo as one grid-resident cooperative
// launch (vol_resident), bit-equal to prost_vol_chunk and
// prost_vol_chunk_halo: the same volumes and scalars without the carried
// gradient's, `terms` 4 (nx, ny) planes of scratch.  Up to MAX_RES_L
// labels; a band's volumes that do not fit in one block's shared memory
// are refused (cudaErrorCooperativeLaunchTooLarge or
// cudaErrorInvalidValue).  No-op when sc[S_CONV] is set.
int prost_vol_chunk_resident(void* u, void* q, void* up, void* qp,
                             const void* f, const void* w, void* sc,
                             void* partial, void* terms, int L, int nx,
                             int ny, int count, int dataterm, void* stream) {
  Vol b = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  b.terms = (float*)terms;
  return resident_chunk(b, count, dataterm, (cudaStream_t)stream);
}

int prost_vol_chunk_halo_resident(void* u, void* q, void* up, void* qp,
                                  const void* f, const void* w, void* sc,
                                  void* partial, void* terms, int L, int nx,
                                  int ny, int nx_global, int count,
                                  int dataterm, void* stream) {
  Vol b = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  b.terms = (float*)terms;
  b.nxg = nx_global;
  return resident_chunk(b, count, dataterm, (cudaStream_t)stream);
}

// The dynamic shared memory vol_resident's blocks (`kind` 1:
// vol_resident_batched's, 2: vol_multichunk_resident's) may hold on the
// current device (for L labels), or minus the error.
int prost_vol_resident_smem(int L, int kind) {
  if (kind == 1) {
    VolResBatchedKernel kernel = vol_resident_batched_kernel(L);
    if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
    return resident_smem_limit(kernel);
  }
  if (kind == 2) {
    VolResMultiKernel kernel = vol_multichunk_resident_kernel(L);
    if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
    return resident_smem_limit(kernel);
  }
  VolResKernel kernel = vol_resident_kernel(L);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return resident_smem_limit(kernel);
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

// vol_fused_multichunk as one grid-resident cooperative launch
// (vol_multichunk_resident), bit-equal to prost_vol_multichunk in the
// volumes, the previous iterates and sc: its arguments without the carried
// gradient's volumes, `terms` 4 (nx, ny) planes of scratch.  Up to
// MAX_RES_L labels; a band's volumes that do not fit in one block's shared
// memory are refused (cudaErrorCooperativeLaunchTooLarge or
// cudaErrorInvalidValue).  No-op when sc[S_CONV] is set.
int prost_vol_multichunk_resident(void* u, void* q, void* up, void* qp,
                                  const void* f, const void* w, void* sc,
                                  void* partial, void* terms, int L, int nx,
                                  int ny, int count, int k_chunks,
                                  int dataterm, int stepsize,
                                  float sqrt_nrows, float sqrt_ncols,
                                  float arg_delta, float arg_nu,
                                  float arb_delta, float arb_tau,
                                  void* stream) {
  VolResMultiKernel kernel = vol_multichunk_resident_kernel(L);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  Vol b = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  b.terms = (float*)terms;
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  int rmax = 0, rc = 0;
  size_t smem = resident_smem(kernel, L, nx, ny, dataterm, rmax, rc, 1);
  if (rc) return rc;
  void* args[] = {&b, &count, &k_chunks, &dataterm, &stepsize, &c, &rmax};
  return resident_launch(kernel, args, smem, (cudaStream_t)stream);
}

// vol_fused_chunk_banded for the volumes no grid-resident band holds: one
// tiled cooperative launch (vol_tiled), the finish and, after an odd
// count, the copy back.  The arguments of prost_vol_chunk_resident,
// `scratch` (4L + 4 (nx, ny) planes: slot B and the norm terms) for
// `terms`, and the owned tile (tx rows, a multiple of 8; ty columns, of
// 32).  Bit-equal to prost_vol_chunk in the volumes, the previous iterates
// and the 4 squared norms.  No-op when sc[S_CONV] is set.  Up to MAX_RES_L
// labels; a tile the launch cannot take is refused (cudaErrorInvalidValue,
// or the card's refusal of the cooperative launch).
int prost_vol_chunk_tiled(void* u, void* q, void* up, void* qp,
                          const void* f, const void* w, void* sc,
                          void* partial, void* scratch, int L, int nx,
                          int ny, int count, int dataterm, int tx, int ty,
                          void* stream) {
  Vol a = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  return tiled_chunk(a, scratch, count, dataterm, tx, ty,
                     (cudaStream_t)stream);
}

// prost_vol_chunk_tiled on one halo-extended shard of the nx axis of a
// volume of nx_global rows, as prost_vol_chunk_halo takes it (the row
// context in sc, the norms over the owned rows).  Bit-equal to
// prost_vol_chunk_halo.
int prost_vol_chunk_halo_tiled(void* u, void* q, void* up, void* qp,
                               const void* f, const void* w, void* sc,
                               void* partial, void* scratch, int L, int nx,
                               int ny, int nx_global, int count,
                               int dataterm, int tx, int ty, void* stream) {
  Vol a = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  a.nxg = nx_global;
  return tiled_chunk(a, scratch, count, dataterm, tx, ty,
                     (cudaStream_t)stream);
}

// vol_fused_multichunk_banded as up to k_chunks tiled launches, chunk c
// from slot (c count) mod 2, each followed by pdhg_finish's adaptation and
// stopping test, and after an odd count the copy back where an odd number
// of chunks ran; the arguments of prost_vol_multichunk_resident, `scratch`
// 4L + 4 (nx, ny) planes for `terms`, and the tile.  Bit-equal to
// prost_vol_multichunk in the volumes, the previous iterates and sc.
// Refuses a tile as prost_vol_chunk_tiled does.  No-op when sc[S_CONV] is
// set.
int prost_vol_multichunk_tiled(void* u, void* q, void* up, void* qp,
                               const void* f, const void* w, void* sc,
                               void* partial, void* scratch, int L, int nx,
                               int ny, int count, int k_chunks, int dataterm,
                               int stepsize, float sqrt_nrows,
                               float sqrt_ncols, float arg_delta,
                               float arg_nu, float arb_delta, float arb_tau,
                               int tx, int ty, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Vol a = vol_of(u, q, up, qp, nullptr, nullptr, f, w, sc, partial, L, nx,
                 ny);
  Vol b = slot_b(a, scratch);
  AdaptConsts c = {sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta,
                   arb_tau};
  const dim3 g = grid_of(nx, ny);
  for (int ch = 0; ch < k_chunks; ++ch) {
    if (int rc = tiled_launch(a, b, count,
                              (int)(((long long)ch * count) & 1), dataterm,
                              tx, ty, st))
      return rc;
    pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                   1, stepsize, c);
    LAUNCH_CHECK();
  }
  return count & 1 ? tiled_settle(a, b, 1, st) : 0;
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device (the least of its kernels' for 1 to MAX_RES_L labels),
// or minus the error.
int prost_vol_tiled_smem() { return vol_tiled_limit(); }

}  // extern "C"
