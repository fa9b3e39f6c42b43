// Fused tight-multilabel PDHG chunk kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels on the tight-relaxation paths of the JAX
// package:
//   prost_tpu/ops/fused_tight.py  tight_fused_chunk -> _tight_chunk_kernel
//   (whole-plane mode)
//   prost_tpu/ops/fused_tight.py  tight_fused_chunk_batched
//                                 -> _tight_chunk_kernel_batched
//   prost_tpu/ops/fused_tight.py  tight_fused_chunk_halo
//                                 -> _tight_chunk_kernel (halo=True)
// whose math is _chunk_core and _kron_ops in the same
// file and the masked _shift_ops_3d of fused_multilabel.py.  It also serves
// the JAX package's banded variant (tight_fused_chunk_banded), which exists
// only because a TPU core's VMEM cannot hold the planes of large images:
// here the planes stay in device memory at every size.  The plain PyTorch
// versions live beside their wrappers in prost_tpu_torch/ops/fused_tight.py.
//
// Workload: the tight multilabel relaxation, primal [u (L label planes);
// v (2k pair planes)], dual [q (2L gradient planes, free); p (2k planes,
// per-pixel dim-2 ball pairing plane m with m + k); s (one plane)], and
// K = [grad, kron(P^T, I); 0, I; kron(1^T, I), 0] with T <= 512 nonzeros
// ("taps") of the (2L, 2k) matrix P^T.
//
// Layout (the JAX package's): u, f (L, nx, ny); v, p (2k, nx, ny); q and
// the carried kxq = grad u + kron(P^T, I) v (2L, nx, ny); s and the
// carried su = sum_l u (nx, ny); row-major f32 planes.  The taps come in
// one small device array (ops/fused_tight.py kron_array): by output row
// [row_ptr; col; w] and by output column [col_ptr; row; w], each run in the
// order of the plain version's left-to-right folds.  A batched launch takes
// B instances that share (L, k, the taps, the preconditioner constants),
// each plane with a leading instance axis, with a scalar block of S_LEN per
// instance, on the z axis of the grid (pdhg_chunk.cuh); each instance of
// u, v, q, p and s (and of their previous iterates) is contiguous in
// itself, the instances at one stride per buffer (back to back, or the
// rows of a route's flat x and y); f and the carried planes are back to
// back; the taps are one array for all instances.  A halo launch takes one
// shard of a row-partitioned plane with `halo` rows of each neighbour above
// and below it (zeros beyond the plane's edges), nx = rows + 2 halo, and
// the row context of pdhg_chunk.cuh in its scalars; the whole-plane
// launches are its case (0, nx, 0, nx), so they run the same arithmetic.
// The kron coupling, the pair ball and the label sum are pointwise, so
// only the gradient and its adjoint see the row context, and the halo is
// 2 ri + 2 rows as for the multilabel chunk; v and p are exchanged all the
// same, since the halo rows' u and q updates read them.
//
// What bounds it on this card.  An iteration streams about 15L + 13k + 5
// planes (primal: u, 2L q, s, f in, u out; dual: u, v, q, p, kxq, s, su in,
// v, q, p, kxq, s, su out), 131 at L = 4 (k = 6): 8.6 MB at 128x128, 137 MB
// at 512x512, against about 24L + 24k + 4T operations a pixel, so it is
// bound by memory traffic, and at 128x128 by launch latency: a chunk of ri
// iterations is 2*ri + 3 launches.
// A batched chunk of 8 instances of 128x128x4 streams 69 MB an iteration in
// 8 times the blocks, beyond the 50 MB L2: bound by device memory traffic.
// Where a chunk's planes fit in the shared memory of one block per SM (the
// wrapper's shape rule: 128x128x4 and its one-shard halo band, 250x190x3,
// not 512x512x4), the chunk and its halo mode run instead as one
// grid-resident cooperative launch (tight_resident, further down), and the
// batched chunk as one such launch with its instances side by side, each
// on its own group of blocks (tight_resident_batched), where one band of
// an instance's share of the SMs fits; each is bit-equal to the sequence.
//
// Design.  One thread per pixel, 32x8 blocks (pdhg_chunk.cuh); each thread
// loops over its pixel's labels, pairs and taps, since the kron coupling,
// the pair ball and the label sum are all per pixel.  Every kernel updates
// its planes in place and reads neighbours only from a plane it does not
// write: the primal step writes u and reads q's neighbours; the dual step
// reads u's neighbours and updates v, p, q, s and the carried kxq and su at
// its own pixel (v there, not in the primal step, because the dual step
// needs v before and after its update).  The dual step writes the new v
// and the unscaled p first and reads them back from its own pixel for the
// kron product and the ball scaling, so it serves any (L, k) the matcher
// takes.  No dual coordinate is canonicalized: the gradient adjoint is the
// masked one, as in the JAX kernel.  The scalars live in the device buffer
// `sc` (pdhg_chunk.cuh), and every kernel returns at once once sc[S_CONV]
// is set.
//
// Rounding.  Built with -fmad=false; the five preconditioner constants and
// their square roots are rounded once from double by the wrapper, as the
// plain version rounds its Python constants; kron products fold left to
// right in the plain version's order.  The differences to the plain version
// are rsqrtf in the ball projection, the order of the label sums (left to
// right here) and of the norm sums.  A zero pair vector keeps scale 1, where
// the JAX form gives NaN for radius 0.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "pdhg_chunk.cuh"

namespace {

// the family's two scalars in the buffer's slots 3 and 4
enum { S_BALL = S_ARG3, S_DS = S_ARG4 };  // pair-ball radius, s shift

struct Consts {
  float sig_q, sig_p, sig_s, tau_u, tau_v;  // preconditioner segments
  float sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v;  // their square roots
};

struct TK {
  float* u;    // (L, nx, ny) labels, updated in place
  float* v;    // (2k, nx, ny) pair multipliers, updated in place
  float* q;    // (2L, nx, ny) gradient duals, updated in place
  float* p;    // (2k, nx, ny) pair duals, updated in place
  float* s;    // (nx, ny) sum multiplier, updated in place
  float* up;   // u, v, q, p, s before the chunk's last (aligned) iteration
  float* vp;
  float* qp;
  float* pp;
  float* sp;
  float* kxq;   // (2L, nx, ny) grad u + kron(P^T, I) v carried
  float* kxqp;  // the same of the previous iterate
  float* su;    // (nx, ny) sum_l u carried
  float* sup;   // the same of u_prev
  const float* f;
  const float* kron;  // the taps, see the layout above
  float* sc;
  float* partial;  // 4 per block
  float* terms;    // the resident chunk's norm terms, 4 (nx, ny) planes
  int L, k, nx, ny, ntaps;
  int nxg;  // rows of the global plane of a halo launch; 0: the whole plane
  // floats from one instance to the next of (u, up), (v, vp), (q, qp),
  // (p, pp) and (s, sp) in a batched launch: L n, 2k n, 2L n, 2k n and n
  // where each buffer holds its instances back to back, or the rows of a
  // route's flat x and y
  long long zu, zv, zq, zp, zs;
  Consts c;
};

// The buffers of instance z of a batched launch, each moved with 64-bit
// offsets: the state and its previous iterate by their strides, f by L
// planes, kxq by 2L, su by one.  The taps are shared; block_partials
// places a streaming launch's partials by blockIdx.z itself.
__device__ __forceinline__ TK instance_at(TK b, size_t z) {
  size_t n = (size_t)b.nx * b.ny, nl = n * b.L;
  b.u += z * b.zu;
  b.up += z * b.zu;
  b.v += z * b.zv;
  b.vp += z * b.zv;
  b.q += z * b.zq;
  b.qp += z * b.zq;
  b.p += z * b.zp;
  b.pp += z * b.zp;
  b.s += z * b.zs;
  b.sp += z * b.zs;
  b.f += z * nl;
  b.kxq += 2 * z * nl;
  b.kxqp += 2 * z * nl;
  b.su += z * n;
  b.sup += z * n;
  b.sc += z * S_LEN;
  return b;
}

// The buffers of this block's instance (blockIdx.z) of a streaming launch.
__device__ __forceinline__ TK instance_of(const TK& b) {
  return instance_at(b, blockIdx.z);
}

// Offsets of the runs of the taps array.
struct Kron {
  const float* row_ptr;  // 2L + 1
  const float* col;      // T
  const float* wr;       // T
  const float* col_ptr;  // 2k + 1
  const float* row;      // T
  const float* wc;       // T
};

// The floats of the taps array for (L, k) and T taps.
__host__ __device__ __forceinline__ int kron_floats(int L, int k, int T) {
  return 2 * L + 2 * k + 2 + 4 * T;
}

__device__ __forceinline__ Kron kron_at(const float* kron, int L, int k,
                                        int T) {
  Kron r;
  r.row_ptr = kron;
  r.col = r.row_ptr + 2 * L + 1;
  r.wr = r.col + T;
  r.col_ptr = r.wr + T;
  r.row = r.col_ptr + 2 * k + 1;
  r.wc = r.row + T;
  return r;
}

__device__ __forceinline__ Kron kron_of(const TK& b) {
  return kron_at(b.kron, b.L, b.k, b.ntaps);
}

// One entry of kron(P^T, I) x or its transpose at pixel p: the fold over
// the run [ptr[o], ptr[o + 1]) of w * src[idx * n + p], 0 for an empty run.
__device__ __forceinline__ float kron_fold(const float* ptr, const float* idx,
                                           const float* w, int o,
                                           const float* src, size_t n,
                                           size_t p) {
  int lo = (int)__ldg(ptr + o), hi = (int)__ldg(ptr + o + 1);
  if (lo == hi) return 0.f;
  float acc = __ldg(w + lo) * src[(size_t)__ldg(idx + lo) * n + p];
  for (int t = lo + 1; t < hi; ++t)
    acc = acc + __ldg(w + t) * src[(size_t)__ldg(idx + t) * n + p];
  return acc;
}

// Gradient row r of u at (i, j): dx of label r for r < L, dy of label
// r - L otherwise, Neumann at the global plane's edges.
__device__ __forceinline__ float grad_row(const float* u, int r, int L,
                                          size_t n, int i, int j, int nx,
                                          int ny, const RowCtx& rc) {
  size_t p = (size_t)i * ny + j;
  if (r < L) {
    size_t pl = r * n + p;
    return has_below(rc, i, nx) ? u[pl + ny] - u[pl] : 0.f;
  }
  size_t pl = (r - L) * n + p;
  return j < ny - 1 ? u[pl + 1] - u[pl] : 0.f;
}

// The u rows of K^T y at label l of pixel (i, j): the masked gradient
// adjoint of (q_x, q_y) plus s.  q_x is masked on the global last row.
__device__ __forceinline__ float kty_u(const float* q, float sv, int l,
                                       int L, size_t n, int i, int j, int ny,
                                       const RowCtx& rc) {
  size_t pl = l * n + (size_t)i * ny + j, ql = pl + L * n;
  float dxt = (has_above(rc, i) ? q[pl - ny] : 0.f)
              - (i + rc.off < rc.nxg - 1 ? q[pl] : 0.f);
  float dyt = (j > 0 ? q[ql - 1] : 0.f) - (j < ny - 1 ? q[ql] : 0.f);
  return (dxt + dyt) + sv;
}

// Seed of a launch: kxq = grad u + kron(P^T, I) v and su = sum_l u.
// Bound: memory, L + 2k planes read, 2L + 1 written.
__global__ void tight_seed(TK b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  Kron kr = kron_of(b);
  RowCtx rc = row_ctx(b.sc, b.nx, b.nxg);
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  for (int r = 0; r < 2 * b.L; ++r)
    b.kxq[r * n + p] = grad_row(b.u, r, b.L, n, i, j, b.nx, b.ny, rc)
                       + kron_fold(kr.row_ptr, kr.col, kr.wr, r, b.v, n, p);
  float acc = 0.f;
  for (int l = 0; l < b.L; ++l)
    acc = l == 0 ? b.u[l * n + p] : acc + b.u[l * n + p];
  b.su[p] = acc;
}

// Primal step (_chunk_core's update, u part): for every label,
// u <- max(u - tau Tau_u K^T y - tau Tau_u f, 0).
// Bound: memory, 4L + 1 planes read (u, q, f, s), L written (2L on the
// aligned iteration, which also saves u_prev).
__global__ void tight_primal(TK b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  RowCtx rc = row_ctx(b.sc, b.nx, b.nxg);
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  float tu = b.sc[S_TAU] * b.c.tau_u;
  float sv = b.s[p];
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float kty = kty_u(b.q, sv, l, b.L, n, i, j, b.ny, rc);
    float uv = b.u[pl];
    float tf = tu * b.f[pl];
    if (save_prev) b.up[pl] = uv;
    b.u[pl] = fmaxf((uv - tu * kty) - tf, 0.f);
  }
}

// Dual step (the rest of the update, all at the thread's own pixel):
//   v <- v - tau Tau_v (kron(P^T, I)^T q + p);
//   p <- the pair-ball projection of p + sigma Sigma_p ((1 + theta) v_new
//        - theta v);
//   q <- q + sigma Sigma_q ((1 + theta) kxq_new - theta kxq), kxq_new =
//        grad u + kron(P^T, I) v_new (the free dual);
//   s <- s + sigma Sigma_s ((1 + theta) su_new - theta su) - sigma
//        Sigma_s d_s.
// Bound: memory, L + 6k + 4L + 2 planes read, 4k + 4L + 2 written (twice
// that on the aligned iteration, which saves v, p, q, kxq, s, su).
__global__ void tight_dual(TK b, int save_prev) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  if (!pixel(b.nx, b.ny, i, j)) return;
  Kron kr = kron_of(b);
  RowCtx rc = row_ctx(b.sc, b.nx, b.nxg);
  int L = b.L, k = b.k;
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  float tau = b.sc[S_TAU], sigma = b.sc[S_SIGMA], theta = b.sc[S_THETA];
  float tp = 1.f + theta;
  float tv = tau * b.c.tau_v, sq = sigma * b.c.sig_q;
  float spc = sigma * b.c.sig_p, ss = sigma * b.c.sig_s;
  // v and the unscaled p (K^T y of the old q)
  for (int m = 0; m < 2 * k; ++m) {
    size_t pm = m * n + p;
    float pv = b.p[pm], vv = b.v[pm];
    float ktyv = kron_fold(kr.col_ptr, kr.row, kr.wc, m, b.q, n, p) + pv;
    float v2 = vv - tv * ktyv;
    if (save_prev) {
      b.vp[pm] = vv;
      b.pp[pm] = pv;
    }
    b.v[pm] = v2;
    b.p[pm] = pv + spc * (tp * v2 - theta * vv);
  }
  // the per-pixel radius ball of each pair (m, m + k)
  float radius = b.sc[S_BALL];
  for (int m = 0; m < k; ++m) {
    size_t pa = m * n + p, pb = pa + k * n;
    float a0 = b.p[pa], a1 = b.p[pb];
    float nn = a0 * a0 + a1 * a1;
    float scale = nn > 0.f ? fminf(1.f, radius * rsqrtf(nn)) : 1.f;
    b.p[pa] = a0 * scale;
    b.p[pb] = a1 * scale;
  }
  // q, the free dual, with kxq from the new u and v
  for (int r = 0; r < 2 * L; ++r) {
    size_t pr = r * n + p;
    float kx2 = grad_row(b.u, r, L, n, i, j, b.nx, b.ny, rc)
                + kron_fold(kr.row_ptr, kr.col, kr.wr, r, b.v, n, p);
    float qv = b.q[pr], kxo = b.kxq[pr];
    if (save_prev) {
      b.qp[pr] = qv;
      b.kxqp[pr] = kxo;
    }
    b.q[pr] = qv + sq * (tp * kx2 - theta * kxo);
    b.kxq[pr] = kx2;
  }
  // s with the new label sum
  float su2 = 0.f;
  for (int l = 0; l < L; ++l)
    su2 = l == 0 ? b.u[l * n + p] : su2 + b.u[l * n + p];
  float sv = b.s[p], suv = b.su[p];
  if (save_prev) {
    b.sp[p] = sv;
    b.sup[p] = suv;
  }
  b.s[p] = (sv + ss * (tp * su2 - theta * suv)) - ss * b.sc[S_DS];
  b.su[p] = su2;
}

// The four norm terms of pixel (i, j) of an owned row, added to acc in
// the order of the first pass (_chunk_core after the aligned iteration):
// the terms of |pd|^2 and |z_hat|^2 over the q, p and s planes and of
// |dd|^2 and |w_hat|^2 over the u and v planes.  K^T of the current and
// previous duals is recomputed.  Reads device memory only: the body of
// tight_norm_partial and of the resident chunk's norms.
__device__ __forceinline__ void norm_terms(const TK& b, const RowCtx& rc,
                                           int i, int j, float acc[4]) {
  Kron kr = kron_of(b);
  int L = b.L, k = b.k;
  size_t n = (size_t)b.nx * b.ny, p = (size_t)i * b.ny + j;
  float tau_raw = b.sc[S_TAU], sigma_raw = b.sc[S_SIGMA];
  float theta = b.sc[S_THETA];
  float tp = 1.f + theta;
  const Consts& c = b.c;
  float dq = sigma_raw * c.sqrt_q, dp = sigma_raw * c.sqrt_p;
  float ds = sigma_raw * c.sqrt_s;
  float du = tau_raw * c.sqrt_u, dv = tau_raw * c.sqrt_v;
  for (int r = 0; r < 2 * L; ++r) {
    size_t pr = r * n + p;
    float kx2 = b.kxq[pr];
    float z = (b.qp[pr] - b.q[pr]) / dq
              + c.sqrt_q * (tp * kx2 - theta * b.kxqp[pr]);
    float pd = z - c.sqrt_q * kx2;
    acc[0] += pd * pd;
    acc[1] += z * z;
  }
  for (int m = 0; m < 2 * k; ++m) {
    size_t pm = m * n + p;
    float v2 = b.v[pm], vo = b.vp[pm];
    float z = (b.pp[pm] - b.p[pm]) / dp
              + c.sqrt_p * (tp * v2 - theta * vo);
    float pd = z - c.sqrt_p * v2;
    float kty2 = kron_fold(kr.col_ptr, kr.row, kr.wc, m, b.q, n, p)
                 + b.p[pm];
    float ktyp = kron_fold(kr.col_ptr, kr.row, kr.wc, m, b.qp, n, p)
                 + b.pp[pm];
    float wh = (vo - v2) / dv - c.sqrt_v * ktyp;
    float dd = wh + c.sqrt_v * kty2;
    acc[0] += pd * pd;
    acc[1] += z * z;
    acc[2] += dd * dd;
    acc[3] += wh * wh;
  }
  float s2 = b.s[p], so = b.sp[p], su2 = b.su[p];
  float zs = (so - s2) / ds + c.sqrt_s * (tp * su2 - theta * b.sup[p]);
  float pds = zs - c.sqrt_s * su2;
  acc[0] += pds * pds;
  acc[1] += zs * zs;
  for (int l = 0; l < L; ++l) {
    size_t pl = l * n + p;
    float kty2 = kty_u(b.q, s2, l, L, n, i, j, b.ny, rc);
    float ktyp = kty_u(b.qp, so, l, L, n, i, j, b.ny, rc);
    float wh = (b.up[pl] - b.u[pl]) / du - c.sqrt_u * ktyp;
    float dd = wh + c.sqrt_u * kty2;
    acc[2] += dd * dd;
    acc[3] += wh * wh;
  }
}

// First pass of the four preconditioned residual norms: norm_terms of every
// pixel of the owned rows, then per-block tree sums into partial[4 * block].
// Bound: memory, about 14L + 16k + 4 planes read once per chunk.
__global__ void tight_norm_partial(TK b) {
  b = instance_of(b);
  if (b.sc[S_CONV] != 0.f) return;
  int i, j;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  RowCtx rc = row_ctx(b.sc, b.nx, b.nxg);
  if (pixel(b.nx, b.ny, i, j) && owned_row(rc, i))
    norm_terms(b, rc, i, j, acc);
  block_partials(acc, b.partial);
}

// One chunk of `batch` instances: the seed, `count` iterations, the norm
// partials and the squared norms of every instance into its scalars (one
// finish block each).
int chunk(const TK& b, int count, int batch, cudaStream_t st) {
  dim3 grid = grid_of(b.nx, b.ny, batch), block(BX, BY);
  tight_seed<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  for (int it = 0; it < count; ++it) {
    int last = it == count - 1;
    tight_primal<<<grid, block, 0, st>>>(b, last);
    LAUNCH_CHECK();
    tight_dual<<<grid, block, 0, st>>>(b, last);
    LAUNCH_CHECK();
  }
  tight_norm_partial<<<grid, block, 0, st>>>(b);
  LAUNCH_CHECK();
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pdhg_finish<<<batch, FIN, 0, st>>>(b.sc, b.partial, (int)(grid.x * grid.y),
                                     count, 0, STEP_NONE, none);
  LAUNCH_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// The grid-resident chunks: one cooperative launch runs what chunk() runs
// in 2 count + 3 launches, for the whole plane and for a halo band alike
// (the row context of pdhg_chunk.cuh; tight_resident), and for B instances
// side by side (tight_resident_batched).
//
// What bounds it.  At tight128x4's shape (128x128, L = 4, k = 6, 24 taps,
// ri 10) the streaming sequence is 23 launches of about 9 us, most of it
// launch latency and tails: an iteration's 131 planes of 64 KB stay in the
// L2.  The chunk's state (u, v, q, p, s, f and the carried kxq and su: 3L +
// 4k + 2 + 2L planes, 50 floats a pixel at L = 4) fits in the shared memory
// of the card's SMs.  A batched launch of tight8x128x4 streams the 8
// instances' planes through the same 23 launches; one instance alone on
// the resident grid is set by its two grid barriers an iteration (bands of
// 1 row), so the instances one after another, as rows 15, 18 and 25 run
// them, would cost about 8 single-instance chunks.  Side by side, a block
// holds 8 rows of one instance (1024 pixels), and an iteration is bound by
// the latency of each thread's chains of shared-memory loads (a kron
// fold's run, then its indices, then the values), not by the barriers: on
// an H100 SXM at 700 W about 31 us an iteration walking (plane, pixel)
// items with four integer divisions an item, 19 us a pixel a thread; and
// norm_terms from device memory, 2 pixels a thread, was the largest part
// of a chunk's fixed cost.
//
// Design.  One block of RES_THREADS on each SM; block b owns the rows
// band_of(nx, b, G) and holds them in shared memory (TightRes) from the load
// to the last iteration: u with 1 row below (the forward difference), q
// with 1 row above (q_x's adjoint; q_y's row above is room only), and the
// band's rows of v, p, kxq, f, s and su, with the taps array beside them
// (its runs and indices as ints).  Each value is tight_seed's,
// tight_primal's or tight_dual's expression in the same order, the kron
// folds left to right over the same runs; the label sums stay in one
// thread.  A band of a 128-wide plane is 1 or 2 rows, 128 or 256 pixels
// for 512 threads, so each half-step spreads its independent per-pixel
// loops over the threads as items (t, pixel), t the label, pair plane or
// row (the item walk): the primal step over (label, pixel); the dual step
// in two passes, first v and the unscaled p over (pair plane, pixel) (they
// read the old q), then, after a __syncthreads, the pair balls over (pair,
// pixel), q with the carried kxq over (row, pixel) (they read the new v)
// and s with su over pixels.  A band of at least RES_THREADS pixels (the
// batched launch's 8-row bands) takes a pixel a thread instead (the pixel
// walk: a pixel's dual values read only that pixel's duals, so its passes
// need no barrier between them), which spends no index arithmetic on the
// items.  The exchange is as in fused_multilabel.cu: the primal step
// writes u to device memory and the dual step q_x, and after a grid
// barrier every block copies in the one row its next half-step reads (u's
// row below, q_x's row above).  The aligned iteration also writes the new
// and previous v, p, q, s, the previous u and the carried kxq and su of
// both iterates into the streaming sequence's buffers.  The norms: the
// item walk runs tight_norm_partial's per-pixel body (norm_terms) on its
// band's pixels from device memory after a grid barrier; the pixel walk
// adds norm_terms' terms as the aligned iteration makes them, in the same
// order of the sums (w_hat's u terms kept in f's rows from the primal
// step; the q terms, then the pair planes' after the balls, then s's;
// |dd|^2 and |w_hat|^2's u terms after the last exchange, from the new
// duals in shared memory).  Both reduce through the streaming grid's tiles
// and finish (coop_tile_partials, finish_block): the launch is bit-equal
// to the streaming sequence in the planes and the norms.  Barriers: two an
// iteration, one before the tiles, one before the finish.
//
// The batched launch (tight_resident_batched) puts its instances side by
// side: instance z takes blocks [z G, (z + 1) G), G = SMs / B, and each
// group runs the body above (tight_resident_chunk) on its instance's bands
// only, so the whole grid crosses each barrier once for all B instances.
// At tight8x128x4 on 132 SMs that is 16 blocks an instance, 8-row bands of
// 1024 pixels (the pixel walk).  The exchange, the norm terms (4 planes an
// instance) and the tiles (instance z's partials at z times one instance's
// tiles) stay within the group; block 0 of a group finishes its instance.
// Every block reads every instance's flag before any barrier (no launch
// writes one): the grid leaves at once where all are set; a flagged
// instance's blocks skip all their work but pass every barrier, so its
// buffers stay as they were and its norms are what the caller left in sc,
// as in the streaming sequence.  Instance z is bit-equal to the
// single-instance launches on it alone.
// ---------------------------------------------------------------------------

struct TightRes {
  LWin u, q, v, p, kxq, f, s, su;
  float* kron;  // the taps array
};

// Floats of TightRes for bands of at most rmax rows.
__host__ __device__ __forceinline__ size_t tight_resident_floats(
    int L, int k, int ntaps, int rmax, int ny) {
  return ((size_t)3 * L * (rmax + 1) + (size_t)(4 * k + 3 * L + 2) * rmax)
             * ny
         + kron_floats(L, k, ntaps);
}

__device__ __forceinline__ TightRes tight_layout(float* smem, int L, int k,
                                                 int lo, int rmax, int ny) {
  TightRes w;
  float* p = smem;
  w.u = take(p, L, lo, rmax + 1, ny);
  w.q = take(p, 2 * L, lo - 1, rmax + 1, ny);
  w.v = take(p, 2 * k, lo, rmax, ny);
  w.p = take(p, 2 * k, lo, rmax, ny);
  w.kxq = take(p, 2 * L, lo, rmax, ny);
  w.f = take(p, L, lo, rmax, ny);
  w.s = take(p, 1, lo, rmax, ny);
  w.su = take(p, 1, lo, rmax, ny);
  w.kron = p;
  return w;
}

// Planes [l, ...) of window v.
__device__ __forceinline__ LWin from_plane(const LWin& v, int l) {
  return LWin{v.a + (size_t)l * v.rows * v.w, v.r0, v.rows, v.w};
}

// The taps array in shared memory, its runs and indices as ints.
struct KronS {
  const int* row_ptr;
  const int* col;
  const float* wr;
  const int* col_ptr;
  const int* row;
  const float* wc;
};

__device__ __forceinline__ KronS kron_in(const float* a, int L, int k,
                                         int T) {
  const Kron r = kron_at(a, L, k, T);
  return KronS{reinterpret_cast<const int*>(r.row_ptr),
               reinterpret_cast<const int*>(r.col), r.wr,
               reinterpret_cast<const int*>(r.col_ptr),
               reinterpret_cast<const int*>(r.row), r.wc};
}

// The taps array `kron` into shared memory at `a` (kron_in's layout).
__device__ __forceinline__ void load_kron(float* a, const float* kron, int L,
                                          int k, int T) {
  const int r1 = 2 * L + 1 + T, c0 = r1 + T, c1 = c0 + 2 * k + 1 + T;
  for (int t = threadIdx.x; t < kron_floats(L, k, T); t += RES_THREADS) {
    const float v = kron[t];
    if (t < r1 || (t >= c0 && t < c1))
      reinterpret_cast<int*>(a)[t] = (int)v;
    else
      a[t] = v;
  }
}

// kron_fold on the taps in shared memory and a window of planes.
__device__ __forceinline__ float kron_fold_w(const int* ptr, const int* idx,
                                             const float* w, int o,
                                             const LWin& src, int i, int j) {
  int lo = ptr[o], hi = ptr[o + 1];
  if (lo == hi) return 0.f;
  float acc = w[lo] * src.at(idx[lo], i, j);
  for (int t = lo + 1; t < hi; ++t)
    acc = acc + w[t] * src.at(idx[t], i, j);
  return acc;
}

// kron_fold on the taps in shared memory and device planes.
__device__ __forceinline__ float kron_fold_s(const int* ptr, const int* idx,
                                             const float* w, int o,
                                             const float* src, size_t n,
                                             size_t p) {
  int lo = ptr[o], hi = ptr[o + 1];
  if (lo == hi) return 0.f;
  float acc = w[lo] * src[(size_t)idx[lo] * n + p];
  for (int t = lo + 1; t < hi; ++t)
    acc = acc + w[t] * src[(size_t)idx[t] * n + p];
  return acc;
}

// grad_row on the window of u.
__device__ __forceinline__ float grad_row_w(const LWin& u, int r, int L,
                                            int i, int j, int nx, int ny,
                                            const RowCtx& rc) {
  if (r < L) return has_below(rc, i, nx) ? u.at(r, i + 1, j) - u.at(r, i, j)
                                         : 0.f;
  return j < ny - 1 ? u.at(r - L, i, j + 1) - u.at(r - L, i, j) : 0.f;
}

// kty_u on the window of q.
__device__ __forceinline__ float kty_u_w(const LWin& q, float sv, int l,
                                         int L, int i, int j, int ny,
                                         const RowCtx& rc) {
  float dxt = (has_above(rc, i) ? q.at(l, i - 1, j) : 0.f)
              - (i + rc.off < rc.nxg - 1 ? q.at(l, i, j) : 0.f);
  float dyt = (j > 0 ? q.at(L + l, i, j - 1) : 0.f)
              - (j < ny - 1 ? q.at(L + l, i, j) : 0.f);
  return (dxt + dyt) + sv;
}

// Item (t, px) of a band's per-pixel loop over the planes t of its npx
// pixels, walked RES_THREADS items at a time from item threadIdx.x: plane
// t at pixel px = (i - lo) ny + j of the band.  One division at the start
// and none a step (next_item): an integer division by a count known only
// at run time costs about 20 instructions.
struct Item {
  int t, px, i, j;
};

__device__ __forceinline__ Item first_item(int npx, int lo, int ny) {
  if (npx == 0) return Item{1 << 30, 0, lo, 0};  // no item
  const int e = threadIdx.x, px = e % npx;
  return Item{e / npx, px, lo + px / ny, px % ny};
}

__device__ __forceinline__ void next_item(Item& it, int npx, int rows,
                                          int ny) {
  it.px += RES_THREADS;
  next_pixel(it.i, it.j, ny);
  while (it.px >= npx) {
    it.px -= npx;
    ++it.t;
    it.i -= rows;
  }
}

// One chunk of instance `b` by block `blk` of the `nblk` blocks that share
// it, the band band_of(nx, blk, nblk) of at most rmax rows in `smem`.  An
// inactive block (its instance flagged) does no work but passes every grid
// barrier of the chunk.  Bands of at least RES_THREADS pixels take the
// pixel walk, smaller ones the item walk (the same in every block: rmax
// decides).
__device__ __forceinline__ void tight_resident_chunk(
    const TK& b, int count, int rmax, int blk, int nblk, bool active,
    float* smem, cooperative_groups::grid_group& grid) {
  const int L = b.L, k = b.k, nx = b.nx, ny = b.ny;
  const size_t n = (size_t)nx * ny;
  const RowCtx rc = row_ctx(b.sc, nx, b.nxg);
  int lo, hi;
  band_of(nx, blk, nblk, lo, hi);
  const TightRes w = tight_layout(smem, L, k, lo, rmax, ny);
  const int rows = active ? hi - lo : 0;
  const int npx = rows * ny;  // the pixels the walks take
  const bool pixels = rmax * ny >= RES_THREADS;
  const KronS kr = kron_in(w.kron, L, k, b.ntaps);
  if (active) {
    load_kron(w.kron, b.kron, L, k, b.ntaps);
    load_rows(w.u, b.u, L, lo, hi + 1, nx);
    load_rows(w.q, b.q, L, lo - 1, hi, nx);
    load_rows(from_plane(w.q, L), b.q + L * n, L, lo, hi, nx);
    load_rows(w.v, b.v, 2 * k, lo, hi, nx);
    load_rows(w.p, b.p, 2 * k, lo, hi, nx);
    load_rows(w.f, b.f, L, lo, hi, nx);
    load_rows(w.s, b.s, 1, lo, hi, nx);
  }
  __syncthreads();
  // tight_seed at row t < 2L of kxq, the label sum at t = 2L
  auto seed = [&](int t, int i, int j) {
    if (t < 2 * L) {
      w.kxq.at(t, i, j) = grad_row_w(w.u, t, L, i, j, nx, ny, rc)
                          + kron_fold_w(kr.row_ptr, kr.col, kr.wr, t, w.v, i,
                                        j);
    } else {
      float acc = 0.f;
      for (int l = 0; l < L; ++l)
        acc = l == 0 ? w.u.at(l, i, j) : acc + w.u.at(l, i, j);
      w.su.at(0, i, j) = acc;
    }
  };
  if (pixels) {
    for (int px = threadIdx.x, i = lo + px / ny, j = px % ny; px < npx;
         px += RES_THREADS, next_pixel(i, j, ny))
      for (int t = 0; t <= 2 * L; ++t) seed(t, i, j);
  } else {
    for (Item it = first_item(npx, lo, ny); it.t < 2 * L + 1;
         next_item(it, npx, rows, ny))
      seed(it.t, it.i, it.j);
  }
  __syncthreads();

  // the launch's scalars and the constants the loops share, each the same
  // expression of them as in the streaming kernels and norm_terms
  const Consts& c = b.c;
  const float tau = b.sc[S_TAU], sigma = b.sc[S_SIGMA];
  const float theta = b.sc[S_THETA], radius = b.sc[S_BALL];
  const float shift = b.sc[S_DS];
  const float tu = tau * c.tau_u;
  const float tp = 1.f + theta;
  const float tv = tau * c.tau_v, sq = sigma * c.sig_q;
  const float spc = sigma * c.sig_p, ss = sigma * c.sig_s;
  const float dq = sigma * c.sqrt_q, dp = sigma * c.sqrt_p;
  const float ds = sigma * c.sqrt_s;
  const float du = tau * c.sqrt_u, dv = tau * c.sqrt_v;
  bool last = false;  // the aligned iteration

  // The values at one (plane, pixel): tight_primal's, tight_dual's and
  // norm_terms' expressions in their order, the kron folds left to right
  // over the same runs.  tight_primal at label l; with `keep` (the pixel
  // walk's aligned iteration) the u term of w_hat into f's rows, which are
  // not read again (K^T of the previous duals is this step's).
  auto primal = [&](int l, int i, int j, bool keep) {
    const size_t pl = l * n + (size_t)i * ny + j;
    float kty = kty_u_w(w.q, w.s.at(0, i, j), l, L, i, j, ny, rc);
    float uv = w.u.at(l, i, j);
    float tf = tu * w.f.at(l, i, j);
    if (last) b.up[pl] = uv;
    float un = fmaxf((uv - tu * kty) - tf, 0.f);
    w.u.at(l, i, j) = un;
    b.u[pl] = un;
    if (keep) w.f.at(l, i, j) = (uv - un) / du - c.sqrt_u * kty;
  };
  // tight_dual's v and unscaled p at pair plane m (K^T y of the old q)
  auto pair = [&](int m, int i, int j) {
    const size_t pm = m * n + (size_t)i * ny + j;
    float pv = w.p.at(m, i, j), vv = w.v.at(m, i, j);
    float ktyv = kron_fold_w(kr.col_ptr, kr.row, kr.wc, m, w.q, i, j) + pv;
    float v2 = vv - tv * ktyv;
    if (last) {
      b.vp[pm] = vv;
      b.pp[pm] = pv;
      b.v[pm] = v2;
    }
    w.v.at(m, i, j) = v2;
    w.p.at(m, i, j) = pv + spc * (tp * v2 - theta * vv);
  };
  // the ball of pair t (planes t and t + k)
  auto ball = [&](int t, int i, int j) {
    const size_t p = (size_t)i * ny + j;
    float a0 = w.p.at(t, i, j), a1 = w.p.at(t + k, i, j);
    float nn = a0 * a0 + a1 * a1;
    float scale = nn > 0.f ? fminf(1.f, radius * rsqrtf(nn)) : 1.f;
    float p0 = a0 * scale, p1 = a1 * scale;
    w.p.at(t, i, j) = p0;
    w.p.at(t + k, i, j) = p1;
    if (last) {
      b.p[t * n + p] = p0;
      b.p[(t + k) * n + p] = p1;
    }
  };
  // q and the carried kxq at row r from the new u and v; with `a`, the q
  // terms of |pd|^2 and |z_hat|^2 added
  auto qrow = [&](int r, int i, int j, float* a) {
    const size_t pr = r * n + (size_t)i * ny + j;
    float kx2 = grad_row_w(w.u, r, L, i, j, nx, ny, rc)
                + kron_fold_w(kr.row_ptr, kr.col, kr.wr, r, w.v, i, j);
    float qv = w.q.at(r, i, j), kxo = w.kxq.at(r, i, j);
    float qn = qv + sq * (tp * kx2 - theta * kxo);
    if (last) {
      b.qp[pr] = qv;
      b.kxqp[pr] = kxo;
      b.kxq[pr] = kx2;
    }
    w.q.at(r, i, j) = qn;
    w.kxq.at(r, i, j) = kx2;
    if (r < L || last) b.q[pr] = qn;
    if (a) {
      float z = (qv - qn) / dq + c.sqrt_q * (tp * kx2 - theta * kxo);
      float pd = z - c.sqrt_q * kx2;
      a[0] += pd * pd;
      a[1] += z * z;
    }
  };
  // s and su with the new label sum; with `a`, the s terms added
  auto sval = [&](int i, int j, float* a) {
    const size_t p = (size_t)i * ny + j;
    float su2 = 0.f;
    for (int l = 0; l < L; ++l)
      su2 = l == 0 ? w.u.at(l, i, j) : su2 + w.u.at(l, i, j);
    float sv = w.s.at(0, i, j), suv = w.su.at(0, i, j);
    float sn = (sv + ss * (tp * su2 - theta * suv)) - ss * shift;
    w.s.at(0, i, j) = sn;
    w.su.at(0, i, j) = su2;
    if (last) {
      b.sp[p] = sv;
      b.sup[p] = suv;
      b.s[p] = sn;
      b.su[p] = su2;
    }
    if (a) {
      float zs = (sv - sn) / ds + c.sqrt_s * (tp * su2 - theta * suv);
      float pds = zs - c.sqrt_s * su2;
      a[0] += pds * pds;
      a[1] += zs * zs;
    }
  };
  // the pair planes' terms of the four norms after the balls, K^T of the
  // previous duals from the buffers this thread wrote
  auto pair_terms = [&](int i, int j, float* a) {
    const size_t p = (size_t)i * ny + j;
    for (int m = 0; m < 2 * k; ++m) {
      const size_t pm = m * n + p;
      float v2 = w.v.at(m, i, j), vo = b.vp[pm];
      float p2 = w.p.at(m, i, j), po = b.pp[pm];
      float z = (po - p2) / dp + c.sqrt_p * (tp * v2 - theta * vo);
      float pd = z - c.sqrt_p * v2;
      float kty2 = kron_fold_w(kr.col_ptr, kr.row, kr.wc, m, w.q, i, j) + p2;
      float ktyp = kron_fold_s(kr.col_ptr, kr.row, kr.wc, m, b.qp, n, p) + po;
      float wh = (vo - v2) / dv - c.sqrt_v * ktyp;
      float dd = wh + c.sqrt_v * kty2;
      a[0] += pd * pd;
      a[1] += z * z;
      a[2] += dd * dd;
      a[3] += wh * wh;
    }
  };

  for (int it = 0; it < count; ++it) {
    last = it == count - 1;
    if (pixels) {
      for (int px = threadIdx.x, i = lo + px / ny, j = px % ny; px < npx;
           px += RES_THREADS, next_pixel(i, j, ny))
        for (int l = 0; l < L; ++l) primal(l, i, j, last);
    } else {
      for (Item it = first_item(npx, lo, ny); it.t < L;
           next_item(it, npx, rows, ny))
        primal(it.t, it.i, it.j, false);
    }
    grid.sync();
    if (active) load_rows(w.u, b.u, L, hi, hi + 1, nx);
    __syncthreads();
    if (pixels) {
      // a pixel's values read only its own pixel's duals: no barrier
      // between the passes; the aligned iteration's terms of the norms but
      // the u terms of |dd|^2 and |w_hat|^2 (after the exchange), in
      // norm_terms' order of the sums, into `terms`
      for (int px = threadIdx.x, i = lo + px / ny, j = px % ny; px < npx;
           px += RES_THREADS, next_pixel(i, j, ny)) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        float* a = last && owned_row(rc, i) ? acc : nullptr;
        for (int m = 0; m < 2 * k; ++m) pair(m, i, j);
        for (int r = 0; r < 2 * L; ++r) qrow(r, i, j, a);
        for (int t = 0; t < k; ++t) ball(t, i, j);
        if (a) pair_terms(i, j, a);
        sval(i, j, a);
        if (last)
          for (int t = 0; t < 4; ++t)
            b.terms[t * n + (size_t)i * ny + j] = acc[t];
      }
    } else {
      // the first pass over (pair plane, pixel) items; after a barrier the
      // balls over (pair, pixel), q over (row, pixel), s over pixels
      for (Item it = first_item(npx, lo, ny); it.t < 2 * k;
           next_item(it, npx, rows, ny))
        pair(it.t, it.i, it.j);
      __syncthreads();
      for (Item it = first_item(npx, lo, ny); it.t < k + 2 * L + 1;
           next_item(it, npx, rows, ny)) {
        if (it.t < k)
          ball(it.t, it.i, it.j);
        else if (it.t < k + 2 * L)
          qrow(it.t - k, it.i, it.j, nullptr);
        else
          sval(it.i, it.j, nullptr);
      }
    }
    grid.sync();
    if (!last || pixels) {
      if (active) load_rows(w.q, b.q, L, lo - 1, lo, nx);
      __syncthreads();
    }
  }

  if (pixels) {
    // the u terms of |dd|^2 and |w_hat|^2 from the new duals
    for (int px = threadIdx.x, i = lo + px / ny, j = px % ny; px < npx;
         px += RES_THREADS, next_pixel(i, j, ny)) {
      if (!owned_row(rc, i)) continue;
      const size_t p = (size_t)i * ny + j;
      float a2 = b.terms[2 * n + p], a3 = b.terms[3 * n + p];
      const float s2 = w.s.at(0, i, j);
      for (int l = 0; l < L; ++l) {
        float kty2 = kty_u_w(w.q, s2, l, L, i, j, ny, rc);
        float wh = w.f.at(l, i, j);
        float dd = wh + c.sqrt_u * kty2;
        a2 += dd * dd;
        a3 += wh * wh;
      }
      b.terms[2 * n + p] = a2;
      b.terms[3 * n + p] = a3;
    }
  } else {
    // the norms' terms from device memory, as tight_norm_partial takes them
    for (int px = threadIdx.x, i = lo + px / ny, j = px % ny; px < npx;
         px += RES_THREADS, next_pixel(i, j, ny)) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (owned_row(rc, i)) norm_terms(b, rc, i, j, acc);
      const size_t p = (size_t)i * ny + j;
      for (int t = 0; t < 4; ++t) b.terms[t * n + p] = acc[t];
    }
  }
  grid.sync();
  if (active) coop_tile_partials(b.terms, nx, ny, b.partial, smem, blk, nblk);
  grid.sync();
  if (active && blk == 0) {
    AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    dim3 g = grid_of(nx, ny);
    finish_block(reinterpret_cast<float(*)[FIN]>(smem), b.sc, b.partial,
                 (int)(g.x * g.y), count, 0, STEP_NONE, none);
  }
}

__global__ void __launch_bounds__(RES_THREADS, 1)
    tight_resident(TK b, int count, int rmax) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (b.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  tight_resident_chunk(b, count, rmax, blockIdx.x, gridDim.x, true, smem,
                       grid);
}

// `batch` instances side by side, gridDim.x / batch blocks each.
__global__ void __launch_bounds__(RES_THREADS, 1)
    tight_resident_batched(TK b, int count, int rmax, int batch) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  bool all = true;  // every flag set: every block leaves before any barrier
  for (int z = 0; z < batch; ++z)
    all = all && b.sc[(size_t)z * S_LEN + S_CONV] != 0.f;
  if (all) return;
  extern __shared__ float smem[];
  const int per = gridDim.x / batch;
  const int z = blockIdx.x / per;
  const dim3 g = grid_of(b.nx, b.ny);
  TK bz = instance_at(b, z);
  bz.partial += (size_t)z * 4 * g.x * g.y;
  bz.terms += (size_t)z * 4 * b.nx * b.ny;
  tight_resident_chunk(bz, count, rmax, blockIdx.x % per, per,
                       bz.sc[S_CONV] == 0.f, smem, grid);
}

// The dynamic shared memory of a resident launch of `kernel` on `b` whose
// `batch` instances take `blocks` = SMs / batch blocks each: TightRes for
// the largest band (rmax rows), at least the reductions' array; or 0 where
// it does not fit on the current device (then `rc` holds the error).
template <typename K>
size_t resident_smem(K kernel, const TK& b, int batch, int& blocks,
                     int& rmax, int& rc) {
  int sms = 0;
  rc = device_sms(&sms);
  if (rc) return 0;
  blocks = sms / batch;
  if (blocks < 1) {
    rc = (int)cudaErrorInvalidValue;
    return 0;
  }
  rmax = band_rows(b.nx, blocks);
  size_t smem = tight_resident_floats(b.L, b.k, b.ntaps, rmax, b.ny)
                * sizeof(float);
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

int resident_chunk(TK b, int count, cudaStream_t st) {
  int blocks = 0, rmax = 0, rc = 0;
  size_t smem = resident_smem(tight_resident, b, 1, blocks, rmax, rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &rmax};
  return resident_launch(tight_resident, args, smem, st);
}

TK tight_of(void* u, void* v, void* q, void* p, void* s, void* up, void* vp,
            void* qp, void* pp, void* sp, void* kxq, void* kxqp, void* su,
            void* sup, const void* f, const void* kron, void* sc,
            void* partial, int L, int k, int nx, int ny, int ntaps,
            Consts c) {
  TK b;
  b.u = (float*)u;
  b.v = (float*)v;
  b.q = (float*)q;
  b.p = (float*)p;
  b.s = (float*)s;
  b.up = (float*)up;
  b.vp = (float*)vp;
  b.qp = (float*)qp;
  b.pp = (float*)pp;
  b.sp = (float*)sp;
  b.kxq = (float*)kxq;
  b.kxqp = (float*)kxqp;
  b.su = (float*)su;
  b.sup = (float*)sup;
  b.f = (const float*)f;
  b.kron = (const float*)kron;
  b.sc = (float*)sc;
  b.partial = (float*)partial;
  b.terms = nullptr;
  b.L = L;
  b.k = k;
  b.nx = nx;
  b.ny = ny;
  b.ntaps = ntaps;
  b.nxg = 0;
  b.zs = (long long)nx * ny;
  b.zu = L * b.zs;
  b.zv = 2 * k * b.zs;
  b.zq = 2 * b.zu;
  b.zp = b.zv;
  b.c = c;
  return b;
}

}  // namespace

extern "C" {

// Number of per-block norm partials (4 floats each) for an (nx, ny) plane.
int prost_tight_num_blocks(int nx, int ny) {
  dim3 g = grid_of(nx, ny);
  return (int)(g.x * g.y);
}

const char* prost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// tight_fused_chunk: `count` iterations on (u, v, q, p, s) in place, the
// previous iterate of the aligned iteration into (up, vp, qp, pp, sp), the
// 4 SQUARED norms into sc[S_NORM..].  No-op when sc[S_CONV] is set.
int prost_tight_chunk(void* u, void* v, void* q, void* p, void* s, void* up,
                      void* vp, void* qp, void* pp, void* sp, void* kxq,
                      void* kxqp, void* su, void* sup, const void* f,
                      const void* kron, void* sc, void* partial, int L,
                      int k, int nx, int ny, int ntaps, float sig_q,
                      float sig_p, float sig_s, float tau_u, float tau_v,
                      float sqrt_q, float sqrt_p, float sqrt_s, float sqrt_u,
                      float sqrt_v, int count, void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  return chunk(b, count, 1, (cudaStream_t)stream);
}

// tight_fused_chunk_batched: the same for `batch` instances sharing (L, k,
// the taps, the constants) in one launch sequence; sc holds S_LEN scalars
// per instance, partial 4 per block per instance; instance z of (u, up),
// (v, vp), (q, qp), (p, pp) and (s, sp) lies zu, zv, zq, zp and zs floats
// after instance z - 1 (f and the carried planes back to back).  An
// instance whose sc[S_CONV] is set is a no-op.
int prost_tight_chunk_batched(void* u, void* v, void* q, void* p, void* s,
                              void* up, void* vp, void* qp, void* pp,
                              void* sp, void* kxq, void* kxqp, void* su,
                              void* sup, const void* f, const void* kron,
                              void* sc, void* partial, int L, int k, int nx,
                              int ny, int ntaps, float sig_q, float sig_p,
                              float sig_s, float tau_u, float tau_v,
                              float sqrt_q, float sqrt_p, float sqrt_s,
                              float sqrt_u, float sqrt_v, long long zu,
                              long long zv, long long zq, long long zp,
                              long long zs, int count, int batch,
                              void* stream) {
  if (int rc = batch_error(batch)) return rc;
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  b.zu = zu;
  b.zv = zv;
  b.zq = zq;
  b.zp = zp;
  b.zs = zs;
  return chunk(b, count, batch, (cudaStream_t)stream);
}

// tight_fused_chunk_batched as one grid-resident cooperative launch
// (tight_resident_batched): the instances side by side, each bit-equal to
// prost_tight_chunk on it alone; buffers, strides and flags as
// prost_tight_chunk_batched takes them, the carried planes written on the
// aligned iteration only, `terms` 4 (nx, ny) planes of scratch per
// instance.  More instances than SMs, or a band of an instance's share of
// the SMs that does not fit in one block's shared memory, are refused
// (cudaErrorInvalidValue or cudaErrorCooperativeLaunchTooLarge).
int prost_tight_chunk_batched_resident(
    void* u, void* v, void* q, void* p, void* s, void* up, void* vp,
    void* qp, void* pp, void* sp, void* kxq, void* kxqp, void* su, void* sup,
    const void* f, const void* kron, void* sc, void* partial, void* terms,
    int L, int k, int nx, int ny, int ntaps, float sig_q, float sig_p,
    float sig_s, float tau_u, float tau_v, float sqrt_q, float sqrt_p,
    float sqrt_s, float sqrt_u, float sqrt_v, long long zu, long long zv,
    long long zq, long long zp, long long zs, int count, int batch,
    void* stream) {
  if (int rc = batch_error(batch)) return rc;
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  b.terms = (float*)terms;
  b.zu = zu;
  b.zv = zv;
  b.zq = zq;
  b.zp = zp;
  b.zs = zs;
  int blocks = 0, rmax = 0, rc = 0;
  size_t smem = resident_smem(tight_resident_batched, b, batch, blocks, rmax,
                              rc);
  if (rc) return rc;
  void* args[] = {&b, &count, &rmax, &batch};
  return resident_launch(tight_resident_batched, args, smem,
                         (cudaStream_t)stream, 1, blocks * batch);
}

// tight_fused_chunk_halo: prost_tight_chunk on one halo-extended shard of a
// plane of nx_global rows; sc holds the row context (S_ROW_OFF, S_OWN_LO,
// S_OWN_HI) and the squared norms cover the owned rows only.
int prost_tight_chunk_halo(void* u, void* v, void* q, void* p, void* s,
                           void* up, void* vp, void* qp, void* pp, void* sp,
                           void* kxq, void* kxqp, void* su, void* sup,
                           const void* f, const void* kron, void* sc,
                           void* partial, int L, int k, int nx, int ny,
                           int ntaps, float sig_q, float sig_p, float sig_s,
                           float tau_u, float tau_v, float sqrt_q,
                           float sqrt_p, float sqrt_s, float sqrt_u,
                           float sqrt_v, int nx_global, int count,
                           void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  b.nxg = nx_global;
  return chunk(b, count, 1, (cudaStream_t)stream);
}

// tight_fused_chunk and tight_fused_chunk_halo as one grid-resident
// cooperative launch (tight_resident), bit-equal to prost_tight_chunk and
// prost_tight_chunk_halo: the same buffers, the carried planes (kxq, kxqp,
// su, sup) written on the aligned iteration only, `terms` 4 (nx, ny)
// planes of scratch.  A band's planes that do not fit in one block's shared
// memory are refused (cudaErrorCooperativeLaunchTooLarge or
// cudaErrorInvalidValue).  No-op when sc[S_CONV] is set.
int prost_tight_chunk_resident(void* u, void* v, void* q, void* p, void* s,
                               void* up, void* vp, void* qp, void* pp,
                               void* sp, void* kxq, void* kxqp, void* su,
                               void* sup, const void* f, const void* kron,
                               void* sc, void* partial, void* terms, int L,
                               int k, int nx, int ny, int ntaps, float sig_q,
                               float sig_p, float sig_s, float tau_u,
                               float tau_v, float sqrt_q, float sqrt_p,
                               float sqrt_s, float sqrt_u, float sqrt_v,
                               int count, void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  b.terms = (float*)terms;
  return resident_chunk(b, count, (cudaStream_t)stream);
}

int prost_tight_chunk_halo_resident(
    void* u, void* v, void* q, void* p, void* s, void* up, void* vp,
    void* qp, void* pp, void* sp, void* kxq, void* kxqp, void* su, void* sup,
    const void* f, const void* kron, void* sc, void* partial, void* terms,
    int L, int k, int nx, int ny, int ntaps, float sig_q, float sig_p,
    float sig_s, float tau_u, float tau_v, float sqrt_q, float sqrt_p,
    float sqrt_s, float sqrt_u, float sqrt_v, int nx_global, int count,
    void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK b = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, kxq, kxqp, su, sup, f,
                  kron, sc, partial, L, k, nx, ny, ntaps, c);
  b.terms = (float*)terms;
  b.nxg = nx_global;
  return resident_chunk(b, count, (cudaStream_t)stream);
}

// The dynamic shared memory tight_resident's blocks (`batched` set:
// tight_resident_batched's) may hold on the current device, or minus the
// error.
int prost_tight_resident_smem(int batched) {
  return batched ? resident_smem_limit(tight_resident_batched)
                 : resident_smem_limit(tight_resident);
}

}  // extern "C"
