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
//   prost_tpu/ops/fused_tight.py  tight_fused_chunk_banded
//                                 -> _tight_banded_kernel,
//                                    _tight_banded_db_kernel
//   (the planes a TPU core's VMEM cannot hold: tight_tiled, further down)
// whose math is _chunk_core and _kron_ops in the same
// file and the masked _shift_ops_3d of fused_multilabel.py.  The plain
// PyTorch versions live beside their wrappers in
// prost_tpu_torch/ops/fused_tight.py.
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
// an instance's share of the SMs fits; where they do not (512x512x4 and
// its 556-row band), the chunk and its halo mode run as one tiled
// cooperative launch, one pass over device memory an iteration
// (tight_tiled); each is bit-equal to the sequence.
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
// right in the plain version's order, label sums left to right as the plain
// version sums them.  The differences to the plain version are rsqrtf in
// the ball projection and the order of the norm sums.  A zero pair vector
// keeps scale 1, where the JAX form gives NaN for radius 0.
//
// Interface: plain C, loaded with ctypes; pointers and the stream arrive
// as void*, and every entry point returns the cudaError_t of its launches.

#include "cp_async.cuh"
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

// The pixel helpers below serve the streaming kernels, the grid-resident
// chunks and the tiled chunk alike: each reads its planes through an
// accessor, a(l, i, j) the element (i, j) of plane l, which is a stack of
// device planes (Planes), a band of rows in shared memory (LWin) or a
// tile's window (MWin), and the taps through a run table in device memory
// (RunG) or in shared memory (RunS).  One expression in one order for all
// of them keeps their planes and norms bit-equal.

// (nx, ny) device planes n floats apart.
struct Planes {
  const float* a;
  size_t n;
  int ny;
  __device__ __forceinline__ float operator()(int l, int i, int j) const {
    return a[(size_t)l * n + (size_t)i * ny + j];
  }
};

// The planes of accessor `a` at one pixel: x(m) is plane m's value there.
template <class A>
struct AtPixel {
  const A& a;
  int i, j;
  __device__ __forceinline__ float operator()(int m) const {
    return a(m, i, j);
  }
};

template <class A>
__device__ __forceinline__ AtPixel<A> at_px(const A& a, int i, int j) {
  return AtPixel<A>{a, i, j};
}

// A run table of P^T's taps, by output row or by output column: run o is
// the taps [lo(o), lo(o + 1)), each an input plane at(t) and a weight
// wt(t).  In device memory its entries are floats read through __ldg
// (RunG); the grid-resident and tiled chunks copy it into shared memory
// with the runs and indices as ints (RunS).
struct RunG {
  const float* ptr;
  const float* idx;
  const float* w;
  __device__ __forceinline__ int lo(int o) const {
    return (int)__ldg(ptr + o);
  }
  __device__ __forceinline__ int at(int t) const {
    return (int)__ldg(idx + t);
  }
  __device__ __forceinline__ float wt(int t) const { return __ldg(w + t); }
};

struct RunS {
  const int* ptr;
  const int* idx;
  const float* w;
  __device__ __forceinline__ int lo(int o) const { return ptr[o]; }
  __device__ __forceinline__ int at(int t) const { return idx[t]; }
  __device__ __forceinline__ float wt(int t) const { return w[t]; }
};

// The taps by output row (kron(P^T, I): row_ptr (2L + 1), col, w (T
// each)) and by output column (its transpose: col_ptr (2k + 1), row, w).
template <class R>
struct KronT {
  R rows, cols;
};
using Kron = KronT<RunG>;
using KronS = KronT<RunS>;

// The floats of the taps array for (L, k) and T taps.
__host__ __device__ __forceinline__ int kron_floats(int L, int k, int T) {
  return 2 * L + 2 * k + 2 + 4 * T;
}

__device__ __forceinline__ Kron kron_at(const float* kron, int L, int k,
                                        int T) {
  const float* col = kron + 2 * L + 1;
  const float* wr = col + T;
  const float* col_ptr = wr + T;
  const float* row = col_ptr + 2 * k + 1;
  return Kron{RunG{kron, col, wr}, RunG{col_ptr, row, row + T}};
}

__device__ __forceinline__ Kron kron_of(const TK& b) {
  return kron_at(b.kron, b.L, b.k, b.ntaps);
}

// One entry of kron(P^T, I) x (the run table `rows`, o a row of q) or of
// its transpose (`cols`, o a pair plane) at one pixel, x(m) the pixel's
// value in input plane m: the fold over run o, left to right, of w x(m);
// 0 for an empty run.
template <class R, class X>
__device__ __forceinline__ float kron_fold(const R& run, int o, const X& x) {
  const int lo = run.lo(o), hi = run.lo(o + 1);
  if (lo == hi) return 0.f;
  float acc = run.wt(lo) * x(run.at(lo));
  for (int t = lo + 1; t < hi; ++t) acc = acc + run.wt(t) * x(run.at(t));
  return acc;
}

// Gradient row r of u at (i, j): dx of label r for r < L, dy of label
// r - L otherwise, Neumann at the global plane's edges.
template <class U>
__device__ __forceinline__ float grad_row(const U& u, int r, int L, int i,
                                          int j, int nx, int ny,
                                          const RowCtx& rc) {
  if (r < L)
    return has_below(rc, i, nx) ? u(r, i + 1, j) - u(r, i, j) : 0.f;
  return j < ny - 1 ? u(r - L, i, j + 1) - u(r - L, i, j) : 0.f;
}

// The u rows of K^T y at label l of pixel (i, j): the masked gradient
// adjoint of (q_x, q_y) plus s.  q_x is masked on the global last row.
template <class Q>
__device__ __forceinline__ float kty_u(const Q& q, float sv, int l, int L,
                                       int i, int j, int ny,
                                       const RowCtx& rc) {
  float dxt = (has_above(rc, i) ? q(l, i - 1, j) : 0.f)
              - (i + rc.off < rc.nxg - 1 ? q(l, i, j) : 0.f);
  float dyt = (j > 0 ? q(L + l, i, j - 1) : 0.f)
              - (j < ny - 1 ? q(L + l, i, j) : 0.f);
  return (dxt + dyt) + sv;
}

// sum_l u at (i, j), left to right.
template <class U>
__device__ __forceinline__ float label_sum(const U& u, int L, int i, int j) {
  float acc = 0.f;
  for (int l = 0; l < L; ++l) acc = l == 0 ? u(l, i, j) : acc + u(l, i, j);
  return acc;
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
  const Planes U{b.u, n, b.ny}, V{b.v, n, b.ny};
  for (int r = 0; r < 2 * b.L; ++r)
    b.kxq[r * n + p] = grad_row(U, r, b.L, i, j, b.nx, b.ny, rc)
                       + kron_fold(kr.rows, r, at_px(V, i, j));
  b.su[p] = label_sum(U, b.L, i, j);
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
  const Planes Q{b.q, n, b.ny};
  for (int l = 0; l < b.L; ++l) {
    size_t pl = l * n + p;
    float kty = kty_u(Q, sv, l, b.L, i, j, b.ny, rc);
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
  const Planes U{b.u, n, b.ny}, V{b.v, n, b.ny}, Q{b.q, n, b.ny};
  // v and the unscaled p (K^T y of the old q)
  for (int m = 0; m < 2 * k; ++m) {
    size_t pm = m * n + p;
    float pv = b.p[pm], vv = b.v[pm];
    float ktyv = kron_fold(kr.cols, m, at_px(Q, i, j)) + pv;
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
    float kx2 = grad_row(U, r, L, i, j, b.nx, b.ny, rc)
                + kron_fold(kr.rows, r, at_px(V, i, j));
    float qv = b.q[pr], kxo = b.kxq[pr];
    if (save_prev) {
      b.qp[pr] = qv;
      b.kxqp[pr] = kxo;
    }
    b.q[pr] = qv + sq * (tp * kx2 - theta * kxo);
    b.kxq[pr] = kx2;
  }
  // s with the new label sum
  float su2 = label_sum(U, L, i, j);
  float sv = b.s[p], suv = b.su[p];
  if (save_prev) {
    b.sp[p] = sv;
    b.sup[p] = suv;
  }
  b.s[p] = (sv + ss * (tp * su2 - theta * suv)) - ss * b.sc[S_DS];
  b.su[p] = su2;
}

// The u terms of |dd|^2 and |w_hat|^2 at pixel (i, j), added to acc[2] and
// acc[3] label by label: K^T y's u rows of the new duals (q, s2) and of
// the previous ones (qp, so) recomputed (they read q one row up and one
// column left), u and up the new and the previous labels.  The last loop
// of norm_terms, and of the tiled chunk's norm pass after the terms that
// its last iteration made.
template <class A>
__device__ __forceinline__ void u_terms(const TK& b, const A& u, const A& up,
                                        const A& q, const A& qp, float s2,
                                        float so, const RowCtx& rc, int i,
                                        int j, float acc[4]) {
  const Consts& c = b.c;
  float du = b.sc[S_TAU] * c.sqrt_u;
  for (int l = 0; l < b.L; ++l) {
    float kty2 = kty_u(q, s2, l, b.L, i, j, b.ny, rc);
    float ktyp = kty_u(qp, so, l, b.L, i, j, b.ny, rc);
    float wh = (up(l, i, j) - u(l, i, j)) / du - c.sqrt_u * ktyp;
    float dd = wh + c.sqrt_u * kty2;
    acc[2] += dd * dd;
    acc[3] += wh * wh;
  }
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
  float dv = tau_raw * c.sqrt_v;
  const Planes Q{b.q, n, b.ny}, QP{b.qp, n, b.ny};
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
    float kty2 = kron_fold(kr.cols, m, at_px(Q, i, j)) + b.p[pm];
    float ktyp = kron_fold(kr.cols, m, at_px(QP, i, j)) + b.pp[pm];
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
  u_terms(b, Planes{b.u, n, b.ny}, Planes{b.up, n, b.ny}, Q, QP, s2, so, rc,
          i, j, acc);
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

// The run tables of the taps array copied into shared memory at `a`
// (load_kron).
__device__ __forceinline__ KronS kron_in(const float* a, int L, int k,
                                         int T) {
  const Kron g = kron_at(a, L, k, T);
  auto ints = [](const float* p) { return reinterpret_cast<const int*>(p); };
  return KronS{RunS{ints(g.rows.ptr), ints(g.rows.idx), g.rows.w},
               RunS{ints(g.cols.ptr), ints(g.cols.idx), g.cols.w}};
}

// The taps array `kron` into shared memory at `a` (kron_in's layout), by
// the RES_THREADS threads of a block.
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
      w.kxq.at(t, i, j) = grad_row(w.u, t, L, i, j, nx, ny, rc)
                          + kron_fold(kr.rows, t, at_px(w.v, i, j));
    } else {
      w.su.at(0, i, j) = label_sum(w.u, L, i, j);
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
    float kty = kty_u(w.q, w.s.at(0, i, j), l, L, i, j, ny, rc);
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
    float ktyv = kron_fold(kr.cols, m, at_px(w.q, i, j)) + pv;
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
    float kx2 = grad_row(w.u, r, L, i, j, nx, ny, rc)
                + kron_fold(kr.rows, r, at_px(w.v, i, j));
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
    float su2 = label_sum(w.u, L, i, j);
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
  const Planes QP{b.qp, n, ny};
  auto pair_terms = [&](int i, int j, float* a) {
    const size_t p = (size_t)i * ny + j;
    for (int m = 0; m < 2 * k; ++m) {
      const size_t pm = m * n + p;
      float v2 = w.v.at(m, i, j), vo = b.vp[pm];
      float p2 = w.p.at(m, i, j), po = b.pp[pm];
      float z = (po - p2) / dp + c.sqrt_p * (tp * v2 - theta * vo);
      float pd = z - c.sqrt_p * v2;
      float kty2 = kron_fold(kr.cols, m, at_px(w.q, i, j)) + p2;
      float ktyp = kron_fold(kr.cols, m, at_px(QP, i, j)) + po;
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
        float kty2 = kty_u(w.q, s2, l, L, i, j, ny, rc);
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

// ---------------------------------------------------------------------------
// The tiled chunk (tight_fused_chunk_banded -> _tight_banded_kernel,
// _tight_banded_db_kernel), for the planes whose bands no grid-resident
// launch holds: 512x512x4 and its one-shard halo band of 556 rows.  The TPU
// kernels run one launch a chunk over row bands, each band's window with
// 2 count + 2 rows of halo DMAed into VMEM and the whole chunk run there.
//
// What bounds it.  A chunk's window would need a halo of 2 count + 1
// pixels (21 at ri 10) and about 7L + 4k + 2 floats a pixel: the window of
// an 8x32 tile does not fit in a block's shared memory.  One iteration
// needs only one pixel of u and q around a tile, as the multilabel chunk's
// (csrc/fused_multilabel.cu ml_tiled): the dual step at a pixel reads the
// new and the old u one row below and one column right, the new u there
// K^T q, which reads q_x one row up and q_y one column left; v, p, the kron
// coupling, the pair ball and the label sum are pointwise.  So each
// iteration is one pass over device memory: u, q, s and f read through the
// windows' overlap and v and p at their pixels (4L + 4k + 1 planes), u, q,
// s, v and p written (3L + 4k + 1): 78 planes at L = 4, 81.8 MB at
// 512x512, 24 us at the card's memory rate, where the streaming sequence
// moves about 131 planes an iteration in two launches.
//
// Design.  One cooperative launch a chunk, one block of TT_THREADS on each
// SM, a grid barrier between iterations: iteration t reads u, q and s from
// slot t mod 2 (slot A the caller's planes, slot B 3L + 1 planes of
// scratch) and writes the other.  v and p are read and written only at
// their own pixel, by the thread that owns it in every iteration, so they
// stay in the caller's planes, updated in place as the streaming kernels
// update them: no second slot.  The taps sit in shared memory (runs and
// indices as ints, as in the grid-resident chunk).  The blocks walk the
// plane's tiles (tx rows, a multiple of 8, by ty columns, of 32); a tile's
// window is the tile and tight_tiled_halo() = 1 pixel on every side, zero
// outside the plane (ops/fused_tight.py tight_tiled_halo;
// tests/test_torch_tiled_tight.py holds the plain twin exact with it and
// not without it).  In shared memory 4L + 1 planes of the window and 4k
// floats a thread:
//   1. cp.async loads of u, q_x, q_y, f and s; no dual coordinate zeroed (q
//      stays live at the plane's edges through the kron coupling, and its
//      gradient adjoint is the masked one);
//   2. tight_primal's step on the tile and one row below and one column
//      right of it, the new u into f's planes (f is read only there);
//   3. tight_dual's step at the owned pixels, u, q and s into the other
//      slot: v and the unscaled p of each pair plane from the window's q,
//      the balls, q with kxq of the new u and v, s with the new label sum.
//      kxq = grad u + kron(P^T, I) v and su = sum_l u of the old iterate,
//      which the streaming sequence carries in 2L + 1 planes, are
//      recomputed from the window and the old v by the same expressions,
//      which give the same bits.  A pixel's v and p are loaded into
//      registers before any store (their loads in flight together: 0.10
//      ms a chunk at 512x512x4), the unscaled p kept there (the balls pair
//      planes m and m + k, known at compile time: the kernel is a template
//      on L, k = L(L - 1)/2); its old and new v also sit in the thread's
//      4k floats (a kron fold reads them at indices known only at run
//      time); on the chunk's last iteration the old u, v, q, p and s also
//      go into the caller's previous-iterate planes.
// Every mask is decided by the pixel's place in the plane (the row context
// RowCtx of a halo band included), never by its place in the window.
// The norms: the last iteration also makes norm_terms' terms of the q
// rows, the pair planes and s, in its order, from the values it holds
// (K^T of the new q by the kron fold from the window, where the new q
// replaces the old at the pixel; of the old q from the previous-iterate
// planes it has just written) into 4 term planes after slot B; after a
// grid barrier the blocks add the u terms of |dd|^2 and |w_hat|^2 (u_terms,
// which read the new and the previous q one row up and one column left)
// and reduce tight_norm_partial's 32x8 tiles (TT_THREADS / NT at a time,
// in block_partials' tree) for pdhg_finish.  Planes, previous iterates and
// norms are the streaming sequence's bit for bit.  A chunk is the launch,
// the finish and, after an odd count, the copy back of slot B
// (tight_tiled_settle).  A launch whose flag is set at entry returns before
// its first barrier.
// ---------------------------------------------------------------------------

constexpr int TT_THREADS = RES_THREADS;  // a block: 16 rows of 32 threads

// Floats before a tiled block's window: the taps array, to 16 bytes.
__host__ __device__ __forceinline__ int tiled_kron_floats(int L, int k,
                                                          int T) {
  return (kron_floats(L, k, T) + 3) / 4 * 4;
}

// The dynamic shared memory of a block of the tiled launch on tx x ty tiles
// (mirrored by ops/fused_tight.py tight_tiled_bytes): the taps, then 4L + 1
// planes of the window and 4k floats a thread (k >= 1: at least the norm
// pass's trees, TT_THREADS / NT tiles of 4 NT floats, which reuse them).
inline size_t tight_tiled_smem(int L, int k, int T, int tx, int ty) {
  return (tiled_kron_floats(L, k, T)
          + (size_t)(4 * L + 1) * (tx + 2) * (ty + 2)
          + (size_t)4 * k * TT_THREADS) * sizeof(float);
}

// The launch's step constants, each the expression the streaming kernels
// form, and norm_terms' constants of the residuals.
struct TStep {
  float tu, tv, sq, spc, ss, tp, theta, radius, shift;
};

struct TNorm {
  float dq, dp, ds, dv, sqrt_q, sqrt_p, sqrt_s, sqrt_v;
};

__device__ __forceinline__ TStep tiled_step(const TK& b) {
  const float tau = b.sc[S_TAU], sigma = b.sc[S_SIGMA];
  const float theta = b.sc[S_THETA];
  return TStep{tau * b.c.tau_u,   tau * b.c.tau_v, sigma * b.c.sig_q,
               sigma * b.c.sig_p, sigma * b.c.sig_s, 1.f + theta,
               theta,             b.sc[S_BALL],    b.sc[S_DS]};
}

__device__ __forceinline__ TNorm tiled_norm(const TK& b) {
  const float tau = b.sc[S_TAU], sigma = b.sc[S_SIGMA];
  const Consts& c = b.c;
  return TNorm{sigma * c.sqrt_q, sigma * c.sqrt_p, sigma * c.sqrt_s,
               tau * c.sqrt_v,   c.sqrt_q,         c.sqrt_p,
               c.sqrt_s,         c.sqrt_v};
}

// One iteration on tile `tile` of the tiles of tx x ty: the window from
// slot `src`, the owned pixels' u, q and s into slot `dst`, v and p in
// place in a's planes; with `last` the old u, v, q, p and s also into the
// previous-iterate planes (a's up, vp, qp, pp, sp).  `a` holds f, v, p
// and the shapes; `win` the window, `scr` the threads' 4k floats.
template <int L>
__device__ __forceinline__ void tight_tiled_iteration(
    const TK& src, const TK& dst, const TK& a, const RowCtx& r,
    const TStep& st, const TNorm& nm, const KronS& kr, int tile, int tx,
    int ty, bool last, float* win, float* scr) {
  constexpr int K = L * (L - 1) / 2;
  const int nx = a.nx, ny = a.ny;
  const size_t n = (size_t)nx * ny;
  const int ntc = (ny + ty - 1) / ty;
  const int R0 = tile / ntc * tx, C0 = tile % ntc * ty;
  const int R1 = min(R0 + tx, nx), C1 = min(C0 + ty, ny);
  const int r0 = R0 - 1, c0 = C0 - 1;
  const int ww = C1 + 1 - c0, m = (R1 + 1 - r0) * ww;
  const MWin U{win, r0, c0, ww, m};
  const MWin Q{win + L * m, r0, c0, ww, m};  // q_x, then q_y: 2L planes
  const MWin F{win + 3 * L * m, r0, c0, ww, m};  // f, then the new u
  const MWin S{win + 4 * L * m, r0, c0, ww, m};

  // 1. the window of u, q, f and s, zero outside the plane
  for (int p = threadIdx.x; p < m; p += TT_THREADS) {
    const int i = r0 + p / ww, j = c0 + p % ww;
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const size_t g = (size_t)i * ny + j;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        cp_async4(U.a + l * m + p, src.u + l * n + g);
        cp_async4(F.a + l * m + p, a.f + l * n + g);
      }
#pragma unroll
      for (int t = 0; t < 2 * L; ++t)
        cp_async4(Q.a + t * m + p, src.q + t * n + g);
      cp_async4(S.a + p, src.s + g);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        U.a[l * m + p] = 0.f;
        F.a[l * m + p] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 2 * L; ++t) Q.a[t * m + p] = 0.f;
      S.a[p] = 0.f;
    }
  }
  cp_async_wait();
  __syncthreads();

  // 2. tight_primal on rows [R0, R1] and columns [C0, C1] inside the plane
  const int pw = min(C1, ny - 1) + 1 - C0;
  const int np = (min(R1, nx - 1) + 1 - R0) * pw;
  for (int p = threadIdx.x; p < np; p += TT_THREADS) {
    const int i = R0 + p / pw, j = C0 + p % pw;
    const float sv = S.at(0, i, j);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float kty = kty_u(Q, sv, l, L, i, j, ny, r);
      const float uv = U.at(l, i, j);
      const float tf = st.tu * F.at(l, i, j);
      F.at(l, i, j) = fmaxf((uv - st.tu * kty) - tf, 0.f);
    }
  }
  __syncthreads();

  // 3. tight_dual at the owned pixels: u, q and s into slot dst, v and p
  //    in place; the old and the new v of pair plane m at vo[m TT_THREADS]
  //    and vn[m TT_THREADS]
  float* vo = scr + threadIdx.x;
  float* vn = vo + 2 * K * TT_THREADS;
  auto vold = [&](int mm) { return vo[mm * TT_THREADS]; };
  auto vnew = [&](int mm) { return vn[mm * TT_THREADS]; };
  const int ow = C1 - C0, no = (R1 - R0) * ow;
  for (int p = threadIdx.x; p < no; p += TT_THREADS) {
    const int i = R0 + p / ow, j = C0 + p % ow;
    const size_t g = (size_t)i * ny + j;
    // the pixel's v and p loaded before any store, so that their loads
    // are in flight together (a store to v or p could alias them)
    float pn[2 * K], vl[2 * K];
#pragma unroll
    for (int mm = 0; mm < 2 * K; ++mm) {
      pn[mm] = a.p[mm * n + g];
      vl[mm] = a.v[mm * n + g];
    }
#pragma unroll
    for (int mm = 0; mm < 2 * K; ++mm) {
      const size_t gm = mm * n + g;
      const float pv = pn[mm], vv = vl[mm];
      const float ktyv = kron_fold(kr.cols, mm, at_px(Q, i, j)) + pv;
      const float v2 = vv - st.tv * ktyv;
      if (last) {
        a.vp[gm] = vv;
        a.pp[gm] = pv;
      }
      a.v[gm] = v2;
      vo[mm * TT_THREADS] = vv;
      vn[mm * TT_THREADS] = v2;
      pn[mm] = pv + st.spc * (st.tp * v2 - st.theta * vv);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float a0 = pn[t], a1 = pn[t + K];
      const float nn = a0 * a0 + a1 * a1;
      const float scale =
          nn > 0.f ? fminf(1.f, st.radius * rsqrtf(nn)) : 1.f;
      a.p[t * n + g] = a0 * scale;
      a.p[(t + K) * n + g] = a1 * scale;
    }
    // the norms' terms of the last iteration, in norm_terms' order: the q
    // rows, the pair planes, s (the u terms after the barrier)
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < 2 * L; ++t) {
      const float kx2 =
          grad_row(F, t, L, i, j, nx, ny, r) + kron_fold(kr.rows, t, vnew);
      const float kxo =
          grad_row(U, t, L, i, j, nx, ny, r) + kron_fold(kr.rows, t, vold);
      const float qv = Q.at(t, i, j);
      const float qn = qv + st.sq * (st.tp * kx2 - st.theta * kxo);
      dst.q[t * n + g] = qn;
      if (last) {
        a.qp[t * n + g] = qv;
        Q.at(t, i, j) = qn;  // read again only at this pixel, below
        const float z = (qv - qn) / nm.dq
                         + nm.sqrt_q * (st.tp * kx2 - st.theta * kxo);
        const float pd = z - nm.sqrt_q * kx2;
        acc[0] += pd * pd;
        acc[1] += z * z;
      }
    }
    if (last) {
      const Planes QP{a.qp, n, ny};
      for (int mm = 0; mm < 2 * K; ++mm) {
        const size_t gm = mm * n + g;
        const float v2 = vn[mm * TT_THREADS], vv = vo[mm * TT_THREADS];
        const float p2 = a.p[gm], pv = a.pp[gm];
        const float z = (pv - p2) / nm.dp
                        + nm.sqrt_p * (st.tp * v2 - st.theta * vv);
        const float pd = z - nm.sqrt_p * v2;
        const float kty2 = kron_fold(kr.cols, mm, at_px(Q, i, j)) + p2;
        const float ktyp = kron_fold(kr.cols, mm, at_px(QP, i, j)) + pv;
        const float wh = (vv - v2) / nm.dv - nm.sqrt_v * ktyp;
        const float dd = wh + nm.sqrt_v * kty2;
        acc[0] += pd * pd;
        acc[1] += z * z;
        acc[2] += dd * dd;
        acc[3] += wh * wh;
      }
    }
    const float su2 = label_sum(F, L, i, j), suv = label_sum(U, L, i, j);
    const float sv = S.at(0, i, j);
    const float sn =
        (sv + st.ss * (st.tp * su2 - st.theta * suv)) - st.ss * st.shift;
    dst.s[g] = sn;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      dst.u[l * n + g] = F.at(l, i, j);
      if (last) a.up[l * n + g] = U.at(l, i, j);
    }
    if (last) {
      a.sp[g] = sv;
      const float zs = (sv - sn) / nm.ds
                       + nm.sqrt_s * (st.tp * su2 - st.theta * suv);
      const float pds = zs - nm.sqrt_s * su2;
      acc[0] += pds * pds;
      acc[1] += zs * zs;
      for (int c = 0; c < 4; ++c) a.terms[c * n + g] = acc[c];
    }
  }
}

// `count` iterations from slot A, then tight_norm_partial's tiles of the
// slot written last into a's partials.
template <int L>
__global__ void __launch_bounds__(TT_THREADS, 1)
    tight_tiled(TK a, TK b, int count, int tx, int ty) {
  if (a.sc[S_CONV] != 0.f) return;  // every block, before any barrier
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int nx = a.nx, ny = a.ny;
  const RowCtx r = row_ctx(a.sc, nx, a.nxg);
  const TStep st = tiled_step(a);
  const TNorm nm = tiled_norm(a);
  load_kron(smem, a.kron, L, a.k, a.ntaps);
  const KronS kr = kron_in(smem, L, a.k, a.ntaps);
  float* win = smem + tiled_kron_floats(L, a.k, a.ntaps);
  float* scr = win + (size_t)(4 * L + 1) * (tx + 2) * (ty + 2);
  __syncthreads();
  const int ntiles = ((nx + tx - 1) / tx) * ((ny + ty - 1) / ty);
  for (int it = 0; it < count; ++it) {
    const bool from_b = (it & 1) != 0;
    const TK& src = from_b ? b : a;
    const TK& dst = from_b ? a : b;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tight_tiled_iteration<L>(src, dst, a, r, st, nm, kr, tile, tx, ty,
                               it == count - 1, win, scr);
      __syncthreads();  // the next window overwrites the planes
    }
    grid.sync();
  }

  // tight_norm_partial's tiles, TT_THREADS / NT at a time (block_partials'
  // tree): the last iteration's terms and the u terms of the written slot
  // (b holds a's previous-iterate planes too)
  const TK& fin = (count & 1) != 0 ? b : a;
  const size_t n = (size_t)nx * ny;
  const Planes U{fin.u, n, ny}, UP{a.up, n, ny}, Q{fin.q, n, ny};
  const Planes QP{a.qp, n, ny};
  tiled_tile_partials<TT_THREADS>(nx, ny, a.partial, win,
                                  [&](int i, int j, float v[4]) {
    if (!owned_row(r, i)) return;
    const size_t g = (size_t)i * ny + j;
    for (int c = 0; c < 4; ++c) v[c] = a.terms[c * n + g];
    u_terms(a, U, UP, Q, QP, fin.s[g], a.sp[g], r, i, j, v);
  });
}

// After a tiled chunk of an odd count whose flag was not set at entry:
// slot B's u, q and s into a's planes.
__global__ void tight_tiled_settle(TK a, TK b) {
  if (a.sc[S_CONV] != 0.f) return;
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

using TightTiledKernel = void (*)(TK, TK, int, int, int);

// The tiled kernel for L labels and k = L(L - 1)/2 pairs, or null: a
// pixel's 2k pair duals and multipliers are registers, so each L is an
// instance; the largest is TT_MAX_L (ops/fused_tight.py
// TIGHT_TILED_MAX_L), the largest that ptxas compiles without a spill at
// 128 registers a thread (6 and 7 labels spill a few bytes).
constexpr int TT_MAX_L = 5;

TightTiledKernel tight_tiled_kernel(int L, int k) {
  if (k != L * (L - 1) / 2) return nullptr;
  switch (L) {
    case 2: return tight_tiled<2>;
    case 3: return tight_tiled<3>;
    case 4: return tight_tiled<4>;
    case TT_MAX_L: return tight_tiled<TT_MAX_L>;
    default: return nullptr;
  }
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device: the smallest of its kernels' limits, or minus the error.
int tight_tiled_limit() {
  int limit = -1;
  for (int L = 2; L <= TT_MAX_L; ++L) {
    int l = resident_smem_limit(tight_tiled_kernel(L, L * (L - 1) / 2));
    if (l < 0) return l;
    limit = limit < 0 || l < limit ? l : limit;
  }
  return limit;
}

// Slot B of the tiled launch: u, q and s in the first 3L + 1 of the
// scratch's 3L + 5 planes (the norm terms in the last 4).
TK slot_b(const TK& a, void* scratch) {
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  TK b = a;
  b.u = (float*)scratch;
  b.q = b.u + nl;
  b.s = b.q + 2 * nl;
  return b;
}

// One tiled chunk: the launch (one block of TT_THREADS on each SM), the
// finish and, after an odd count, the copy back.  2 to TT_MAX_L labels
// with k = L(L - 1)/2 and 1 to MAX_TAPS taps; a tile that is not a
// multiple of the 32x8 norm tiles or whose window does not fit in a
// block's shared memory is refused with cudaErrorInvalidValue, a grid the
// card cannot hold at once by the card
// (cudaErrorCooperativeLaunchTooLarge).
int tiled_chunk(TK& a, void* scratch, int count, int tx, int ty,
                cudaStream_t st) {
  TightTiledKernel kernel = tight_tiled_kernel(a.L, a.k);
  if (kernel == nullptr || a.ntaps < 1 || a.ntaps > 4 * a.L * a.k ||
      tx < BY || tx % BY || ty < BX || ty % BX || count < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tight_tiled_smem(a.L, a.k, a.ntaps, tx, ty);
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
                                                      TT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  TK b = slot_b(a, scratch);
  a.terms = b.s + (size_t)a.nx * a.ny;
  void* args[] = {&a, &b, &count, &tx, &ty};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms),
                                  dim3(TT_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  LAUNCH_CHECK();
  AdaptConsts none = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const dim3 g = grid_of(a.nx, a.ny);
  pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, (int)(g.x * g.y), count,
                                 0, STEP_NONE, none);
  LAUNCH_CHECK();
  if (count & 1) {
    tight_tiled_settle<<<264, 512, 0, st>>>(a, b);
    LAUNCH_CHECK();
  }
  return 0;
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

// tight_fused_chunk_banded for the planes no grid-resident band holds: one
// tiled cooperative launch (tight_tiled), the finish and, after an odd
// count, the copy back.  The arguments of prost_tight_chunk_resident
// without the carried planes, with `scratch` (3L + 5 (nx, ny) planes: slot
// B and the norm terms) for `terms`, and the owned tile (tx rows, a multiple of 8; ty
// columns, of 32).  Bit-equal to prost_tight_chunk in the planes, the
// previous iterates and the 4 squared norms.  No-op when sc[S_CONV] is
// set.  2 to TT_MAX_L labels with k = L(L - 1)/2; a tile the launch cannot
// take is refused (cudaErrorInvalidValue, or the card's refusal of the
// cooperative launch).
int prost_tight_chunk_tiled(void* u, void* v, void* q, void* p, void* s,
                            void* up, void* vp, void* qp, void* pp, void* sp,
                            const void* f, const void* kron, void* sc,
                            void* partial, void* scratch, int L, int k,
                            int nx, int ny, int ntaps, float sig_q,
                            float sig_p, float sig_s, float tau_u,
                            float tau_v, float sqrt_q, float sqrt_p,
                            float sqrt_s, float sqrt_u, float sqrt_v,
                            int count, int tx, int ty, void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK a = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, nullptr, nullptr,
                  nullptr, nullptr, f, kron, sc, partial, L, k, nx, ny,
                  ntaps, c);
  return tiled_chunk(a, scratch, count, tx, ty, (cudaStream_t)stream);
}

// prost_tight_chunk_tiled on one halo-extended shard of a plane of
// nx_global rows, as prost_tight_chunk_halo takes it (the row context in
// sc, the norms over the owned rows).  Bit-equal to
// prost_tight_chunk_halo.
int prost_tight_chunk_halo_tiled(
    void* u, void* v, void* q, void* p, void* s, void* up, void* vp,
    void* qp, void* pp, void* sp, const void* f, const void* kron, void* sc,
    void* partial, void* scratch, int L, int k, int nx, int ny, int ntaps,
    float sig_q, float sig_p, float sig_s, float tau_u, float tau_v,
    float sqrt_q, float sqrt_p, float sqrt_s, float sqrt_u, float sqrt_v,
    int nx_global, int count, int tx, int ty, void* stream) {
  Consts c = {sig_q, sig_p, sig_s, tau_u, tau_v,
              sqrt_q, sqrt_p, sqrt_s, sqrt_u, sqrt_v};
  TK a = tight_of(u, v, q, p, s, up, vp, qp, pp, sp, nullptr, nullptr,
                  nullptr, nullptr, f, kron, sc, partial, L, k, nx, ny,
                  ntaps, c);
  a.nxg = nx_global;
  return tiled_chunk(a, scratch, count, tx, ty, (cudaStream_t)stream);
}

// The dynamic shared memory a block of the tiled launch may hold on the
// current device (the least of its kernels' for 2 to TT_MAX_L labels), or
// minus the error.
int prost_tight_tiled_smem() { return tight_tiled_limit(); }

}  // extern "C"
