#!/usr/bin/env python3
"""Drive prost_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a non-zero exit):

1. build the six kernel libraries from prost_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc process each, all started together;
2. check each ROF kernel against its plain PyTorch version on the card, on
   the same inputs: ``rof_chunk`` at 512x512 (grid-resident) and 2048x1536
   (tiled, as the shape rule chooses and the script checks) for the
   square, wsquare and abs data terms (ri = 10), ``rof_multichunk`` with
   alg1 and boyd (k = 8, ri = 10) at 512x512 and with alg1 at 2048x2048
   (tiled), and time both versions at 512x512; then rows 6 and 5 tiled
   (``phase_tiled_rof``): ``rof_chunk_`` at 2048x2048, 2048x1536 and
   1000x777 and ``rof_chunk_halo_`` on the 2092x2048 band of a 2048-wide
   plane, ``rof_multichunk_`` at those planes every chunk run and
   converging partway after an odd and an even number of chunks, each
   bit-equal to the streaming launch sequence and within the tolerances of
   the plain versions; both paths' light calls in turns with their
   launches and traced device ms; the chunk's time by tile and at counts
   1 and 10;
3. the same for the ADMM kernels: ``admm_chunk`` with the Chebyshev and
   the CGLS projection at 512x512 and 2048x2048 (tiled with the Chebyshev
   projection) for the three data terms (ri = 10), ``admm_multichunk`` at
   512x512 (k = 8, ri = 10) without a stop and with tolerances under which
   rho adapts, and time both versions at 512x512; and row 11 tiled
   (``phase_tiled_admm``, run after phase 15's grid-resident launches):
   ``admm_chunk_`` at 2048x2048 (ri 10 and an odd
   count of 3) and 1000x777, ``admm_multichunk_`` at those planes every
   chunk run and, from a solve's start, with rho adapting before a
   partway convergence (a pending dual rescale other than 1), each
   bit-equal to the streaming launch sequence and within the tolerances
   of the plain versions; both paths' light calls in turns with their
   launches and traced device ms;
4. solve ROF denoising at 512x512 through the modeling API with the fused
   PDHG route (boyd, residual_iter = 10), count the kernels' launches in
   that run, and hold its energy against the generic PDHG path on the same
   card and against its own primal-dual gap;
5. solve the same model with ``backend_admm(residual_iter=10)`` (the fused
   ADMM route, Chebyshev projection), count its launches, and hold its
   energy against the generic ADMM backend with the same projection and
   against the PDHG solve's energy; time the generic CGLS ADMM backend
   beside it;
6. the same for the multilabel kernels: ``ml_chunk`` (ri = 10) at
   256x256x8, at a ragged 250x190x5 and at 512x512x8 (grid-resident at the
   first two shapes, streaming at the third, as the shape rule chooses and
   the script checks), and
   ``ml_multichunk`` (k = 8, ri = 10) under boyd and goldstein at the
   three shapes, with a boyd case that converges partway through the
   launch, and time both versions at 256x256x8;
7. solve BASELINE config 3, the fast multilabel relaxation with 8 labels
   on data/cow.png at 256x256 (lmb 0.5, boyd, residual_iter 10, 2000
   iterations at tolerance 1e-5), through the modeling API with the fused
   route, count the multilabel kernels' launches, and hold its energy
   against the generic PDHG path on the same card;
   then, on the generic PDHG (no fused route takes them), with the native
   host runtime required: the dual of config 1's ROF (lmb 16) at 512x512
   as examples/example_rof_dual.py poses it, -grad^T a ``block.sparse``
   (first held on the card against ``BlockGradient2D``, two applies
   bit-equal; goldstein, residual_iter 100, ``DUAL_ROF_ITERS``
   iterations at tolerance 1e-7), u recovered with ``get_all_variables``,
   its own primal-dual gap within ENERGY_RTOL of its energy and that
   energy between config 1's dual energy and its energy; config 3's
   problem with the simplex in g (``transform(sum_ind_simplex, d=f)``, no
   sum-to-one dual) at 256x256x8 against config 3's fused energy and its
   own lower bound, and on the simplex; and every function and block factory of the JAX package's
   registry through ``eval_prox`` and ``eval_linop`` on the card against
   the CPU;
8. the same for the deblur kernel: ``deblur_chunk`` (ri = 10) at 512x512
   with config 2's 9x9 motion blur, at a ragged 250x190 with an asymmetric
   5x5 blur (both grid-resident) and at 2048x2048 (streaming), timed
   against its plain version at 512x512;
   and for the tight kernel: ``tight_chunk`` (ri = 10) at 128x128x4, at a
   ragged 250x190x3 and at 512x512x4 (tiled), timed at 128x128x4; and
   row 22 tiled (``phase_tiled_tight``, run after the multilabel rows'
   ``phase_tiled_ml``): ``tight_chunk_`` at 512x512x4 (counts 10, 3 and 1,
   and flagged) and 250x190x3 and ``tight_chunk_halo_`` on the 556-row
   band of 512x512x4, each bit-equal to the streaming launch sequence and
   within the tolerances of the plain versions; both paths' calls and the
   route's light call in turns with their launches and traced device ms;
   the chunk at counts 2 and 10; and rows 28 and 27 tiled
   (``phase_tiled_vol``, run after it): ``vol_chunk_`` at 512x512x8
   (counts 10 and 3, wsquare and abs, flagged) and 300x211x5,
   ``vol_chunk_halo_`` on the 556-row band of 512x512x8 and
   ``vol_multichunk_`` at 512x512x8 (8 chunks of 10) and 300x211x5 (5
   chunks of 3), each bit-equal to the streaming launch sequence and
   within the tolerances of the plain versions; both paths' calls and the
   route's light calls in turns with their launches and traced device ms;
   the chunk at counts 2 and 10;
9. solve BASELINE config 2, TV deblurring of data/flowers.png at 512x512
   blurred by the motion kernel (lmb 100, boyd, residual_iter 10, 2000
   iterations at tolerance 1e-5), by the fused deblur route and by the
   generic path, count the kernel's launches and hold the energies
   together; then the tight multilabel relaxation with 4 labels on
   data/junction_gray.png at 128x128 (lmb 1) the same way, held together
   on the energy, the constraint residual and the partition of unity;
10. the same for the volumetric kernels: ``vol_chunk`` (ri = 10) at
   256x256x8, at a ragged 190x250x5 for the square, wsquare and abs data
   terms, at 64x96x1 and at 512x512x8 (tiled), and ``vol_multichunk`` (k = 8, ri =
   10, boyd) from a solve's start on bench.py's vol256x8 data at the four
   shapes, timed against their plain versions at 256x256x8;
11. the batched chunks of the ensembles against their plain versions and,
   instance by instance, against the single-instance kernels (bit-equal
   expected): ``rof_chunk_batched`` (ri = 10) at B = 1024 of 128x128 on
   BASELINE config 5's data with per-instance step sizes and at a ragged
   B = 5 of 250x190 for the three data terms (each instance in a cluster),
   and its tiled launch (row 7, the instances on the grid's z axis) at B =
   2 of 1280x1280 (where the JAX package bands each instance), B = 8 of
   512x512, ragged B = 3 of 70x53 and 41x97 (forced tiled, one instance
   flagged) and B = 4 of 2048x2048, also bit-equal to the batched
   streaming sequence, at 1280x1280, 512x512 and 2048x2048 in place in
   turns with it (launches traced and counted); ``ml_chunk_batched`` at
   B = 8 of
   256x256x8 and B = 3 of 250x190x5; ``vol_chunk_batched`` at B = 8 of
   256x256x8, B = 3 of 190x250x5 for the three data terms and B = 2 of
   64x96x1; ``deblur_chunk_batched`` at B = 8 of 512x512 with config 2's
   motion blur and B = 3 of 250x190 with the asymmetric 5x5 blur;
   ``tight_chunk_batched`` at B = 8 of 128x128x4 and B = 3 of 250x190x3;
   timed at B = 1024 of 128x128 (the tiled launch at B = 4 of 2048x2048),
   B = 8 of 256x256x8, 512x512 and 128x128x4; each ``rof_chunk_batched``
   shape's path (a cluster of C CTAs per instance, or the tiled launch and
   its tile) printed and checked, and at B = 1024 of 128x128 the cluster
   launch in turns
   with the streaming sequence in place (old, new, new, old), the
   hand-written kernels each launches per call (profiler), and the
   cluster launch at the larger cluster sizes;
12. solve vol256x8, volumetric TV of eight noisy slices of data/dog.png at
   256x256 (lmb 6, boyd, residual_iter 10, 2000 iterations at tolerance
   1e-5), by the fused volumetric route and by the generic path, count
   both kernels' launches and hold the energies and the iteration counts
   together;
13. run BASELINE config 5, ensemble1024x128 as bench.py builds it (1024
   ROF instances of the procedural 128x128 image, each with its own noise
   and lmb), through ``BatchedPDHG``: the fused batched route and the
   generic batched path, 21 + 1000 iterations each, with instance-it/s;
   count the batched kernel's launches against the phase plan, hold every
   instance's energy fused against generic and instances 0, 511 and 1023
   against single-instance fused solves; then 4 such instances of
   2048x2048 (``phase_large_ensemble``: 21 + 300 iterations, the chunks
   through ``ROFBatchedChunk``'s tiled launch in place, instances 0 and 3
   against single-instance fused solves); then ensembles of 8 instances
   of config 3 and of vol256x8, each instance with its own noise, the same
   way; then ``deblur8x512``, 8 frames of config 2 (one blur, each frame
   its own noise), and ``tight8x128x4``, 8 instances of tight128x4 (each
   its own noise on the gray levels): fused batched against generic
   batched on every instance's energy (tight also on its constraint
   residual and unity error), instances 0 and 7 against single-instance
   fused solves within 1e-6; the ml, vol, deblur and tight ensembles also
   with the batched chunks' light call in turns with the copying call
   (``ensemble_turns``: instance-it/s, every instance's energy equal);
14. run a few hundred iterations of the fused ROF routes at 2048x2048, of
   the fused multilabel route at 512x512x8, of the deblur route at
   2048x2048, of the tight route at 512x512x4 and of the volumetric route
   at 512x512x8, where the JAX package bands its kernels: every kernel
   launches, the state stays on the card and finite; the ROF, Chebyshev
   ADMM, multilabel, deblur, tight and volumetric routes' chunks (and
   multichunks) tiled (their tiled launches are the kernels line's), each
   solve in turns with the streaming sequence (it/s, equal energies); the
   first call of each route's light calls there (rows 14, 16, 19, 22, 27
   and 28 tiled; row 7 tiled, from phase 11's 1280x1280 instances, the
   streaming sequence beside it) replayed under the profiler beside its
   bound;
15. the halo chunks of spatial sharding at full width (ROF 512x512, ml and
   vol 256x256x8, ri = 10, halo 22 rows): bands of 1, 2 and 4 shards cut
   from the whole plane with zeros beyond its edges (what the halo
   exchange delivers), each band's ``rof_chunk_halo`` / ``ml_chunk_halo``
   / ``vol_chunk_halo`` against its plain version, the owned rows of every
   band bit-equal to the whole-plane kernel and the bands' owned-row norms
   summed within 1e-6 of its norms; timed at the one-shard band; the same
   for ``deblur_chunk_halo`` at config 2's shape (bands of the 520-row
   full-convolution grid: 1 and 2 shards at ri 10, halo 154; 4 shards at
   ri 5, halo 84), ``tight_chunk_halo`` at 128x128x4 (ri 10, halo 22) and
   ``admm_iter_halo`` at 512x512 (Chebyshev degree 10, halo 24, with and
   without the norms, against ``admm_chunk`` with count 1), timed in place
   as the route calls it, and with the norms in turns with the launch
   sequence of ``admm_chunk`` at count 1 on the one-shard band (old, new,
   new, old), with the hand-written kernels each launches per call;
   then rows 17 and 12 grid-resident (``deblur_chunk_``, ``ml_chunk_``
   and their halo forms at config 2's and config 3's shapes and one-shard
   bands): bit-equal to the streaming sequences in the planes and the
   norms, in turns with them, the launches and traced device ms of each,
   and the call (the functional wrapper on copies, through the streaming
   sequence, against the routes' light call) in turns; then rows 15 and 9
   (``phase_resident_multi``: the batched multilabel chunk at 8 instances
   of config 3, each instance also against ``ml_chunk_`` alone; the ADMM
   multichunk at config 4's 512x512) and rows 25, 18 and 21
   (``phase_resident_batched``: the batched volumetric chunk at 8 volumes
   of vol256x8, each also against ``vol_chunk`` alone; the batched deblur
   chunk at 8 frames of config 2, each also against ``deblur_chunk_``
   alone; the batched tight chunk at 8 instances of tight128x4, side by
   side, each also against ``tight_chunk_`` alone; all on a route's flat
   rows) and rows 8 and 26
   (``phase_resident_chunk_multi``: the Chebyshev ADMM chunk at config 4's
   512x512, counts 1 and 10; the volumetric multichunk at vol256x8, every
   chunk run and converging mid-launch) and rows 2 and 1, the main path's
   (``phase_resident_rof``: the ROF chunk at config 1's 512x512, counts 1
   and 10, three data terms; the ROF multichunk, every chunk run under
   boyd and alg1 and converging mid-launch; the 2048-row planes on the
   streaming path) and rows 13 and 3 (``phase_resident_ml_halo``: the
   multilabel multichunk at config 3's 256x256x8 and at 250x190x5, every
   chunk run under boyd and goldstein and converging mid-launch, and
   512x512x8 on the streaming path; the ROF halo chunk on config 1's
   bands of 1, 2 and 4 shards for the three data terms, each band
   bit-equal to its launch sequence and its owned rows to the
   whole-plane chunk) the same way; config 1, config 2, config 3,
   tight128x4, vol256x8 and config 4 through the fused routes with the
   light calls in turns with the copying calls (``copying_routes``), it/s
   and energies;
16. solve config 1, config 3, vol256x8, config 2, tight128x4 and config 4
   (ROF 512x512 by Chebyshev ADMM) through ``ShardedFusedROF``,
   ``ShardedFusedMultilabel``, ``ShardedFusedVol``, ``ShardedFusedDeblur``,
   ``ShardedFusedTight`` and ``ShardedFusedADMM`` (2000 iterations at 1e-5,
   residual_iter 10, boyd for PDHG) on an NCCL group of one rank per card
   (``torch.cuda.device_count()``; with one card both edges of the shard
   receive zeros and its row offset is minus the halo), count the halo
   kernels' launches and the exchanges, and hold each energy against the
   one-card fused route's; the sharded ROF, multilabel, volumetric,
   deblur and tight routes again in turns with the copying chunk call;
   ``ShardedFusedADMM`` at Chebyshev
   degree 65 (300 iterations) against the one-card fused ADMM route; the
   sharded deblur route at 2048x2048, multilabel route at 512x512x8,
   tight route at 512x512x4 and volumetric route at 512x512x8 (300
   iterations) on their tiled halo chunks against the one-card fused
   routes; then
   run ensemble1024x128 through ``BatchedPDHG`` over a dp mesh of those
   ranks (21 + 300 iterations) and hold every field of every instance
   against the one-card run, bit for bit;
17. the wire format (``modeling/wire.py``): config 1, config 4, config 3,
   config 2, tight128x4, vol256x8 and the dual ROF on ``block.sparse``
   through ``to_spec``, JSON and ``from_spec`` (seconds and bytes of
   each), each rebuilt problem on the card with its preconditioners bit
   for bit and taking the original's route; config 1's rebuilt problem
   solved as phase 4 solves it, within WIRE_RTOL of phase 4's energy, and
   beside the original's solve bit for bit;
18. checkpoints (``util/checkpoint.py``): config 1 on the fused ROF route,
   config 4 on the fused Chebyshev ADMM route and ml8x256x8 on
   ``BatchedPDHG`` run to a multichunk's start, saved, loaded and run on
   to 2000 iterations, every field and the energies held within
   RESUME_ATOL of the straight run (and bit-equality reported);
19. every example of ``prost_tpu_torch/examples`` at its run() defaults:
   the route it takes, the kernels it launches, its invariant (those of
   tests/test_examples.py that need no oracle), iterations, it/s and wall
   seconds;
20. ``entry()``'s step against ``generic_step``, ``util.timed``,
   ``memory_stats`` and ``compiled_memory_analysis`` on it,
   ``dryrun_multichip`` on one NCCL rank a card, and ``util.trace`` of one
   config 1 multichunk naming ``rof_multichunk_resident``.

The images are bench.py's: data/*.png decoded by the script's own reader
and converted and resized as PIL does (``fixture_gray``; the card's
machine has no image library).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the line before
that lists each kernel with its launches, error, times and bound, and the
hand-written launches, device ms and PyTorch device ms of one timed call
(torch.profiler).
Without a CUDA card the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# The fixture images as bench.py reads them with PIL, decoded and resized
# with numpy alone (the card's machine has no image library): the
# examples' reader, bit-equal to PIL (tests/test_torch_multilabel.py).
from prost_tpu_torch.examples._common import fixture_gray, read_png_rgb  # noqa: F401

# Tolerances of kernel vs plain version on the card.  Both run in f32 with
# the same operations in the same order (the kernels are built with
# -fmad=false); they differ in the ball projection's rsqrt (rsqrtf is
# within 2 ulp, torch.rsqrt may round otherwise), which shifts iterates by
# a few ulp per iteration, and in the order of the norm sums (block tree
# vs torch.sum).
PLANE_ATOL = 2e-5   # iterates and duals are O(1)
NORM_RTOL = 1e-4    # sums of ~3e6 squares in f32
# Fused vs generic PDHG on the same problem: same iteration schedule and
# stopping rule, f32 rounding differs; energies relative.
ENERGY_RTOL = 1e-4
GAP_PER_PX = 1e-4   # primal-dual gap per pixel at the stopping tolerance
# ADMM kernels with the CGLS projection: every CG step's alpha and beta
# come from whole-plane sums taken in another order (block trees vs
# torch.sum), and ten CG steps per iteration carry that into the iterates.
CGLS_PLANE_ATOL = 5e-5
# admm_multichunk's residual norms after 80 iterations are norms of
# differences of nearby iterates, which lose digits to cancellation.
MC_NORM_RTOL = 1e-3
# The multilabel kernels against their plain versions: the same operations
# in the same order except rsqrtf, the order of the sums over the labels
# (left to right in a thread; torch.sum over the label axis may pair them
# otherwise, 1 ulp of a sum of up to 16 terms) and of the norm sums; planes
# O(1), so PLANE_ATOL holds them as it holds the ROF planes.  After a
# multichunk launch of 80 iterations the residual norms are norms of
# differences of nearby iterates and lose digits to cancellation, as for
# ADMM: MC_NORM_RTOL.
# ADMM vs PDHG on the same model: neither reaches the 1e-5 stopping
# tolerance in 2000 iterations, so what bounds their distance is how far
# each still is from the optimum.  The PDHG solve's primal-dual gap
# certifies its own distance: 3.832e-05 per pixel on an H100 (PERF.md),
# 10.0 of the ~5804 of this energy, 1.7e-3 relative.  The ADMM energy is
# held to that band about the PDHG energy (2e-3 relative, inside the 5e-3
# the JAX package's tests allow between the two backends), and above the
# PDHG solve's dual energy, which no primal energy can undercut.
ADMM_VS_PDHG_RTOL = 2e-3
# The tight solve's constraint residual and partition-of-unity error, fused
# against generic: small numbers (the relaxation stops short of 1e-5 in
# 2000 iterations) that the f32 rounding of the two paths moves a little.
TIGHT_MEASURE_RTOL = 1e-2

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# FP32 outside the tensor cores.  A kernel's bound is the larger of its
# bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Floating-point operations per pixel, counted from the algorithm that the
# kernels (csrc/*.cu) run, square data term: each +, -, *, /, sqrt, rsqrt,
# min and max on a plane value counts one; scalar set-up, index arithmetic
# and values a kernel recomputes at a neighbour (t1, x_proj, and the
# neighbours' differences inside M) do not.
#   PDHG iteration: K^T q 3, primal step 5, grad x 2, extrapolation 8,
#   ball projection 8.  Residual norms of a chunk: 42.
#   ADMM iteration at Chebyshev degree d: t1 5, grad t1 2, t2 4, d 4;
#   Chebyshev head (c_K grad^T d 4, M(u0) 7, r and v 2) 13; each of its
#   d - 1 steps 12 (M(v) 7: two differences, their divergence 3, scale,
#   add; x, r, v 5); update 26 (u 1, x_proj 2, z_proj 2, x_dual 2, z_dual
#   4, prox_g 4, shrink 11).  Residual norms 35, the dual rescale of a
#   multichunk's chunk 3.
ROF_ITER_OPS, ROF_NORM_OPS = 26, 42
ADMM_NORM_OPS, ADMM_RESCALE_OPS = 35, 3
#   Multilabel, per label of a pixel: primal step 8 (K^T y 4, step 4:
#   u - tau K^T y - tau f, max), dual step 19 (gradient 2, label sum 1, two
#   extrapolations 10, squared norm 4, scaling 2); per pixel: ball scale 3,
#   multiplier step 7.  Once per chunk and label: tau f 1.  Seed of a
#   launch 3 per label.  Residual norms 44 per label and 13 per pixel.
ML_ITER_OPS, ML_PIXEL_OPS, ML_SEED_OPS, ML_CHUNK_OPS = 27, 10, 3, 1
ML_NORM_OPS, ML_NORM_PIXEL_OPS = 44, 13
# Config 3 (bench.py build_multilabel, examples/example_multilabel_fast.py)
ML_SIZE, ML_LABELS, ML_LMB = 256, 8, 0.5
# The simplex multilabel model (config 3's problem with the simplex in g)
# against config 3's fused energy, after 2000 iterations each: the same
# convex problem, each run short of the optimum by its own distance.  On
# an H100 the simplex run ends 3.6e-3 below config 3's energy, and its own
# lower bound (``ml_dual_energy``) shows config 3's run at least 3.5e-3
# above the optimum (808.85 after 4000 iterations against 812.76), so the
# two are held within 5e-3, and the simplex run's own gap within 1e-2 of
# its energy (5.7e-3 after 2000 iterations, 1.3e-3 after 4000;
# tools/zoo_probe.py).
SIMPLEX_ML_RTOL, SIMPLEX_GAP_RTOL = 5e-3, 1e-2
SIMPLEX_TOL = 1e-5   # every pixel's u on the simplex (f32 sort and sums)
ML_LARGE = 512  # the size at which the JAX package bands the ml kernels
#   Deblur (T taps; n pixels of the image, m2 of the full convolution):
#   seed: B x (2T - 1) per m2 pixel, grad x 2 per n.  Iteration: primal
#   step 2T + 5 per n (B^T yv 2T - 1, the masked adjoint 4, step 2); dual
#   step 2T + 11 per m2 (B x 2T - 1, the data term's conjugate prox 12) and
#   18 per n (gradient 2, extrapolations 8, ball projection 8).  Residual
#   norms 14 per m2 and 4T + 40 per n (two K^T y 4T + 6).
# Config 2 (bench.py build_deblur, examples/example_deblurring.py)
DB_SIZE, DB_KLEN, DB_LMB, DB_LARGE = 512, 9, 100.0, 2048
#   Tight (L labels, k pairs, T taps of P^T; per pixel): seed 3L + 2T - 1;
#   iteration 22L + 22k + 4T + 6 (primal 9 per label; dual: v and p 7 per
#   pair plane, ball 8 per pair, q 6 per gradient plane, the kron products
#   2 per tap each way, s 7 and the label sum); residual norms 44L + 46k
#   + 4T + 13.
# bench.py build_tight (tight128x4)
TIGHT_SIZE, TIGHT_LABELS, TIGHT_LMB, TIGHT_LARGE = 128, 4, 1.0, 512
#   Volumetric TV, per voxel: seed 3 (grad3 u); iteration 36 (primal: K^T q
#   5, step 2, data term 3; dual: grad3 3, extrapolations 12, ball
#   projection 11); residual norms 59 (two K^T y 10, z_hat 21, pd 6, w_hat
#   4, dd 2, squares 12, sums 4).
VOL_SEED_OPS, VOL_ITER_OPS, VOL_NORM_OPS = 3, 36, 59
# bench.py build_vol (vol256x8), and the size at which the JAX package bands
# the vol kernels
VOL_SIZE, VOL_LABELS, VOL_LMB, VOL_LARGE = 256, 8, 6.0, 512
# the multichunk checks' stopping tolerance: boyd adapts and converges
# partway through the launch at every shape (in chunk 3 of 8 at 256x256x8,
# 4 at 190x250x5, 2 at 64x96x1; plain version on a CPU)
VOL_MC_TOL = 5e-3
# bench.py build_ensemble (ensemble1024x128, BASELINE config 5): B ROF
# instances of the procedural image, each with its own 0.05 noise and lmb
# from uniform(4, 32), drawn in turn from RandomState(42); timed over
# ENS_ITERS iterations after ENS_WARM (the warm-up ends on a chunk boundary,
# so the timed run is ENS_ITERS / 10 batched chunks and nothing else)
ENS_B, ENS_SIZE, ENS_WARM, ENS_ITERS = 1024, 128, 21, 1000
ENS_SAMPLES = (0, 511, 1023)  # instances held against single solves
# the multilabel and vol ensembles: B instances of config 3 and vol256x8,
# each with its own noise (0.05 on the cow's gray levels, vol256x8's own
# slices drawn from RandomState(42 + b)); the deblur and tight ensembles:
# B frames of config 2 and B instances of tight128x4, each with its own
# noise (0.01 on the blurred flowers, 0.05 on the junction's gray levels)
# drawn in turn from one RandomState(42)
SMALL_ENS_B, SMALL_ENS_ITERS = 8, 300
# the ROF ensemble of 4-megapixel frames: B instances of 2048x2048 built as
# ensemble1024x128's (the procedural image, each with its own 0.05 noise and
# lmb), the size at which the JAX package bands each instance (row 7); no
# cluster holds one, so its chunks take the batched tiled launch
LARGE_ENS_B, LARGE_ENS_SIZE = 4, 2048
# The halo chunks (slice 8a): the bands' owned-row norms summed against the
# whole-plane kernel's norms, the same squares summed in another order
# (the thread blocks of an extended band group other rows).
HALO_NORM_RTOL = 1e-6
# BASELINE config 1 (bench.py, the main path's ROF model)
ROF_SIZE, ROF_LMB = 512, 16.0
# The dual ROF on block.sparse: iterations of its solve (goldstein,
# residual_iter 100, as example_rof_dual.py).  Config 1's primal solve
# ends 1.2e-3 above the optimum after its 2000 iterations (its certified
# gap is 1.7e-3), so the dual's energy is not held within ENERGY_RTOL of
# it: the dual solve's own gap is, and on an H100 it takes 4000 iterations
# to get there (1.7e-4 of the energy after 2000, 3.9e-5 after 4000, 1.1e-5
# after 8000; tools/zoo_probe.py).  Its apply and adjoint on the card against BlockGradient2D's
# (the same differences summed in CSR order against a stencil: a few f32
# ulp of max(1, |out|)).
DUAL_ROF_ITERS = 4000
SPARSE_TOL = 1e-5
# The factories' proxes and blocks on the card against the CPU (f32, of
# max(1, |out|)): closed forms; solvers (eigh, Cholesky, the polyhedral
# epigraph's sweeps)
ZOO_TOL, ZOO_EIGH_TOL = 1e-5, 1e-4
HALO_SHARDS = (1, 2, 4)
# An instance of a deblur or tight ensemble against its single-instance
# fused solve: the batched kernels are the single-instance ones instance by
# instance (bit-equal), so only the host's vmapped generic steps and
# adaptation can round differently.
SINGLE_RTOL = 1e-6


def admm_iter_ops(degree):
    return 54 + 12 * (degree - 1)


def ml_chunk_ops(n, L, ri, chunks=1):
    """FP32 operations of a multilabel launch of ``chunks`` chunks of
    ``ri`` iterations on an (L, n)-pixel stack."""
    return n * (L * ML_SEED_OPS + chunks * (
        ri * (L * ML_ITER_OPS + ML_PIXEL_OPS)
        + L * (ML_CHUNK_OPS + ML_NORM_OPS) + ML_NORM_PIXEL_OPS))


def vol_chunk_ops(nvox, ri, chunks=1):
    """FP32 operations of a volumetric launch of ``chunks`` chunks of
    ``ri`` iterations on ``nvox`` voxels."""
    return nvox * (VOL_SEED_OPS + chunks * (ri * VOL_ITER_OPS + VOL_NORM_OPS))


def single_launches(mod):
    """The launch counts of a route module's single-instance kernels (its
    batched and halo chunks, if it has them, run on the ensemble and the
    sharded paths only; the ROF and ADMM chunks' and multichunks' tiled
    launches, counted also under their wrappers, on the planes no
    grid-resident band holds only)."""
    return {k: v for k, v in mod.launch_counts.items()
            if not k.endswith(("_batched", "_halo", "_tiled"))}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def test_image(nx, ny, seed=42):
    """The procedural ROF test image of bench.py (seed 42, noise 0.05),
    recomputed with numpy: the script reads no image file and needs no
    image library."""
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, nx)
    xx, yy = np.meshgrid(x, np.linspace(0, 1, ny), indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(nx, ny)).astype(np.float32)


def cow_gray(ny, nx):
    """data/cow.png's gray levels at (ny, nx) (config 3's image)."""
    return fixture_gray("cow", ny, nx)


def ml_unaries(gray, L):
    """Quadratic unaries against L evenly spaced gray levels, label
    outermost, as examples/example_multilabel_fast.py builds them from a
    (ny, nx) image: (L, ny, nx) transposed to (L, nx, ny), flattened."""
    means = np.linspace(0, 1, L)
    f = np.stack([(gray - m) ** 2 for m in means], axis=0)
    return f.transpose(0, 2, 1).reshape(-1).astype(np.float32)


def ml_model(nx, ny, L, f, lmb):
    """The fast multilabel relaxation of example_multilabel_fast.py:
    u >= 0 with unaries f, the per-pixel 2L-ball of radius lmb on grad u,
    and the sum-to-one multiplier s."""
    import prost_tpu_torch as ptt

    n = nx * ny
    u = ptt.Variable(n * L)
    q = ptt.Variable(2 * n * L)
    s = ptt.Variable(n)
    prob = ptt.MinMaxProblem([u], [q, s])
    prob.add_function(u, ptt.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, ptt.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, ptt.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, ptt.block.sparse_kron_id(np.ones((1, L)), n))
    return prob


def ml_energy(u, f, lmb, L, nx, ny):
    """<u, f> + lmb sum_px ||(grad u)_px||_2 over all 2L gradient
    components, in float64 (tests/oracles.py multilabel_energy)."""
    u = u.reshape(L, nx, ny).astype(np.float64)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    tv = np.sum(np.sqrt(np.sum(gx ** 2 + gy ** 2, axis=0)))
    return float(u.reshape(-1) @ f.astype(np.float64) + lmb * tv)


def ml_dual_energy(q, f, lmb, L, nx, ny):
    """The lower bound of the multilabel problem with the simplex in g at
    the dual q clipped to its per-pixel 2L-ball of radius lmb:
    sum_px min_l (f + K^T q)_l, in float64 (no energy of a u on the
    simplex can undercut it)."""
    p = q.reshape(2, L, nx, ny).astype(np.float64)
    norm = np.sqrt(np.sum(p ** 2, axis=(0, 1)))
    p = p * np.minimum(1.0, lmb / np.maximum(norm, 1e-300))[None, None]
    ktq = f.reshape(L, nx, ny).astype(np.float64).copy()
    ktq[:, 1:] += p[0, :, :-1]
    ktq[:, :-1] -= p[0, :, :-1]
    ktq[:, :, 1:] += p[1, :, :, :-1]
    ktq[:, :, :-1] -= p[1, :, :, :-1]
    return float(np.sum(np.min(ktq, axis=0)))


def deblur_chunk_ops(n, m2, T, ri):
    """FP32 operations of one deblur chunk of ``ri`` iterations."""
    return (m2 * (2 * T - 1) + 2 * n + ri * (n * (2 * T + 23)
                                             + m2 * (2 * T + 11))
            + 14 * m2 + n * (4 * T + 40))


def tight_chunk_ops(n, L, k, T, ri):
    """FP32 operations of one tight chunk of ``ri`` iterations."""
    return n * (3 * L + 2 * T - 1 + ri * (22 * L + 22 * k + 4 * T + 6)
                + 44 * L + 46 * k + 4 * T + 13)


def motion_kernel(klen=DB_KLEN):
    """bench.py's 45-degree motion blur, (ky, kx): 7 nonzero taps at 9x9."""
    kern = np.zeros((klen, klen))
    c = (klen - 1) / 2
    t = np.deg2rad(45.0)
    for i in np.linspace(-c, c, 4 * klen):
        kern[int(round(c + i * np.sin(t))), int(round(c + i * np.cos(t)))] = 1
    return kern / kern.sum()


def asym_kernel(k=5):
    """tests/test_fused_deblur.py's 5x5 blur: a diagonal and one corner."""
    ker = np.zeros((k, k))
    for i in range(k):
        ker[i, i] = 1.0
    ker[0, k - 1] = 0.5
    return ker / ker.sum()


def deblur_frames(B, nx, ny, seed=42):
    """Config 2's observation as bench.py makes it, for B frames:
    data/flowers.png's gray levels at (nx, ny), fully convolved with the
    motion blur, plus each frame's own 0.01 randn drawn in turn from one
    RandomState(seed); (B, nx2 * ny2)."""
    from scipy.signal import convolve2d

    rng = np.random.RandomState(seed)
    blurred = convolve2d(fixture_gray("flowers", nx, ny), motion_kernel(),
                         mode="full")
    return np.stack([(blurred + 0.01 * rng.randn(*blurred.shape)).reshape(-1)
                     for _ in range(B)])


def deblur_data(nx, ny, seed=42):
    """Config 2's observation (the first of ``deblur_frames``); flat."""
    return deblur_frames(1, nx, ny, seed)[0]


def deblur_model(nx, ny, fb, lmb=DB_LMB):
    """TV deblurring in the constrained form of bench.py's config 2:
    min lmb/2 |v - fb|^2 + |g|_{2,1} s.t. v = B u, g = grad u."""
    import prost_tpu_torch as ptt

    kern = motion_kernel()
    n = nx * ny
    u = ptt.Variable(n)
    v = ptt.Variable(fb.size)
    g = ptt.Variable(2 * n)
    prob = ptt.MinProblem([u], [v, g])
    prob.add_function(v, ptt.function.sum_1d("square", 1, fb, lmb))
    prob.add_function(g, ptt.function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, ptt.block.conv2d(nx, ny, 1, kern))
    prob.add_constraint(u, g, ptt.block.gradient2d(nx, ny, 1))
    return prob


def deblur_energy(u, fb, lmb, nx, ny):
    """lmb/2 |B u - fb|^2 + TV(u) in float64."""
    from scipy.signal import convolve2d

    u = u.reshape(nx, ny).astype(np.float64)
    bu = convolve2d(u, motion_kernel().T, mode="full").reshape(-1)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:-1] = u[1:] - u[:-1]
    gy[:, :-1] = u[:, 1:] - u[:, :-1]
    return 0.5 * lmb * np.sum((bu - fb) ** 2) + np.sum(
        np.sqrt(gx ** 2 + gy ** 2))


def pair_matrix(L):
    """P of examples/example_multilabel_tight.py, (2k, 2L)."""
    k = L * (L - 1) // 2
    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i], P[idx, j] = 1.0, -1.0
            P[idx + k, i + L], P[idx + k, j + L] = 1.0, -1.0
            idx += 1
    return P


def tight_unaries(nx, ny, L, gray=None):
    """bench.py build_tight's unaries: (junction_gray - m)^2 against L
    evenly spaced gray levels, the image at (nx, ny) (or ``gray``), label
    outermost."""
    if gray is None:
        gray = fixture_gray("junction_gray", nx, ny)
    return np.stack([(gray - m) ** 2 for m in np.linspace(0, 1, L)],
                    axis=0).reshape(-1).astype(np.float32)


def tight_ensemble_unaries(B, seed=42):
    """The unaries of B instances of tight128x4, each on the gray levels
    plus its own 0.05 randn, drawn in turn from one RandomState(seed)."""
    rng = np.random.RandomState(seed)
    gray = fixture_gray("junction_gray", TIGHT_SIZE, TIGHT_SIZE)
    return [tight_unaries(TIGHT_SIZE, TIGHT_SIZE, TIGHT_LABELS,
                          gray + 0.05 * rng.randn(*gray.shape))
            for _ in range(B)]


def tight_model(nx, ny, L, f, lmb=TIGHT_LMB):
    """The tight multilabel relaxation of bench.py build_tight."""
    import prost_tpu_torch as ptt

    n, k = nx * ny, L * (L - 1) // 2
    u, v = ptt.Variable(n * L), ptt.Variable(2 * n * k)
    q, p, s = ptt.Variable(2 * n * L), ptt.Variable(2 * n * k), ptt.Variable(n)
    prob = ptt.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, ptt.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, ptt.function.sum_norm2(2, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, ptt.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, ptt.block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, ptt.block.identity())
    prob.add_dual_pair(v, q, ptt.block.sparse_kron_id(pair_matrix(L).T, n))
    return prob


def tight_measures(x, f, lmb, L, nx, ny):
    """(<u, f> + lmb sum |v_pair|, |grad u + kron(P^T, I) v|, max |sum_l
    u_l - 1|) in float64."""
    n, k = nx * ny, L * (L - 1) // 2
    x = x.astype(np.float64)
    u, v = x[:n * L].reshape(L, nx, ny), x[n * L:].reshape(2 * k, n)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    r = np.concatenate([gx.reshape(L, n), gy.reshape(L, n)])
    r += pair_matrix(L).T @ v
    energy = float(u.reshape(-1) @ f.astype(np.float64) + lmb * np.sum(
        np.sqrt(v[:k] ** 2 + v[k:] ** 2)))
    return (energy, float(np.sqrt(np.sum(r ** 2))),
            float(np.max(np.abs(u.reshape(L, n).sum(axis=0) - 1.0))))


def vol_data(L, nx, ny, seed=42):
    """bench.py build_vol's observation: data/dog.png's gray levels at (nx,
    ny), each of the L slices with its own 0.02 randn, drawn in turn from
    RandomState(seed); (L, nx, ny) flattened, f32."""
    rng = np.random.RandomState(seed)
    base = fixture_gray("dog", nx, ny)
    return np.stack([base + 0.02 * rng.randn(nx, ny) for _ in range(L)]
                    ).reshape(-1).astype(np.float32)


def vol_model(nx, ny, L, f, lmb=VOL_LMB):
    """Volumetric TV of examples/example_vol_tv.py: lmb/2 |u - f|^2 +
    |grad3 u|_{2,1}, grad3 = gradient3d."""
    import prost_tpu_torch as ptt

    n = L * nx * ny
    u = ptt.Variable(n)
    q = ptt.Variable(3 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, ptt.function.conjugate(
        ptt.function.sum_norm2(3, False, "abs")))
    prob.add_dual_pair(u, q, ptt.block.gradient3d(nx, ny, L))
    return prob


def vol_energy(u, f, lmb, L, nx, ny):
    """lmb/2 |u - f|^2 + sum over voxels of |(gx, gy, gl)|_2 in float64,
    the label difference Dirichlet (gl of the last slice is -u)."""
    u = u.reshape(L, nx, ny).astype(np.float64)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    gl = np.concatenate([u[1:], np.zeros_like(u[:1])]) - u
    return float(0.5 * lmb * np.sum((u.reshape(-1) - f) ** 2)
                 + np.sum(np.sqrt(gx ** 2 + gy ** 2 + gl ** 2)))


def kernel_inputs(nx, ny, seed, dev):
    import torch

    rng = np.random.RandomState(seed)
    x = rng.rand(nx, ny).astype(np.float32)
    q = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
    f = rng.rand(nx, ny).astype(np.float32)
    w = (rng.rand(nx, ny) > 0.3).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, q, f, w)]


def max_errs(out, ref, n_planes=4):
    """Largest abs error over the planes, largest rel error over the rest."""
    import torch

    plane = max(float(torch.max(torch.abs(a - b)))
                for a, b in zip(out[:n_planes], ref[:n_planes]))
    rel = 0.0
    for a, b in zip(out[n_planes:], ref[n_planes:]):
        d = torch.abs(a.double() - b.double())
        rel = max(rel, float(torch.max(d / torch.clamp(torch.abs(b.double()),
                                                        min=1e-30))))
    return plane, rel


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(old, new, reps):
    """``time_ms`` of two callables doing the same work in turns, old, new,
    new, old, in one process on one card: ((old 1, old 2), (new 1, new
    2))."""
    t = [time_ms(fn, reps) for fn in (old, new, new, old)]
    return (t[0], t[3]), (t[1], t[2])


def csrc_kernel_names():
    """The names of the package's hand-written CUDA kernels, in the sources
    and in the headers they share."""
    import os
    import re

    from prost_tpu_torch.ops import cuda_build

    names = set()
    for fname in os.listdir(cuda_build.CSRC):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(cuda_build.CSRC, fname)) as fh:
                names |= set(re.findall(r"__global__\s+void\s+(?:__launch_"
                                        r"bounds__\([^)]*\)\s+)?(\w+)",
                                        fh.read()))
    return names


def kernel_name(raw):
    """A profiler event's kernel name without its namespace and arguments:
    "void (anonymous namespace)::admm_rhs(State, ...)" -> admm_rhs."""
    name = raw.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip().split(" ")[-1]


def traced_call(fn, tries=40):
    """What one call of ``fn`` runs on the card, from torch.profiler's
    trace of the call (after one untraced call): the hand-written kernels
    it launches, in order ("csrc"), their device ms summed ("csrc_ms"), and
    the device ms and count of every other kernel, PyTorch's copies, fills
    and arithmetic around them ("torch_ms", "torch_kernels").  A trace
    that caught no hand-written kernel is taken again, up to ``tries``
    times: late in a long run the card's tracer can lose a contiguous part
    of the device events in more than half of its traces, whatever idle
    time the trace's window holds around the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = csrc_kernel_names()
    fn()
    torch.cuda.synchronize()
    events = []
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if any(kernel_name(e.name) in ours for e in events):
            break
    if attempt:
        print(f"traced_call: {attempt} traces before the last caught no "
              "hand-written kernel")
    mine = [e for e in events if kernel_name(e.name) in ours]
    other = [e for e in events if kernel_name(e.name) not in ours]
    return {"csrc": [kernel_name(e.name) for e in mine],
            "csrc_ms": sum(e.time_range.elapsed_us() for e in mine) * 1e-3,
            "torch_ms": sum(e.time_range.elapsed_us() for e in other) * 1e-3,
            "torch_kernels": len(other)}


def traced_until(fn, done, tries=40):
    """``traced_call`` of ``fn`` until ``done(its kernel names)`` holds, at
    most ``tries`` times: the first trace that holds, else the fullest,
    with "lost" set and its device ms None (not measured).  A trace that
    lost a call's first kernels but kept a later one (a tiled launch
    beside its finish) is one that ``traced_call``'s own retries do not
    see."""
    best = None
    for attempt in range(tries):
        t = traced_call(fn)
        if done(t["csrc"]):
            if attempt:
                print(f"traced_until: {attempt} traces lost kernels of the "
                      f"call before one named {t['csrc'][:6]}")
            return dict(t, lost=False)
        if best is None or len(t["csrc"]) > len(best["csrc"]):
            best = t
    print(f"traced_until: all {tries} traces lost kernels of the call, the "
          f"fullest named {best['csrc'][:6]}: its device ms not measured")
    return dict(best, lost=True, csrc_ms=None, torch_ms=None)


def fmt_ms(ms):
    """A traced device time for a printed line ("not measured" where every
    trace lost kernels of the call)."""
    return "not measured" if ms is None else f"{ms:.4f}"


def counted(mod, fn):
    """The wrapper counts (``mod.launch_counts``) that one call of ``fn``
    adds: what the call launched on the card, whatever a trace caught."""
    import torch

    before = dict(mod.launch_counts)
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in mod.launch_counts.items()
            if v != before[k]}


def csrc_launches(fn, done=None):
    """The hand-written kernels that one call of ``fn`` launches on the
    card, in order, and their device ms summed (``traced_call``; with
    ``done``, ``traced_until``)."""
    t = traced_call(fn) if done is None else traced_until(fn, done)
    return t["csrc"], t["csrc_ms"]


def timed(row, fn, reps, done=None, mod=None):
    """A kernel row's timing of ``fn``, one call of its wrapper: ``ms``
    (``time_ms`` over ``reps`` calls) and ``traced`` (``traced_call``; with
    ``done``, ``traced_until``); with ``mod``, also ``counted`` (the
    counts of ``mod.launch_counts`` that one call adds)."""
    row["ms"] = time_ms(fn, reps)
    row["traced"] = traced_call(fn) if done is None else traced_until(fn,
                                                                      done)
    if mod is not None:
        row["counted"] = counted(mod, fn)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``ops`` FP32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from prost_tpu_torch.ops import cuda_build

    names = ("fused_rof", "fused_admm", "fused_multilabel", "fused_deblur",
             "fused_tight", "fused_vol")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        built = dict(zip(names, pool.map(cuda_build.load, names)))
    print(f"build: {len(names)} libraries in {time.perf_counter() - t0:.2f} "
          "s wall")
    for name, lib in built.items():
        print(f"build: {name}.cu nvcc {lib.seconds:.2f} s ({lib.path}; "
              "compiler report beside it)")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def phase_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_rof as fr

    rows = {"rof_chunk": {"err": 0.0, "ms": None, "plain_ms": None},
            "rof_multichunk": {"err": 0.0, "ms": None, "plain_ms": None}}
    seed = 0
    for nx, ny in ((512, 512), (2048, 1536)):
        for dataterm in ("square", "wsquare", "abs"):
            x, q, f, w = kernel_inputs(nx, ny, seed, dev)
            seed += 1
            q[0, -1, :] = 0.0
            q[1, :, -1] = 0.0
            scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
            out = fr.rof_chunk(x, q, f, w, scal, 10, dataterm)
            ref = fr.rof_chunk_plain(x, q, f, w, scal, 10, dataterm)
            torch.cuda.synchronize()
            plane, rel = max_errs(out, ref)
            resident = fr.resident_ok(nx, ny, dataterm,
                                      *fr.card_limits(dev))
            check(resident == ((nx, ny) == (512, 512)),
                  f"rof_chunk {nx}x{ny}: the shape rule took the wrong path")
            print(f"rof_chunk {nx}x{ny} {dataterm} "
                  f"({'resident' if resident else 'tiled'}): max abs "
                  f"err planes {plane:.3e} (tol {PLANE_ATOL:g}), max rel err "
                  f"norms {rel:.3e} (tol {NORM_RTOL:g})")
            check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
                  f"rof_chunk {nx}x{ny} {dataterm} disagrees with its "
                  "plain version")
            check(all(bool(torch.isfinite(t).all()) for t in out),
                  "rof_chunk produced non-finite values")
            rows["rof_chunk"]["err"] = max(rows["rof_chunk"]["err"], plane)
            if (nx, ny) == (512, 512) and dataterm == "square":
                timed(rows["rof_chunk"], 
                    lambda: fr.rof_chunk(x, q, f, w, scal, 10, dataterm), 50)
                rows["rof_chunk"]["plain_ms"] = time_ms(
                    lambda: fr.rof_chunk_plain(x, q, f, w, scal, 10,
                                               dataterm), 10)

    consts = (np.sqrt(2 * 512 * 512), np.sqrt(512 * 512), 1.5, 0.95, 1.05,
              0.8)
    # a solve's start: x = f = the test image, q = 0; with tolerance 2e-3
    # boyd adapts four times and converges in chunk 7 of 8
    x = torch.from_numpy(test_image(512, 512)).to(dev)
    q = torch.zeros((2, 512, 512), device=dev)
    w = torch.ones_like(x)
    for stepsize, tol in (("alg1", 0.0), ("boyd", 2e-3)):
        scal = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                             tol, tol, tol, tol], device=dev)
        out = fr.rof_multichunk(x, q, x, w, scal, 10, 8, "square", stepsize,
                                consts)
        ref = fr.rof_multichunk_plain(x, q, x, w, scal, 10, 8, "square",
                                      stepsize, consts)
        torch.cuda.synchronize()
        plane, rel = max_errs(out, ref)
        print(f"rof_multichunk 512x512 {stepsize}: max abs err planes "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms+scalars "
              f"{rel:.3e} (tol {NORM_RTOL:g}); sout kernel "
              f"{out[5].tolist()} plain {ref[5].tolist()}")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"rof_multichunk {stepsize} disagrees with its plain version")
        rows["rof_multichunk"]["err"] = max(rows["rof_multichunk"]["err"],
                                            plane)
        if stepsize == "alg1":  # all 8 chunks run
            timed(rows["rof_multichunk"], 
                lambda: fr.rof_multichunk(x, q, x, w, scal, 10, 8, "square",
                                          stepsize, consts), 20)
            rows["rof_multichunk"]["plain_ms"] = time_ms(
                lambda: fr.rof_multichunk_plain(x, q, x, w, scal, 10, 8,
                                                "square", stepsize, consts),
                3)
            rows["rof_multichunk"]["bound"] = bound(
                10 * 512 * 512 * 4,
                8 * 512 * 512 * (10 * ROF_ITER_OPS + ROF_NORM_OPS))

    # row 5 of the kernel table: the plane the JAX package bands
    nx = ny = 2048
    x = torch.from_numpy(test_image(nx, ny)).to(dev)
    q = torch.zeros((2, nx, ny), device=dev)
    w = torch.ones_like(x)
    consts = (np.sqrt(2 * nx * ny), np.sqrt(nx * ny), 1.5, 0.95, 1.05, 0.8)
    scal = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                         0.0, 0.0, 0.0, 0.0], device=dev)
    out = fr.rof_multichunk(x, q, x, w, scal, 10, 8, "square", "alg1",
                            consts)
    ref = fr.rof_multichunk_plain(x, q, x, w, scal, 10, 8, "square", "alg1",
                                  consts)
    torch.cuda.synchronize()
    plane, rel = max_errs(out, ref)
    check(not fr.resident_ok(nx, ny, "square", *fr.card_limits(dev, True),
                             True),
          f"rof_multichunk {nx}x{ny}: the shape rule made it resident")
    print(f"rof_multichunk {nx}x{ny} alg1 (tiled): max abs err planes "
          f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms+scalars "
          f"{rel:.3e} (tol {NORM_RTOL:g})")
    check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
          "rof_multichunk 2048x2048 disagrees with its plain version")
    rows["rof_multichunk"]["err"] = max(rows["rof_multichunk"]["err"], plane)

    # rof_chunk's timed call: square, 512x512, ri 10; x, q, f in and x, q,
    # x_prev, q_prev out
    rows["rof_chunk"]["bound"] = bound(
        10 * 512 * 512 * 4, 512 * 512 * (10 * ROF_ITER_OPS + ROF_NORM_OPS))
    for name, r in rows.items():
        print(f"{name} 512x512: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})")
    return rows


def admm_kernel_inputs(nx, ny, seed, dev):
    """The seven ADMM state arrays (mass on the dead z coordinates, which
    both versions zero at entry), f and w."""
    import torch

    rng = np.random.RandomState(seed)
    arrs = [rng.rand(nx, ny) for _ in range(3)]
    arrs += [0.3 * rng.randn(2, nx, ny) for _ in range(3)]
    arrs += [0.1 * rng.randn(nx, ny), rng.rand(nx, ny),
             rng.rand(nx, ny) > 0.3]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def phase_admm_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_admm as fa

    rows = {"admm_chunk": {"err": 0.0}, "admm_multichunk": {"err": 0.0}}
    ri, alpha, degree = 10, 1.7, 10
    seed = 100
    for nx in (512, 2048):
        for dataterm in ("square", "wsquare", "abs"):
            for deg in (degree, None):
                *planes, f, w = admm_kernel_inputs(nx, nx, seed, dev)
                seed += 1
                scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
                tols = 1e-3 / torch.arange(1, ri + 1, device=dev,
                                           dtype=torch.float32) ** 1.3
                out = fa.admm_chunk(*planes, f, w, scal, tols, ri, 10, alpha,
                                    dataterm, deg)
                ref = fa.admm_chunk_plain(*planes, f, w, scal, tols, ri, 10,
                                          alpha, dataterm, deg)
                torch.cuda.synchronize()
                plane, rel = max_errs(out, ref, n_planes=7)
                tol = PLANE_ATOL if deg else CGLS_PLANE_ATOL
                mode = f"cheby{deg}" if deg else "cgls"
                print(f"admm_chunk {nx}x{nx} {dataterm} {mode}: max abs err "
                      f"planes {plane:.3e} (tol {tol:g}), max rel err norms "
                      f"{rel:.3e} (tol {NORM_RTOL:g})")
                check(plane <= tol and rel <= NORM_RTOL,
                      f"admm_chunk {nx}x{nx} {dataterm} {mode} disagrees "
                      "with its plain version")
                check(all(bool(torch.isfinite(t).all()) for t in out),
                      "admm_chunk produced non-finite values")
                rows["admm_chunk"]["err"] = max(rows["admm_chunk"]["err"],
                                                plane)
                if nx == 512 and dataterm == "square" and deg:
                    timed(rows["admm_chunk"], 
                        lambda: fa.admm_chunk(*planes, f, w, scal, None, ri,
                                              10, alpha, dataterm, deg), 50)
                    rows["admm_chunk"]["plain_ms"] = time_ms(
                        lambda: fa.admm_chunk_plain(*planes, f, w, scal,
                                                    None, ri, 10, alpha,
                                                    dataterm, deg), 5)

    # a solve's start (x_half = f = the test image, the rest zero); with
    # tolerance 2e-3 rho adapts and the launch converges in chunk 7
    nx = ny = 512
    n = nx * ny
    f = torch.from_numpy(test_image(nx, ny)).to(dev)
    zero = torch.zeros_like(f)
    z = torch.zeros((2, nx, ny), device=dev)
    planes = [f, zero, zero, z, z, z, zero]
    consts = (np.sqrt(2 * n), np.sqrt(n), 0.8, 1.01)
    check(fa.admm_resident_ok(nx, ny, "square", *fa.admm_card_limits(dev)),
          f"admm_multichunk {nx}x{ny}: the shape rule streams")
    for tol in (0.0, 2e-3):
        scal = torch.tensor([1.0, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0,
                             tol, tol, tol, tol], device=dev)
        out = fa.admm_multichunk(*planes, f, f, scal, ri, 8, alpha, degree,
                                 consts)
        ref = fa.admm_multichunk_plain(*planes, f, f, scal, ri, 8, alpha,
                                       degree, consts)
        torch.cuda.synchronize()
        plane, nrel = max_errs(out[:8], ref[:8], n_planes=7)
        _, srel = max_errs(out[7:], ref[7:], n_planes=1)
        print(f"admm_multichunk {nx}x{ny} tol {tol:g} (resident path): max "
              f"abs err planes {plane:.3e} (tol {PLANE_ATOL:g}), max rel "
              f"err norms {nrel:.3e} (tol {MC_NORM_RTOL:g}), scalars "
              f"{srel:.3e} (tol "
              f"{NORM_RTOL:g}); sout kernel {out[8].tolist()} plain "
              f"{ref[8].tolist()}")
        check(plane <= PLANE_ATOL and nrel <= MC_NORM_RTOL
              and srel <= NORM_RTOL,
              f"admm_multichunk tol {tol:g} disagrees with its plain version")
        check(out[8][4:].tolist() == ref[8][4:].tolist(),
              "admm_multichunk's converged flag or chunk count disagrees")
        if tol > 0:
            check(float(out[8][0]) != 1.0, "rho did not adapt")
        rows["admm_multichunk"]["err"] = max(rows["admm_multichunk"]["err"],
                                             plane)
        if tol == 0.0:  # all 8 chunks run
            timed(rows["admm_multichunk"], 
                lambda: fa.admm_multichunk(*planes, f, f, scal, ri, 8, alpha,
                                           degree, consts), 20)
            rows["admm_multichunk"]["plain_ms"] = time_ms(
                lambda: fa.admm_multichunk_plain(*planes, f, f, scal, ri, 8,
                                                 alpha, degree, consts), 3)
            chunks = int(out[8][5])
            # xh, xp, xd, zh, zd, warm, f in (z_proj is only written) and
            # the seven state arrays out: 19 planes
            rows["admm_multichunk"]["bound"] = bound(
                19 * n * 4, chunks * n * (ri * admm_iter_ops(degree)
                                          + ADMM_NORM_OPS
                                          + ADMM_RESCALE_OPS))
    rows["admm_chunk"]["bound"] = bound(
        19 * n * 4, n * (ri * admm_iter_ops(degree) + ADMM_NORM_OPS))
    for name, r in rows.items():
        print(f"{name} 512x512: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})")
    return rows


def ml_kernel_inputs(L, nx, ny, seed, dev):
    """u, q, s, f of a multilabel chunk (mass on the dead q coordinates,
    which both versions zero at entry)."""
    import torch

    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(2 * L, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def phase_ml_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_multilabel as fm

    rows = {"ml_chunk": {"err": 0.0}, "ml_multichunk": {"err": 0.0}}
    ri = 10
    for seed, (L, nx, ny) in enumerate(((ML_LABELS, ML_SIZE, ML_SIZE),
                                        (5, 250, 190),
                                        (ML_LABELS, ML_LARGE, ML_LARGE))):
        n = nx * ny
        shape = f"{nx}x{ny}x{L}"
        u, q, s, f = ml_kernel_inputs(L, nx, ny, 200 + seed, dev)
        scal = torch.tensor([0.9, 1.1, 1.0, ML_LMB, 1.0], device=dev)
        out = fm.ml_chunk(u, q, s, f, scal, ri)
        ref = fm.ml_chunk_plain(u, q, s, f, scal, ri)
        torch.cuda.synchronize()
        plane, rel = max_errs(out, ref, n_planes=6)
        path = fm.ml_pick_route(None, L, nx, ny, dev, False, "ml_chunk")[0]
        check(path == ("tiled" if nx == ML_LARGE else "resident"),
              f"ml_chunk {shape}: the shape rule chose {path}")
        print(f"ml_chunk {shape} ({path} path): max abs err planes "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
              f"{rel:.3e} (tol {NORM_RTOL:g})")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"ml_chunk {shape} disagrees with its plain version")
        check(all(bool(torch.isfinite(t).all()) for t in out),
              "ml_chunk produced non-finite values")
        rows["ml_chunk"]["err"] = max(rows["ml_chunk"]["err"], plane)
        if nx == ML_SIZE:
            timed(rows["ml_chunk"], 
                lambda: fm.ml_chunk(u, q, s, f, scal, ri), 50)
            rows["ml_chunk"]["plain_ms"] = time_ms(
                lambda: fm.ml_chunk_plain(u, q, s, f, scal, ri), 10)
            # u, q, s, f in (4L + 1 planes); new and previous u, q, s out
            # (6L + 2)
            rows["ml_chunk"]["bound"] = bound(
                (10 * L + 3) * n * 4, ml_chunk_ops(n, L, ri))

        # a solve's start on the cow's unaries: u = q = s = 0; at
        # tolerance 5e-3 both rules adapt, and at 256x256x8 boyd converges
        # in chunk 6 of 8 (plain version on a CPU)
        f = torch.from_numpy(ml_unaries(cow_gray(ny, nx), L)).to(dev)
        f = f.reshape(L, nx, ny)
        u = torch.zeros_like(f)
        q = torch.zeros((2 * L, nx, ny), device=dev)
        s = torch.zeros((nx, ny), device=dev)
        consts = (np.sqrt(2 * n * L + n), np.sqrt(n * L), 1.5, 0.95, 1.05,
                  0.8)
        for stepsize, tol in (("boyd", 0.0), ("boyd", 5e-3),
                              ("goldstein", 5e-3)):
            scal = torch.tensor([1.0, 1.0, 1.0, ML_LMB, 1.0, 0.5, 0.0, 0.0,
                                 1.0, tol, tol, tol, tol], device=dev)
            out = fm.ml_multichunk(u, q, s, f, scal, ri, 8, stepsize, consts)
            ref = fm.ml_multichunk_plain(u, q, s, f, scal, ri, 8, stepsize,
                                         consts)
            torch.cuda.synchronize()
            plane, nrel = max_errs(out[:7], ref[:7], n_planes=6)
            _, srel = max_errs(out[6:], ref[6:], n_planes=1)
            print(f"ml_multichunk {shape} {stepsize} tol {tol:g}: max abs "
                  f"err planes {plane:.3e} (tol {PLANE_ATOL:g}), max rel err "
                  f"norms {nrel:.3e} (tol {MC_NORM_RTOL:g}), scalars "
                  f"{srel:.3e} (tol {NORM_RTOL:g}); sout kernel "
                  f"{out[7].tolist()} plain {ref[7].tolist()}")
            check(plane <= PLANE_ATOL and nrel <= MC_NORM_RTOL
                  and srel <= NORM_RTOL,
                  f"ml_multichunk {shape} {stepsize} tol {tol:g} disagrees "
                  "with its plain version")
            check(out[7][5:].tolist() == ref[7][5:].tolist(),
                  "ml_multichunk's converged flag or chunk count disagrees")
            rows["ml_multichunk"]["err"] = max(rows["ml_multichunk"]["err"],
                                               plane)
            if nx == ML_SIZE and stepsize == "boyd" and tol > 0:
                check(out[7][5] == 1.0 and out[7][6] < 8,
                      "ml_multichunk did not converge partway")
            if nx == ML_SIZE and tol == 0.0:  # all 8 chunks run
                timed(rows["ml_multichunk"], 
                    lambda: fm.ml_multichunk(u, q, s, f, scal, ri, 8,
                                             stepsize, consts), 20)
                rows["ml_multichunk"]["plain_ms"] = time_ms(
                    lambda: fm.ml_multichunk_plain(u, q, s, f, scal, ri, 8,
                                                   stepsize, consts), 3)
                rows["ml_multichunk"]["bound"] = bound(
                    (10 * L + 3) * n * 4,
                    ml_chunk_ops(n, L, ri, int(out[7][6])))
    for name, r in rows.items():
        print(f"{name} {ML_SIZE}x{ML_SIZE}x{ML_LABELS}: kernel {r['ms']:.4f} "
              f"ms/call, plain {r['plain_ms']:.4f} ms/call, bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows


def rof_energy(u, f, lmb, nx, ny):
    """Primal ROF energy lmb/2 ||u - f||^2 + TV(u) in float64."""
    u = u.reshape(nx, ny).astype(np.float64)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:-1] = u[1:] - u[:-1]
    gy[:, :-1] = u[:, 1:] - u[:, :-1]
    return 0.5 * lmb * np.sum((u - f.reshape(nx, ny)) ** 2) + np.sum(
        np.sqrt(gx ** 2 + gy ** 2))


def rof_dual_energy(y, f, lmb, nx, ny):
    """Dual ROF energy <f, K^T p> - ||K^T p||^2 / (2 lmb) at p = y clipped
    to the unit ball, in float64 (the gap certificate of
    example_rof_pdgap)."""
    p = y.reshape(2, nx, ny).astype(np.float64)
    p = p / np.maximum(np.sqrt(p[0] ** 2 + p[1] ** 2), 1.0)[None]
    ktp = np.zeros((nx, ny))
    ktp[1:] += p[0, :-1]
    ktp[:-1] -= p[0, :-1]
    ktp[:, 1:] += p[1, :, :-1]
    ktp[:, :-1] -= p[1, :, :-1]
    return float(np.sum(f.reshape(nx, ny) * ktp)
                 - np.sum(ktp ** 2) / (2.0 * lmb))


def rof_model(nx, ny, f, lmb):
    """ROF denoising in the saddle-point form of bench.py's config 1."""
    import prost_tpu_torch as ptt

    n = nx * ny
    u = ptt.Variable(n)
    q = ptt.Variable(2 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, ptt.function.conjugate(
        ptt.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, 1))
    return prob


def recording(kind, opts, generic=None, rof_path=None, admm_path=None,
              deblur_path=None, ml_path=None, tight_path=None,
              vol_path=None):
    """``Backend(kind, opts)`` as a user gets it from ``backend_pdhg`` /
    ``backend_admm`` (or, with ``generic``, that generic backend class),
    recording after every callback epoch the devices of the solver state's
    tensors and the time spent iterating; with ``rof_path``
    (``admm_path``, ``deblur_path``, ``ml_path``, ``tight_path``,
    ``vol_path``), the fused ROF route's (fused Chebyshev ADMM route's,
    fused deblur route's, fused multilabel route's, fused tight route's,
    fused volumetric route's) light calls made beforehand on that path."""
    import torch

    from prost_tpu_torch.modeling import Backend

    class Recorded(Backend):
        def create(self, problem, solver_opts):
            if generic is not None:
                b = generic(problem, self.opts, solver_opts)
            else:
                b = super().create(problem, solver_opts)
            if rof_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_rof as fr
                from prost_tpu_torch.ops.phases import K_CHUNKS

                ri, dev = max(int(self.opts.residual_iter), 1), ptt.device()
                b.rof["call"] = fr.ROFChunk(b.rof, ri, dev, path=rof_path)
                b.rof["multi"] = fr.ROFMultichunk(
                    b.rof, ri, K_CHUNKS, self.opts.stepsize, dev,
                    path=rof_path)
            if admm_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_admm as fa
                from prost_tpu_torch.ops.phases import K_CHUNKS

                o, dev = b.run_opts, ptt.device()
                ri = max(int(o.residual_iter), 1)
                b.rof["chunk"] = fa.ADMMChunk(b.rof, ri, o.alpha,
                                              o.cheby_degree, dev,
                                              path=admm_path)
                b.rof["call"] = fa.ADMMMultichunk(
                    b.rof, ri, K_CHUNKS, o.alpha, o.cheby_degree, dev,
                    path=admm_path)
            if deblur_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_deblur as fd

                ri = max(int(self.opts.residual_iter), 1)
                b.deblur["call"] = fd.DeblurChunk(b.deblur, ri, ptt.device(),
                                                  path=deblur_path)
            if ml_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_multilabel as fm
                from prost_tpu_torch.ops.phases import K_CHUNKS

                ri, dev = max(int(self.opts.residual_iter), 1), ptt.device()
                b.ml["call"] = fm.MLChunk(b.ml, ri, dev, path=ml_path)
                b.ml["multi"] = fm.MLMultichunk(
                    b.ml, ri, K_CHUNKS, self.opts.stepsize, dev,
                    path=ml_path)
            if tight_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_tight as ft

                ri = max(int(self.opts.residual_iter), 1)
                b.tight["call"] = ft.TightChunk(b.tight, ri, ptt.device(),
                                                path=tight_path)
            if vol_path is not None:
                import prost_tpu_torch as ptt
                from prost_tpu_torch.ops import fused_vol as fv
                from prost_tpu_torch.ops.phases import K_CHUNKS

                ri, dev = max(int(self.opts.residual_iter), 1), ptt.device()
                b.vol["call"] = fv.VolChunk(b.vol, ri, dev, path=vol_path)
                b.vol["multi"] = fv.VolMultichunk(
                    b.vol, ri, K_CHUNKS, self.opts.stepsize, dev,
                    path=vol_path)
            self.made, self.devices, self.loop_s = b, set(), 0.0
            run = b.run

            def run_and_record(state, until, start):
                t0 = time.perf_counter()
                state = run(state, until, start)
                torch.cuda.synchronize()
                self.loop_s += time.perf_counter() - t0
                self.devices |= {v.device.type for v in vars(state).values()
                                 if isinstance(v, torch.Tensor)}
                return state

            b.run = run_and_record
            return b

    return Recorded(kind, opts)


def timed_solve(backend, nx, ny, f, lmb, max_iters, num_cback_calls=10,
                tol=1e-5):
    """Solve the ROF model through ``backend`` (made by ``recording``)."""
    return run_model(backend, rof_model(nx, ny, f, lmb), nx * ny, max_iters,
                     num_cback_calls, tol)


def run_model(backend, prob, ncols, max_iters, num_cback_calls=10,
              tol=1e-5):
    """Solve the modeling-layer problem ``prob`` with ``ncols`` primal
    entries through ``backend`` (made by ``recording``): (result, backend,
    solve() wall seconds).  Fails if any tensor of the solver state left
    the card or the result is not finite."""
    import torch

    import prost_tpu_torch as ptt

    opts = ptt.options(max_iters=max_iters, num_cback_calls=num_cback_calls,
                       verbose=False, tol_rel_primal=tol, tol_rel_dual=tol,
                       tol_abs_primal=tol, tol_abs_dual=tol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ptt.solve(prob, backend, opts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(backend.devices == {"cuda"},
          f"the solver state left the card: {backend.devices}")
    check(res.x.shape == (ncols,) and np.all(np.isfinite(res.x))
          and np.all(np.isfinite(res.y)), "non-finite or misshapen result")
    return res, backend, dt


def rates(res, backend, dt):
    return (f"{res.result.value} after {res.iterations} iterations; solve() "
            f"{dt:.4f} s with set-up, iterating {backend.loop_s:.4f} s = "
            f"{res.iterations / backend.loop_s:.1f} it/s")


def phase_solve(card):
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.ops import fused_rof as fr

    nx = ny = 512
    n = nx * ny
    lmb = 16.0
    f = test_image(nx, ny).reshape(-1)

    def run(generic, max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10),
                            BackendPDHG if generic else None)
        return timed_solve(backend, nx, ny, f, lmb, max_iters)

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    fr.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = single_launches(fr)
    check(backend.made.rof is not None, "the fused route was not taken")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    e_fused = rof_energy(res.x, f, lmb, nx, ny)
    d_fused = rof_dual_energy(res.y, f, lmb, nx, ny)
    gap = (e_fused - d_fused) / n
    print(f"fused solve 512x512: {rates(res, backend, dt)}; energy "
          f"{e_fused:.8f}, gap/px {gap:.3e} (tol {GAP_PER_PX:g}), launches "
          f"{launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    e_gen = rof_energy(gres.x, f, lmb, nx, ny)
    rel = abs(e_fused - e_gen) / abs(e_gen)
    print(f"generic solve 512x512: {rates(gres, gbackend, gdt)}; energy "
          f"{e_gen:.8f} [{card}]")
    print(f"energy fused vs generic: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g})")
    check(rel <= ENERGY_RTOL, "fused and generic energies disagree")
    check(0.0 <= gap <= GAP_PER_PX, "primal-dual gap too large")
    return launches, e_fused, d_fused


def phase_admm_solve(card, e_pdhg, d_pdhg):
    from prost_tpu_torch.backend import ADMMOptions, BackendADMM
    from prost_tpu_torch.ops import fused_admm as fa

    nx = ny = 512
    n = nx * ny
    lmb = 16.0
    f = test_image(nx, ny).reshape(-1)

    def run(projection, max_iters):
        """The fused route (``backend_admm``'s) for projection None, else
        the generic BackendADMM with that projection."""
        if projection is None:
            backend = recording("admm", ADMMOptions(residual_iter=10))
        else:
            backend = recording("admm", ADMMOptions(
                residual_iter=10, projection=projection), BackendADMM)
        return timed_solve(backend, nx, ny, f, lmb, max_iters)

    run(None, 200)  # warm-up of the three routes
    run("cheby", 20)
    run("cgls", 20)

    fa.reset_launch_counts()
    res, backend, dt = run(None, 2000)
    launches = single_launches(fa)
    check(backend.made.mode == "cheby",
          f"the fused Chebyshev route was not taken: {backend.made.mode}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    e_fused = rof_energy(res.x, f, lmb, nx, ny)
    gap = (e_fused - rof_dual_energy(res.y, f, lmb, nx, ny)) / n
    print(f"fused ADMM solve 512x512: {rates(res, backend, dt)}; energy "
          f"{e_fused:.8f}, gap/px {gap:.3e}, launches {launches} [{card}]")

    for projection in ("cheby", "cgls"):
        gres, gbackend, gdt = run(projection, 2000)
        e_gen = rof_energy(gres.x, f, lmb, nx, ny)
        rel = abs(e_fused - e_gen) / abs(e_gen)
        print(f"generic ADMM ({projection}) solve 512x512: "
              f"{rates(gres, gbackend, gdt)}; energy {e_gen:.8f}, rel diff "
              f"to fused {rel:.3e} [{card}]")
        if projection == "cheby":
            print(f"energy fused vs generic ADMM (cheby): rel diff "
                  f"{rel:.3e} (tol {ENERGY_RTOL:g})")
            check(rel <= ENERGY_RTOL,
                  "fused and generic ADMM energies disagree")
    rel = abs(e_fused - e_pdhg) / abs(e_pdhg)
    print(f"energy ADMM vs PDHG: {e_fused:.8f} vs {e_pdhg:.8f}, rel diff "
          f"{rel:.3e} (tol {ADMM_VS_PDHG_RTOL:g}); PDHG dual energy "
          f"{d_pdhg:.8f}")
    check(rel <= ADMM_VS_PDHG_RTOL, "ADMM and PDHG energies disagree")
    check(e_fused >= d_pdhg, "ADMM energy below the PDHG dual energy")
    return launches, e_fused


def phase_ml_solve(card):
    """BASELINE config 3 at 256x256x8 on the cow, fused and generic."""
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.ops import fused_multilabel as fm

    nx = ny = ML_SIZE
    L, n = ML_LABELS, ML_SIZE * ML_SIZE
    f = ml_unaries(cow_gray(ny, nx), L)

    def run(generic, max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10),
                            BackendPDHG if generic else None)
        return run_model(backend, ml_model(nx, ny, L, f, ML_LMB), n * L,
                         max_iters)

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    fm.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = single_launches(fm)
    check(backend.made.ml is not None, "the fused multilabel route was not "
          "taken")
    check(all(v > 0 for v in launches.values()),
          f"a multilabel kernel of the path was not launched: {launches}")
    e_fused = ml_energy(res.x, f, ML_LMB, L, nx, ny)
    unity = float(np.max(np.abs(res.x.reshape(L, n).sum(axis=0) - 1.0)))
    check(backend.made.ml["call"].resident,
          "config 3's chunks did not take the resident path")
    print(f"fused multilabel solve {nx}x{ny}x{L} (resident path): "
          f"{rates(res, backend, dt)}; "
          f"energy {e_fused:.8f}, max |sum_l u_l - 1| {unity:.3e}, "
          f"launches {launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    e_gen = ml_energy(gres.x, f, ML_LMB, L, nx, ny)
    g_unity = float(np.max(np.abs(gres.x.reshape(L, n).sum(axis=0) - 1.0)))
    rel = abs(e_fused - e_gen) / abs(e_gen)
    print(f"generic multilabel solve {nx}x{ny}x{L}: "
          f"{rates(gres, gbackend, gdt)}; energy {e_gen:.8f}, max "
          f"|sum_l u_l - 1| {g_unity:.3e} [{card}]")
    print(f"energy fused vs generic multilabel: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g})")
    check(rel <= ENERGY_RTOL, "fused and generic multilabel energies "
          "disagree")
    return launches, e_fused


def sparse_gradient(nx, ny):
    """gradient2d's forward differences (Neumann boundary) as a scipy
    matrix, spmat_gradient2d.m as examples/example_rof_dual.py builds it."""
    import scipy.sparse as sp

    dy = sp.spdiags(np.vstack([np.r_[-np.ones(ny - 1), 0], np.ones(ny)]),
                    [0, 1], ny, ny)
    dy = sp.kron(sp.eye(nx), dy)
    dx = sp.spdiags(np.vstack([np.r_[-np.ones(ny * (nx - 1)), np.zeros(ny)],
                               np.ones(nx * ny)]), [0, ny], nx * ny, nx * ny)
    return sp.vstack([dx, dy]).tocsc()


def rof_dual_model(nx, ny, f, lmb):
    """The dual of ``rof_model``'s ROF as examples/example_rof_dual.py
    poses it: min over (q, w = -grad^T q, a ``block.sparse``) of
    I(||q_i|| <= 1) + 1/(2 lmb) ||w + lmb f||^2; u is the dual variable of
    the constraint, q the dual p of ``rof_model``."""
    import prost_tpu_torch as ptt

    n = nx * ny
    q, w = ptt.Variable(2 * n), ptt.Variable(n)
    prob = ptt.MinProblem([q], [w])
    prob.add_function(q, ptt.function.sum_norm2(2, False, "ind_leq0", 1, 1,
                                                1))
    prob.add_function(w, ptt.function.sum_1d("square", 1, -f * lmb,
                                             1 / lmb))
    prob.add_constraint(q, w, ptt.block.sparse(-sparse_gradient(nx, ny).T))
    return prob


def simplex_ml_model(nx, ny, L, f, lmb):
    """Config 3's convex problem with the simplex in g: the unaries and
    the simplex indicator (``transform(sum_ind_simplex, d=f)``), the
    per-pixel 2L-ball of radius lmb on grad u, and no sum-to-one dual."""
    import prost_tpu_torch as ptt

    n = nx * ny
    u, q = ptt.Variable(n * L), ptt.Variable(2 * n * L)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.transform(
        ptt.function.sum_ind_simplex(L, False), 1, 0, 1, f))
    prob.add_function(q, ptt.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, L))
    return prob


def device_busy(work):
    """``work()`` under torch.profiler: (device ms, wall ms, the three
    kernels with the most device ms).  The tracer adds host time to every
    launch, so device ms over wall ms is a lower bound of the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.name)[:40]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() * 1e-3)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3]
    return sum(by_kernel.values()), wall, top


def generic_route(backend):
    """Whether ``backend`` (made by ``recording``) runs the generic PDHG:
    no fused route matched the problem."""
    b = backend.made
    return (b.rof, b.ml, b.deblur, b.tight, b.vol) == (None,) * 5


def print_busy(label, work, card):
    device_ms, wall_ms, top = device_busy(work)
    print(f"{label}: traced wall {wall_ms:.4f} ms, device {device_ms:.4f} "
          f"ms, busy share {device_ms / wall_ms:.4f}; top kernels "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in top) + f" [{card}]")


def phase_dual_rof_solve(card, e_pdhg, d_pdhg, nx=ROF_SIZE):
    """The dual of config 1's ROF (lmb 16, the procedural image) on a
    ``block.sparse`` -grad^T at full width, through ``pt.solve`` and the
    generic PDHG (goldstein, residual_iter 100, as example_rof_dual.py),
    u recovered with ``get_all_variables``; first the sparse block on the
    card against BlockGradient2D."""
    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch._native import host
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.common import tree_to
    from prost_tpu_torch.linop import BlockGradient2D

    ny, n, lmb = nx, nx * nx, ROF_LMB
    f = test_image(nx, ny).reshape(-1)
    print(f"host runtime native: {host.available()} [{card}]")
    check(host.available(), "the native host runtime did not build")

    dev = ptt.device()
    t0 = time.perf_counter()
    blk, _ = ptt.block.sparse(-sparse_gradient(nx, ny).T)(0, 0, n, 2 * n)
    create_s = time.perf_counter() - t0
    blk = tree_to(blk, dev)
    grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    rng = np.random.RandomState(0)
    p = torch.as_tensor(rng.randn(2 * n), dtype=torch.float32, device=dev)
    u = torch.as_tensor(rng.randn(n), dtype=torch.float32, device=dev)
    errs = []
    for out, ref in ((blk.apply(p), -grad.apply_adjoint(p)),
                     (blk.apply_adjoint(u), -grad.apply(u))):
        errs.append(float(torch.max(torch.abs(out - ref)
                                    / torch.clamp(torch.abs(ref), min=1.0))))
    same = (torch.equal(blk.apply(p), blk.apply(p))
            and torch.equal(blk.apply_adjoint(u), blk.apply_adjoint(u)))
    ms = [time_ms(fn, 50) for fn in (lambda: blk.apply(p),
                                     lambda: grad.apply_adjoint(p),
                                     lambda: blk.apply_adjoint(u),
                                     lambda: grad.apply(u))]
    print(f"block.sparse -grad^T {nx}x{ny} ({blk.vals_f.numel()} nonzeros, "
          f"made in {create_s:.4f} s on the host): apply vs -K^T err "
          f"{errs[0]:.3e}, adjoint vs -K err {errs[1]:.3e} (tol "
          f"{SPARSE_TOL:g} of max(1, |out|)); two applies bit-equal: {same}; "
          f"apply {ms[0]:.4f} ms (BlockGradient2D adjoint {ms[1]:.4f}), "
          f"adjoint {ms[2]:.4f} ms (BlockGradient2D apply {ms[3]:.4f}) "
          f"[{card}]")
    check(max(errs) <= SPARSE_TOL, "block.sparse disagrees with gradient2d")
    check(same, "two block.sparse applies on the card differ")

    def run(max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="goldstein",
                                                residual_iter=100))
        return run_model(backend, rof_dual_model(nx, ny, f, lmb), 2 * n,
                         max_iters, tol=1e-7)

    run(200)  # warm-up
    res, backend, dt = run(DUAL_ROF_ITERS)
    check(generic_route(backend), "a fused route took the dual ROF")
    uv = ptt.Variable(n)
    ptt.get_all_variables(res, (), (), (uv,), ())
    e_dual = rof_energy(uv.val, f, lmb, nx, ny)
    d_dual = rof_dual_energy(res.x, f, lmb, nx, ny)
    gap_rel = (e_dual - d_dual) / e_dual
    rel = (e_dual - e_pdhg) / e_pdhg
    print(f"dual ROF solve {nx}x{ny} on block.sparse (generic PDHG, "
          f"goldstein): {rates(res, backend, dt)}; energy of u {e_dual:.8f}, "
          f"its own gap {e_dual - d_dual:.6f} = {gap_rel:.3e} relative (tol "
          f"{ENERGY_RTOL:g}); vs the primal solve's energy {e_pdhg:.8f}: "
          f"{rel:+.3e} relative, its dual energy {d_pdhg:.8f} [{card}]")
    print_busy(f"dual ROF solve {nx}x{ny}, 200 iterations",
               lambda: run(200), card)
    check(gap_rel <= ENERGY_RTOL, "the dual ROF solve's own gap is above "
          "ENERGY_RTOL")
    check(d_pdhg <= e_dual <= e_pdhg * (1 + ENERGY_RTOL),
          "the dual ROF energy is outside [the primal solve's dual energy, "
          "its energy]")
    return e_dual


def phase_simplex_ml_solve(card, e_ml, nx=ML_SIZE):
    """Config 3's problem with the simplex in g (``simplex_ml_model``) at
    full width, through ``pt.solve`` and the generic PDHG (boyd,
    residual_iter 10; the fused multilabel route must not take it), held
    against config 3's fused energy and its own lower bound, and on the
    simplex."""
    from prost_tpu_torch.backend import PDHGOptions

    ny, L, n = nx, ML_LABELS, nx * nx
    f = ml_unaries(cow_gray(ny, nx), L)

    def run(max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10))
        return run_model(backend, simplex_ml_model(nx, ny, L, f, ML_LMB),
                         n * L, max_iters)

    run(200)  # warm-up
    res, backend, dt = run(2000)
    check(backend.made.ml is None and generic_route(backend),
          "a fused route took the simplex multilabel model")
    e = ml_energy(res.x, f, ML_LMB, L, nx, ny)
    d = ml_dual_energy(res.y, f, ML_LMB, L, nx, ny)
    u = res.x.reshape(L, n).astype(np.float64)
    off = max(float(np.max(np.abs(u.sum(axis=0) - 1.0))),
              float(max(0.0, -u.min())))
    rel = (e - e_ml) / e_ml
    print(f"simplex multilabel solve {nx}x{ny}x{L} (generic PDHG, boyd): "
          f"{rates(res, backend, dt)}; energy {e:.8f} vs config 3's fused "
          f"{e_ml:.8f}: {rel:+.3e} relative (tol {SIMPLEX_ML_RTOL:g}); "
          f"its lower bound {d:.8f}, own gap {(e - d) / e:.3e} relative (tol "
          f"{SIMPLEX_GAP_RTOL:g}); distance from the simplex {off:.3e} (tol "
          f"{SIMPLEX_TOL:g}) [{card}]")
    print_busy(f"simplex multilabel solve {nx}x{ny}x{L}, 200 iterations",
               lambda: run(200), card)
    check(abs(rel) <= SIMPLEX_ML_RTOL, "the simplex multilabel energy "
          "disagrees with config 3's")
    check(0.0 <= e - d <= SIMPLEX_GAP_RTOL * e,
          "the simplex multilabel solve's own gap is too large")
    check(off <= SIMPLEX_TOL, "a pixel's u is off the simplex")
    return e


def sparse_range_matrix(rng):
    """A 12x3 scipy CSR matrix of full column rank, about half zeros."""
    import scipy.sparse as sp

    a = rng.randn(12, 3)
    a[np.abs(a) < 0.7] = 0.0
    a[:3] += np.eye(3)
    return sp.csr_matrix(a)


def zoo_registries():
    """Every factory of tests/test_modeling.py:153-200, both registries,
    with the JAX test's sizes (and ``ind_range`` of a sparse A as well):
    [(name, factory, size, tolerance)] of
    ``function`` and [(name, factory, nrows, ncols, tolerance)] of
    ``block``.  Tolerances (f32, of max(1, |out|), card against CPU):
    ZOO_TOL for the closed forms; ZOO_EIGH_TOL where a solver decomposes
    (eigh, Cholesky) or iterates (the polyhedral epigraph's sweeps, whose
    stop can fall a sweep apart), since the card's solver and LAPACK
    round otherwise."""
    import prost_tpu_torch as ptt

    fn, bl = ptt.function, ptt.block
    r = np.random.RandomState(2)
    K = np.random.RandomState(3).randn(4, 6)
    closed, solver = ZOO_TOL, ZOO_EIGH_TOL
    functions = [
        ("zero", fn.zero(), 12, closed),
        ("sum_1d", fn.sum_1d("huber", alpha=0.5), 12, closed),
        ("sum_norm2", fn.sum_norm2(3, False, "abs"), 12, closed),
        ("sum_ind_simplex", fn.sum_ind_simplex(4, False), 12, closed),
        ("sum_ind_sum", fn.sum_ind_sum(4, False), 12, closed),
        ("sum_ind_sum2", fn.sum_ind_sum2(3, [0, 1, 2, 3, 4, 5], 1.0), 12,
         closed),
        ("sum_ind_soc", fn.sum_ind_soc(6, False), 12, closed),
        ("sum_ind_halfspace", fn.sum_ind_halfspace(4, False, np.ones(4),
                                                   1.0), 12, closed),
        ("sum_ind_epi_quad", fn.sum_ind_epi_quad(4, False, 1.0, np.zeros(3),
                                                 0.0), 12, closed),
        ("sum_ind_epi_polyhedral", fn.sum_ind_epi_polyhedral(
            3, False, np.tile([1.0, -1.0, 0.5, 2.0], 4),
            np.tile([0.1, 0.2], 4), np.full(4, 2), np.arange(4) * 2), 12,
         solver),
        ("sum_eigen_2x2", fn.sum_eigen_2x2(False, "ind_geq0"), 16, closed),
        ("sum_eigen_3x3", fn.sum_eigen_3x3(False, "abs"), 18, solver),
        ("sum_eigen_nxn", fn.sum_eigen_nxn(4, False, "square"), 32, solver),
        ("sum_singular_nx2", fn.sum_singular_nx2(6, False, "sum_1d:abs"), 12,
         closed),
        ("sum_mass_norm", fn.sum_mass_norm(4, False), 12, solver),
        ("sum_ind_comass_ball", fn.sum_ind_comass_ball(5, False), 20,
         solver),
        ("ind_range", fn.ind_range(r.randn(12, 3)), 12, solver),
        ("ind_range (sparse A)", fn.ind_range(sparse_range_matrix(r)), 12,
         solver),
        ("conjugate", fn.conjugate(fn.sum_1d("abs")), 12, closed),
        ("transform", fn.transform(fn.sum_1d("abs"), 2.0, 1.0), 12, closed),
        ("permute", fn.permute(fn.sum_1d("abs"), np.arange(12)[::-1]), 12,
         closed),
    ]
    blocks = [
        ("sparse", bl.sparse(K), 4, 6, closed),
        ("dense", bl.dense(K), 4, 6, closed),
        ("diags", bl.diags(5, 5, [1.0, -2.0], [0, 1]), 5, 5, closed),
        ("identity", bl.identity(), 7, 7, closed),
        ("zero", bl.zero(), 4, 9, closed),
        ("gradient2d", bl.gradient2d(4, 5, 2), 80, 40, closed),
        ("gradient3d", bl.gradient3d(4, 5, 2), 120, 40, closed),
        ("sparse_kron_id", bl.sparse_kron_id(K, 3), 12, 18, closed),
        ("dense_kron_id", bl.dense_kron_id(K, 3), 12, 18, closed),
        ("id_kron_sparse", bl.id_kron_sparse(K, 3), 12, 18, closed),
        ("id_kron_dense", bl.id_kron_dense(K, 3), 12, 18, closed),
    ]
    return functions, blocks


def phase_zoo(card):
    """Every factory of both registries evaluated through ``eval_prox``
    and ``eval_linop`` on the card and on the CPU from the same seeded
    input, each pair held within its tolerance (``zoo_registries``)."""
    import prost_tpu_torch as ptt

    functions, blocks = zoo_registries()
    card_dev = ptt.device()

    def both(evaluate):
        """(card result, CPU result) of ``evaluate()``."""
        try:
            out = evaluate()
            ptt.set_device("cpu")
            return out, evaluate()
        finally:
            ptt.set_device(card_dev)

    def err(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))

    worst = []
    for name, factory, size, tol in functions:
        rng = np.random.RandomState(7)
        arg, tau_diag = rng.randn(size), 0.5 + rng.rand(size)
        (out, ms), (ref, _) = both(
            lambda: ptt.eval_prox(factory, arg, 0.7, tau_diag))
        e = err(out, ref)
        worst.append((e / tol, f"function.{name}"))
        print(f"eval_prox {name} ({size}): card vs CPU {e:.3e} (tol "
              f"{tol:g}), {ms:.4f} ms on the card")
        check(np.all(np.isfinite(out)) and e <= tol,
              f"function.{name}: card and CPU disagree")
    for name, factory, m, n, tol in blocks:
        for adjoint in (False, True):
            x = np.random.RandomState(8).randn(m if adjoint else n)
            (out, ms), (ref, _) = both(lambda: (
                lambda r: (np.concatenate(r[:3]), r[3]))(
                    ptt.eval_linop([(factory, 0, 0, m, n)], x, adjoint)))
            e = err(out, ref)
            worst.append((e / tol, f"block.{name}"))
            print(f"eval_linop {name} ({m}x{n}{', adjoint' if adjoint else ''}"
                  f"): card vs CPU {e:.3e} (tol {tol:g}), {ms:.4f} ms on "
                  "the card")
            check(np.all(np.isfinite(out)) and e <= tol,
                  f"block.{name}: card and CPU disagree")
    share, name = max(worst)
    print(f"zoo: {len(functions)} function and {len(blocks)} block "
          f"cases, card vs CPU within tolerance (closest: {name} at "
          f"{share:.3f} of its tolerance) [{card}]")


def scaled_errs(out, ref, n_planes):
    """Largest abs error over the planes relative to max(1, |plane|max),
    and largest norm error relative to max(|norm|, the largest norm): the
    deblur route's dual variable norm is zero in exact arithmetic (its
    prox_g is zero), so only a floor at the other norms' scale can hold
    its rounding noise."""
    import torch

    plane = max(float(torch.max(torch.abs(a - b)))
                / max(1.0, float(torch.max(torch.abs(b))))
                for a, b in zip(out[:n_planes], ref[:n_planes]))
    d = torch.abs(out[n_planes].double() - ref[n_planes].double())
    ref_abs = torch.abs(ref[n_planes].double())
    rel = float(torch.max(d / torch.clamp(ref_abs, min=float(ref_abs.max()))))
    return plane, rel


def phase_deblur_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd

    row = {"err": 0.0}
    ri = 10
    cases = ((DB_SIZE, DB_SIZE, motion_kernel()),
             (250, 190, asym_kernel()),
             (DB_LARGE, DB_LARGE, motion_kernel()))
    for seed, (nx, ny, kern) in enumerate(cases):
        taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
        nx2, ny2 = nx + kern.shape[1] - 1, ny + kern.shape[0] - 1
        rng = np.random.RandomState(300 + seed)
        arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2),
                0.3 * rng.randn(2, nx, ny), rng.rand(nx2, ny2),
                0.5 + rng.rand(nx2, ny2))
        x, yv, q, fb, sv = [torch.from_numpy(a.astype(np.float32)).to(dev)
                            for a in arrs]
        scal = torch.tensor([0.9, 1.1, 1.0, DB_LMB, 1.0], device=dev)
        args = (x, yv, q, fb, sv, scal, ri, taps, 0.5, 0.2)
        out = fd.deblur_chunk(*args)
        ref = fd.deblur_chunk_plain(*args)
        torch.cuda.synchronize()
        plane, rel = scaled_errs(out, ref, 6)
        shape = f"{nx}x{ny} ({len(taps)} taps)"
        path = fd.deblur_pick_route(None, nx2, ny, ny2, taps, dev,
                                    "deblur_chunk")[0]
        check(path == ("tiled" if nx == DB_LARGE else "resident"),
              f"deblur_chunk {shape}: the shape rule chose {path}")
        print(f"deblur_chunk {shape} ({path} path): max abs err planes / "
              f"max(1, |plane|) {plane:.3e} (tol {PLANE_ATOL:g}), max rel "
              f"err norms {rel:.3e} (tol {NORM_RTOL:g}, floor at the "
              "largest)")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"deblur_chunk {shape} disagrees with its plain version")
        check(all(bool(torch.isfinite(t).all()) for t in out),
              "deblur_chunk produced non-finite values")
        row["err"] = max(row["err"], plane)
        if nx == DB_SIZE:
            timed(row, lambda: fd.deblur_chunk(*args), 50)
            row["plain_ms"] = time_ms(lambda: fd.deblur_chunk_plain(*args),
                                      10)
            n, m2, T = nx * ny, nx2 * ny2, len(taps)
            # x, yv, q, fb, sv, taps in; new and previous x, yv, q out
            row["bound"] = bound((9 * n + 5 * m2 + 3 * T) * 4,
                                 deblur_chunk_ops(n, m2, T, ri))
    print(f"deblur_chunk {DB_SIZE}x{DB_SIZE}: kernel {row['ms']:.4f} ms/call, "
          f"plain {row['plain_ms']:.4f} ms/call, bound "
          f"{row['bound'][0]:.5f} ms ({row['bound'][1]})")
    return {"deblur_chunk": row}


def tight_kernel_inputs(L, nx, ny, seed, dev):
    """u, v, q (with mass on its boundary coordinates), p, s and f of a
    tight chunk on ``dev``, the example's taps for L labels and its
    constant preconditioner: (planes, taps, consts)."""
    import torch

    k = L * (L - 1) // 2
    pt_ = pair_matrix(L).T
    taps = tuple((r, m, float(pt_[r, m])) for r in range(2 * L)
                 for m in range(2 * k) if pt_[r, m] != 0.0)
    consts = tuple(float(np.float32(c))
                   for c in (1 / (L + 1), 1.0, 1 / L, 0.2, 1 / 3))
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.2 * rng.randn(2 * L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return ([torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs],
            taps, consts)


def phase_tight_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_tight as ft

    row = {"err": 0.0}
    ri = 10
    for seed, (L, nx, ny) in enumerate(((TIGHT_LABELS, TIGHT_SIZE,
                                         TIGHT_SIZE), (3, 250, 190),
                                        (TIGHT_LABELS, TIGHT_LARGE,
                                         TIGHT_LARGE))):
        k = L * (L - 1) // 2
        state, taps, consts = tight_kernel_inputs(L, nx, ny, 400 + seed, dev)
        scal = torch.tensor([0.9, 1.1, 1.0, TIGHT_LMB, 1.0], device=dev)
        args = (*state, scal, ri, taps, consts)
        out = ft.tight_chunk(*args)
        ref = ft.tight_chunk_plain(*args)
        torch.cuda.synchronize()
        plane, rel = scaled_errs(out, ref, 10)
        shape = f"{nx}x{ny}x{L}"
        print(f"tight_chunk {shape}: max abs err planes / max(1, |plane|) "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
              f"{rel:.3e} (tol {NORM_RTOL:g}, floor at the largest)")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"tight_chunk {shape} disagrees with its plain version")
        check(all(bool(torch.isfinite(t).all()) for t in out),
              "tight_chunk produced non-finite values")
        row["err"] = max(row["err"], plane)
        if nx == TIGHT_SIZE:
            timed(row, lambda: ft.tight_chunk(*args), 50)
            row["plain_ms"] = time_ms(lambda: ft.tight_chunk_plain(*args),
                                      10)
            n, T = nx * ny, len(taps)
            # u, v, q, p, s, f, taps in; new and previous state out
            row["bound"] = bound(((10 * L + 12 * k + 3) * n + 4 * T
                                  + 2 * L + 2 * k + 2) * 4,
                                 tight_chunk_ops(n, L, k, T, ri))
    print(f"tight_chunk {TIGHT_SIZE}x{TIGHT_SIZE}x{TIGHT_LABELS}: kernel "
          f"{row['ms']:.4f} ms/call, plain {row['plain_ms']:.4f} ms/call, "
          f"bound {row['bound'][0]:.5f} ms ({row['bound'][1]})")
    return {"tight_chunk": row}


def phase_vol_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_vol as fv

    rows = {"vol_chunk": {"err": 0.0}, "vol_multichunk": {"err": 0.0}}
    ri = 10
    cases = ((VOL_LABELS, VOL_SIZE, VOL_SIZE, ("square",)),
             (5, 190, 250, ("square", "wsquare", "abs")),
             (1, 64, 96, ("square",)),
             (VOL_LABELS, VOL_LARGE, VOL_LARGE, ("square",)))
    for seed, (L, nx, ny, dataterms) in enumerate(cases):
        nvox = L * nx * ny
        shape = f"{nx}x{ny}x{L}"
        # mass on the dead q coordinates, which both versions zero at entry
        rng = np.random.RandomState(500 + seed)
        arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(3, L, nx, ny),
                rng.rand(L, nx, ny), 2.0 * (rng.rand(L, nx, ny) > 0.3))
        u, q, f, w = [torch.from_numpy(a.astype(np.float32)).to(dev)
                      for a in arrs]
        scal = torch.tensor([0.9, 1.1, 1.0, VOL_LMB, 1.0], device=dev)
        for dataterm in dataterms:
            out = fv.vol_chunk(u, q, f, w, scal, ri, dataterm)
            ref = fv.vol_chunk_plain(u, q, f, w, scal, ri, dataterm)
            torch.cuda.synchronize()
            plane, rel = max_errs(out, ref)
            print(f"vol_chunk {shape} {dataterm}: max abs err planes "
                  f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
                  f"{rel:.3e} (tol {NORM_RTOL:g})")
            check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
                  f"vol_chunk {shape} {dataterm} disagrees with its plain "
                  "version")
            check(all(bool(torch.isfinite(t).all()) for t in out),
                  "vol_chunk produced non-finite values")
            rows["vol_chunk"]["err"] = max(rows["vol_chunk"]["err"], plane)
        if nx == VOL_SIZE:
            timed(rows["vol_chunk"], 
                lambda: fv.vol_chunk(u, q, f, w, scal, ri), 50)
            rows["vol_chunk"]["plain_ms"] = time_ms(
                lambda: fv.vol_chunk_plain(u, q, f, w, scal, ri), 10)
            # u, q, f in (5 volumes); new and previous u, q out (8)
            rows["vol_chunk"]["bound"] = bound(13 * nvox * 4,
                                               vol_chunk_ops(nvox, ri))

        # a solve's start on bench.py's data: u = f, q = 0
        f = torch.from_numpy(vol_data(L, nx, ny)).to(dev).reshape(L, nx, ny)
        q = torch.zeros((3, L, nx, ny), device=dev)
        consts = (np.sqrt(3 * nvox), np.sqrt(nvox), 1.5, 0.95, 1.05, 0.8)
        runs = (("alg1", 0.0),) if nx == VOL_SIZE else ()
        for stepsize, tol in runs + (("boyd", VOL_MC_TOL),):
            scal = torch.tensor([1.0, 1.0, 1.0, VOL_LMB, 1.0, 0.5, 0.0, 0.0,
                                 1.0, tol, tol, tol, tol], device=dev)
            out = fv.vol_multichunk(f, q, f, f, scal, ri, 8, "square",
                                    stepsize, consts)
            ref = fv.vol_multichunk_plain(f, q, f, f, scal, ri, 8, "square",
                                          stepsize, consts)
            torch.cuda.synchronize()
            plane, nrel = max_errs(out[:5], ref[:5])
            _, srel = max_errs(out[4:], ref[4:], n_planes=1)
            print(f"vol_multichunk {shape} {stepsize} tol {tol:g}: max abs "
                  f"err planes {plane:.3e} (tol {PLANE_ATOL:g}), max rel err "
                  f"norms {nrel:.3e} (tol {MC_NORM_RTOL:g}), scalars "
                  f"{srel:.3e} (tol {NORM_RTOL:g}); sout kernel "
                  f"{out[5].tolist()} plain {ref[5].tolist()}")
            check(plane <= PLANE_ATOL and nrel <= MC_NORM_RTOL
                  and srel <= NORM_RTOL,
                  f"vol_multichunk {shape} {stepsize} tol {tol:g} disagrees "
                  "with its plain version")
            check(out[5][5:].tolist() == ref[5][5:].tolist(),
                  "vol_multichunk's converged flag or chunk count disagrees")
            rows["vol_multichunk"]["err"] = max(
                rows["vol_multichunk"]["err"], plane)
            if tol == 0.0:  # all 8 chunks run
                timed(rows["vol_multichunk"], 
                    lambda: fv.vol_multichunk(f, q, f, f, scal, ri, 8,
                                              "square", stepsize, consts), 20)
                rows["vol_multichunk"]["plain_ms"] = time_ms(
                    lambda: fv.vol_multichunk_plain(f, q, f, f, scal, ri, 8,
                                                    "square", stepsize,
                                                    consts), 3)
                rows["vol_multichunk"]["bound"] = bound(
                    13 * nvox * 4, vol_chunk_ops(nvox, ri, int(out[5][6])))
    for name, r in rows.items():
        print(f"{name} {VOL_SIZE}x{VOL_SIZE}x{VOL_LABELS}: kernel "
              f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows


def phase_vol_solve(card):
    """vol256x8 (eight noisy slices of dog, lmb 6), fused and generic."""
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.ops import fused_vol as fv

    nx = ny = VOL_SIZE
    L = VOL_LABELS
    f = vol_data(L, nx, ny)

    def run(generic, max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10),
                            BackendPDHG if generic else None)
        return run_model(backend, vol_model(nx, ny, L, f), nx * ny * L,
                         max_iters)

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    fv.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = single_launches(fv)
    check(backend.made.vol is not None, "the fused volumetric route was not "
          "taken")
    check(all(v > 0 for v in launches.values()),
          f"a volumetric kernel of the path was not launched: {launches}")
    e_fused = vol_energy(res.x, f, VOL_LMB, L, nx, ny)
    print(f"fused vol solve {nx}x{ny}x{L}: {rates(res, backend, dt)}; energy "
          f"{e_fused:.8f}, launches {launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    e_gen = vol_energy(gres.x, f, VOL_LMB, L, nx, ny)
    rel = abs(e_fused - e_gen) / abs(e_gen)
    print(f"generic vol solve {nx}x{ny}x{L}: {rates(gres, gbackend, gdt)}; "
          f"energy {e_gen:.8f} [{card}]")
    print(f"energy fused vs generic vol: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g}); iterations {res.iterations} and "
          f"{gres.iterations}")
    check(rel <= ENERGY_RTOL, "fused and generic vol energies disagree")
    check(res.iterations == gres.iterations,
          "fused and generic vol solves stopped at different iterations")
    return launches, e_fused


def phase_deblur_solve(card):
    """BASELINE config 2 at 512x512 (flowers, motion blur, lmb 100), fused
    and generic."""
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.ops import fused_deblur as fd

    nx = ny = DB_SIZE
    fb = deblur_data(nx, ny)

    def run(generic, max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10),
                            BackendPDHG if generic else None)
        return run_model(backend, deblur_model(nx, ny, fb), nx * ny,
                         max_iters)

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    fd.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = single_launches(fd)
    check(backend.made.deblur is not None, "the fused deblur route was not "
          "taken")
    check(all(v > 0 for v in launches.values()),
          f"the deblur kernel was not launched: {launches}")
    e_fused = deblur_energy(res.x, fb, DB_LMB, nx, ny)
    check(backend.made.deblur["call"].resident,
          "config 2's chunks did not take the resident path")
    print(f"fused deblur solve {nx}x{ny} (resident path): "
          f"{rates(res, backend, dt)}; energy {e_fused:.8f}, launches "
          f"{launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    e_gen = deblur_energy(gres.x, fb, DB_LMB, nx, ny)
    rel = abs(e_fused - e_gen) / abs(e_gen)
    print(f"generic deblur solve {nx}x{ny}: {rates(gres, gbackend, gdt)}; "
          f"energy {e_gen:.8f} [{card}]")
    print(f"energy fused vs generic deblur: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g})")
    check(rel <= ENERGY_RTOL, "fused and generic deblur energies disagree")
    return launches, e_fused


def phase_tight_solve(card):
    """tight128x4 (junction_gray, 4 labels, lmb 1), fused and generic."""
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.ops import fused_tight as ft

    nx = ny = TIGHT_SIZE
    L = TIGHT_LABELS
    k = L * (L - 1) // 2
    f = tight_unaries(nx, ny, L)

    def run(generic, max_iters):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10),
                            BackendPDHG if generic else None)
        return run_model(backend, tight_model(nx, ny, L, f),
                         nx * ny * (L + 2 * k), max_iters)

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    ft.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = single_launches(ft)
    check(backend.made.tight is not None, "the fused tight route was not "
          "taken")
    check(all(v > 0 for v in launches.values()),
          f"the tight kernel was not launched: {launches}")
    fused = tight_measures(res.x, f, TIGHT_LMB, L, nx, ny)
    print(f"fused tight solve {nx}x{ny}x{L}: {rates(res, backend, dt)}; "
          f"energy {fused[0]:.8f}, |grad u + kron(P^T, I) v| "
          f"{fused[1]:.6e}, max |sum_l u_l - 1| {fused[2]:.6e}, launches "
          f"{launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    gen = tight_measures(gres.x, f, TIGHT_LMB, L, nx, ny)
    print(f"generic tight solve {nx}x{ny}x{L}: {rates(gres, gbackend, gdt)};"
          f" energy {gen[0]:.8f}, |grad u + kron(P^T, I) v| {gen[1]:.6e}, "
          f"max |sum_l u_l - 1| {gen[2]:.6e} [{card}]")
    rel = abs(fused[0] - gen[0]) / abs(gen[0])
    print(f"energy fused vs generic tight: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g}); constraint residual and unity error "
          f"within {TIGHT_MEASURE_RTOL:g} relative of the generic path's")
    check(rel <= ENERGY_RTOL, "fused and generic tight energies disagree")
    for a, b, what in ((fused[1], gen[1], "constraint residuals"),
                       (fused[2], gen[2], "unity errors")):
        check(abs(a - b) <= TIGHT_MEASURE_RTOL * b,
              f"fused and generic tight {what} disagree")
    return launches, fused[0]


def rof_energies(u, f, lmb, nx, ny):
    """rof_energy of each of the B rows of ``u`` (with its own row of ``f``
    and its own ``lmb``), in float64."""
    u = u.reshape(-1, nx, ny).astype(np.float64)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    fit = np.sum((u - f.reshape(u.shape)) ** 2, axis=(1, 2))
    return 0.5 * np.asarray(lmb) * fit + np.sum(np.sqrt(gx ** 2 + gy ** 2),
                                                axis=(1, 2))


def ensemble_data(B, nx, ny, seed=42):
    """bench.py build_ensemble's data: the procedural image plus each
    instance's 0.05 randn, then its lmb from uniform(4, 32), in turn from
    one RandomState(seed); ((B, nx*ny) f32, B lmb)."""
    rng = np.random.RandomState(seed)
    base = test_image(nx, ny, seed).reshape(-1)
    fs, lmbs = [], []
    for _ in range(B):
        fs.append((base + 0.05 * rng.randn(nx * ny)).astype(np.float32))
        lmbs.append(float(rng.uniform(4.0, 32.0)))
    return np.stack(fs), lmbs


def ensemble_problem(nx, ny, f, lmb):
    """One instance of bench.py build_ensemble: Problem.create of a
    BlockGradient2D, a ProxElem1D square data term with coeffs (1, f, lmb,
    0, 0, 0, 0) and the conjugate of the dim-2 norm."""
    import prost_tpu_torch as ptt

    n = nx * ny
    grad = ptt.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [ptt.prox.ProxElem1D(index=0, size=n, fun="square",
                                  coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = ptt.prox.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                                interleaved=False, fun="abs",
                                coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return ptt.Problem.create(
        ptt.linop.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ptt.prox.ProxMoreau(index=0, size=2 * n, child=pn)])


def batched_scaled_errs(out, ref, n_planes):
    """``scaled_errs`` of each instance of a batched chunk's outputs (its
    own planes' and norms' scales), the largest over the instances."""
    def inst(o, b):
        return [t[b] for t in o[:n_planes]] + [o[n_planes][:, b]]

    errs = [scaled_errs(inst(out, b), inst(ref, b), n_planes)
            for b in range(out[0].shape[0])]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def batched_check(name, many, one, plain, planes, scal, n_planes, count,
                  *extra, errs=max_errs):
    """``many`` (a batched chunk wrapper) on the card against its plain
    version on the same inputs (``errs``: the largest plane and norm
    errors), and each instance against the single-instance kernel ``one``
    on that instance alone (bit-equal expected).  Returns the largest plane
    error against the plain version."""
    import torch

    out = many(*planes, scal, count, *extra)
    ref = plain(*planes, scal, count, *extra)
    torch.cuda.synchronize()
    plane, rel = errs(out, ref, n_planes)
    single = 0.0
    for b in range(planes[0].shape[0]):
        s = one(*[p[b] for p in planes], scal[:, b], count, *extra)
        for a, c in zip([o[b] for o in out[:n_planes]] + [out[n_planes][:, b]],
                        s[:n_planes + 1]):
            single = max(single, float(torch.max(torch.abs(a - c))))
    print(f"{name}: max abs err planes {plane:.3e} (tol {PLANE_ATOL:g}), max "
          f"rel err norms {rel:.3e} (tol {NORM_RTOL:g}); largest difference "
          f"of an instance to the single-instance kernel {single:.3e} "
          "(bit-equal expected)")
    check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
          f"{name} disagrees with its plain version")
    check(single == 0.0, f"{name}: an instance differs from the single-"
          "instance kernel")
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"{name} produced non-finite values")
    return plane


def batched_scal(seed, B, a, b, dev):
    """(5, B) scalar rows with per-instance tau and sigma that differ:
    tau, sigma in [0.8, 1.2), theta 1, the family's scalars a and b (rows
    of B, or numbers)."""
    import torch

    rng = np.random.RandomState(seed)
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            np.broadcast_to(a, (B,)), np.broadcast_to(b, (B,))]
    return torch.tensor(np.array(rows), dtype=torch.float32, device=dev)


def rof_batched_timings(planes, scal, ri, csize):
    """Row 4 at ensemble1024x128: the cluster launch that the route calls
    (the wrapper, which reads its inputs and writes new outputs) in turns
    with the streaming launch sequence in place on buffers made once (old,
    new, new, old), the hand-written kernels each launches per call, and
    the cluster launch itself at the larger cluster sizes.  Returns the
    row's ms."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops.pdhg_chunk import (S_CONV, S_LEN, launch,
                                                scalar_buffer)

    x, q, f, w = planes
    bufs = [t.clone() for t in (x, q, x, q)]

    def old():
        fr.rof_chunk_batched_streaming_(*bufs, f, w, scal, ri)

    def new():
        fr.rof_chunk_batched(*planes, scal, ri)

    (o1, o2), (n1, n2) = in_turns(old, new, 20)
    (lo, do), (ln, dn) = (csrc_launches(old, lambda c: len(c) == 23),
                          csrc_launches(new, lambda c: c == [
                              "rof_chunk_cluster", "pdhg_finish"]))
    print(f"rof_chunk_batched B={x.shape[0]} in turns: streaming sequence "
          f"{o1:.4f} ms, cluster {n1:.4f}, cluster {n2:.4f}, streaming "
          f"{o2:.4f} ms/call; hand-written launches per call: streaming "
          f"{len(lo)} ({fmt_ms(do)} ms of device time traced), cluster "
          f"{len(ln)} ({', '.join(ln)}; {fmt_ms(dn)} ms)")
    check(ln == ["rof_chunk_cluster", "pdhg_finish"],
          f"the cluster path launched {ln}")
    lib = fr._lib()
    batch, nx, ny = x.shape
    outs = [torch.empty_like(t) for t in (x, q, x, q)]
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(4 * lib.prost_rof_num_blocks(nx, ny) * batch)
    def cluster(c, count):
        return time_ms(lambda: launch(
            lib, "prost_rof_chunk_cluster", "rof_chunk_batched",
            fr.launch_counts, x.device, [x, q, f, w, *outs, sc, partial],
            nx, ny, count, 0, batch, c), 20)

    sizes = {c: cluster(c, ri) for c in (csize, 2 * csize, 4 * csize)
             if c <= fr.CLUSTER_SIZES[-1]}
    print("rof_chunk_batched cluster launch by cluster size: " + ", ".join(
        f"C={c} {ms:.4f} ms" for c, ms in sizes.items()))
    one = cluster(csize, 1)
    print(f"rof_chunk_batched cluster launch by count (C={csize}): 1 "
          f"iteration {one:.4f} ms, {ri} iterations {sizes[csize]:.4f} ms: "
          f"{(sizes[csize] - one) / (ri - 1):.4f} ms an iteration beyond "
          "the first")
    return {"ms": time_ms(new, 20), "traced": traced_call(new),
            "old_ms": (o1, o2), "new_ms": (n1, n2),
            "launches_per_call": (len(lo), len(ln))}


def rof_batched_tiled_kernels(dev, ri):
    """Row 7: the batched ROF chunk's tiled launch (the instances on the
    grid's z axis) at B = 2 of 1280x1280 (where the JAX package bands each
    instance), B = 8 of 512x512, the ragged CPU-test shapes (forced tiled:
    a cluster holds them; a flagged instance each) and the main path's
    B = 4 of 2048x2048: against its plain version, each instance
    bit-equal to the single-instance ``rof_chunk`` and every output to the
    batched streaming sequence, a flagged instance's inputs back; at 1280,
    512 and 2048 the two paths in place in turns (streaming, tiled, tiled,
    streaming) with their traced launches and the wrappers' counts
    (BANDED[7] at 1280x1280); the wrapper timed at the main path's shape
    for the kernels line.  Returns its row."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr

    row = {"err": 0.0}
    rng = np.random.RandomState(660)
    for seed, (B, nx, ny, dataterm, path, flags) in enumerate((
            (2, 1280, 1280, "square", None, None),
            (8, 512, 512, "wsquare", None, None),
            (3, 70, 53, "abs", "tiled", [0, 1, 0]),
            (3, 41, 97, "wsquare", "tiled", [0, 0, 1]),
            (LARGE_ENS_B, LARGE_ENS_SIZE, LARGE_ENS_SIZE, "square", None,
             None))):
        route = fr.batched_pick_route(path, B, nx, ny, dataterm, ri, dev,
                                      "rof_chunk_batched")
        tile = route[1]
        tiles = B * -(-nx // tile[0]) * -(-ny // tile[1])
        label = f"rof_chunk_batched B={B} {nx}x{ny} {dataterm}"
        print(f"{label}: {route[0]} path (asked: {path}), tile {tile}, "
              f"{tiles} blocks over the instances")
        check(route[0] == "tiled", f"{label} took the {route[0]} path")
        arrs = (rng.rand(B, nx, ny), 0.3 * rng.randn(B, 2, nx, ny),
                rng.rand(B, nx, ny), 2.0 * (rng.rand(B, nx, ny) > 0.3))
        planes = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
        scal = batched_scal(670 + seed, B, 4.0 + 12.0 * rng.rand(B),
                            0.5 + rng.rand(B), dev)
        if flags is not None:
            scal = torch.cat([scal, torch.tensor([flags], dtype=scal.dtype,
                                                 device=dev)])

        def many(*a):
            return fr.rof_chunk_batched(*a, path=path)

        err = batched_check(f"{label} (tiled path)", many, fr.rof_chunk,
                            fr.rof_chunk_batched_plain, planes, scal, 4, ri,
                            dataterm)
        row["err"] = max(row["err"], err)
        x, q, f, w = planes
        out = many(*planes, scal, ri, dataterm)
        cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
        norms2 = fr.rof_chunk_batched_streaming_(*cur, *prev, f, w, scal, ri,
                                                 dataterm)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, cur + prev +
                                                     [norms2])),
              f"{label}: the tiled launch is not the streaming sequence")
        for b in [b for b, v in enumerate(flags or ()) if v]:
            check(all(torch.equal(t[b], i[b]) for t, i in
                      zip(out[:4], (x, q, x, q))) and not out[4][:, b].any(),
                  f"{label}: flagged instance {b} did not keep its inputs")
        print(f"{label}: tiled bit-equal to the streaming sequence in the "
              f"planes, the previous iterates and the norms; flagged "
              f"instances {[b for b, v in enumerate(flags or ()) if v]} "
              "kept their inputs")
        if path is not None:
            continue
        n = nx * ny
        b = bound(10 * B * n * 4, B * n * (ri * ROF_ITER_OPS + ROF_NORM_OPS))
        # the two paths in place, in turns
        bufs = {p: ([x.clone(), q.clone()], [x.clone(), q.clone()])
                for p in ("streaming", "tiled")}
        calls = {p: (lambda p=p: fr.rof_chunk_batched_(
            *bufs[p][0], *bufs[p][1], f, w, scal, ri, dataterm, p))
            for p in bufs}
        (o1, o2), (t1, t2) = in_turns(calls["streaming"], calls["tiled"], 20)
        ts = traced_until(calls["streaming"], lambda c: len(c) == 23)
        tt = traced_until(calls["tiled"], lambda c: c == [
            "rof_tiled", "pdhg_finish", "rof_tiled_settle"])
        got = counted(fr, calls["tiled"])
        check(got == {"rof_chunk_batched": 1, "rof_chunk_batched_tiled": 1},
              f"{label}: the tiled call counted {got}")
        print(f"{label} in place, in turns: streaming {o1:.4f} ms, tiled "
              f"{t1:.4f}, tiled {t2:.4f}, streaming {o2:.4f} ms/call; "
              f"traced device ms: streaming {fmt_ms(ts['csrc_ms'])} "
              f"({len(ts['csrc'])} hand-written launches), tiled "
              f"{fmt_ms(tt['csrc_ms'])} ({', '.join(tt['csrc'])}), "
              f"PyTorch {fmt_ms(tt['torch_ms'])} ms; counted {got}; "
              f"bound {b[0]:.5f} ms ({b[1]})")
        del bufs, calls
        if nx == 1280:
            BANDED[7] = {"call": f"{label} (tiled path)",
                         "launches_per_call": len(tt["csrc"]),
                         "device_ms": tt["csrc_ms"], "bound_ms": b[0],
                         "bound_by": b[1], "ms": (t1, t2),
                         "streaming_ms": (o1, o2),
                         "streaming_launches": len(ts["csrc"]),
                         "streaming_device_ms": ts["csrc_ms"]}
        if nx != LARGE_ENS_SIZE:
            continue
        # the kernels line: the functional wrapper at the main path's shape
        timed(row, lambda: fr.rof_chunk_batched(*planes, scal, ri), 10,
              lambda c: c == ["rof_tiled", "pdhg_finish",
                              "rof_tiled_settle"], fr)
        check(row["counted"] == {"rof_chunk_batched": 1,
                                 "rof_chunk_batched_tiled": 1},
              f"{label}: the wrapper counted {row['counted']}")
        row["plain_ms"] = time_ms(lambda: fr.rof_chunk_batched_plain(
            *planes, scal, ri), 2)
        row["bound"] = b
        print(f"{label}: wrapper {row['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(row['traced']['csrc_ms'])} ms in "
              f"{len(row['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(row['traced']['torch_ms'])}), plain "
              f"{row['plain_ms']:.4f} ms/call, bound {b[0]:.5f} ms ({b[1]})")
        del planes, x, q, f, w, out, cur, prev
        torch.cuda.empty_cache()
    return row


def phase_batched_kernels(dev):
    """The five batched chunks against their plain versions and, instance
    by instance, against the single-instance kernels; timed at the main
    path's shapes (rof at ensemble1024x128, its tiled launch at B = 4 of
    2048x2048, ml and vol at B = 8 of 256x256x8, deblur at B = 8 of
    512x512, tight at B = 8 of 128x128x4)."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv

    ri = 10
    rows = {k: {"err": 0.0} for k in (
        "rof_chunk_batched", "ml_chunk_batched", "vol_chunk_batched",
        "deblur_chunk_batched", "tight_chunk_batched")}

    # rof: the config-5 data (x = f, mass on q and on its dead coordinates)
    # and a ragged batch with the three data terms, each instance held by a
    # cluster; then the instances no cluster holds (row 7, ``rof_batched_
    # tiled_kernels``)
    fs, lmbs = ensemble_data(ENS_B, ENS_SIZE, ENS_SIZE)
    rng = np.random.RandomState(600)
    sms, tsmem = fr.card_sms(dev), fr.tiled_limit(dev)
    cases = [(ENS_B, ENS_SIZE, ENS_SIZE, "square"),
             (5, 250, 190, "square"), (5, 250, 190, "wsquare"),
             (5, 250, 190, "abs")]
    for seed, (B, nx, ny, dataterm) in enumerate(cases):
        route = fr.batched_route_of(B, nx, ny, dataterm, ri, sms, tsmem)
        csize = fr.cluster_size(nx, ny, dataterm)
        held = fr._lib().prost_rof_cluster_occupancy(
            nx, ny, fr.DATATERMS[dataterm], csize)
        print(f"rof_chunk_batched B={B} {nx}x{ny} {dataterm}: {route}, "
              f"{csize} CTAs a cluster, bands of "
              f"{fr.cluster_band_rows(nx, csize)} rows, "
              f"{fr.cluster_planes(dataterm)} planes in shared memory, "
              f"{held} clusters at once")
        check(route == "cluster", f"rof_chunk_batched {nx}x{ny} took the "
              f"{route} path")
        if B == ENS_B:
            x = torch.from_numpy(fs).to(dev).reshape(B, nx, ny)
            f, lmb = x, np.asarray(lmbs)
        else:
            x = torch.from_numpy(rng.rand(B, nx, ny).astype(np.float32)
                                 ).to(dev)
            f, lmb = torch.rand_like(x), 16.0
        q = torch.from_numpy((0.3 * rng.randn(B, 2, nx, ny)).astype(
            np.float32)).to(dev)
        w = 2.0 * (torch.rand_like(x) > 0.3).float()
        scal = batched_scal(610 + seed, B, lmb, 1.0, dev)
        planes = (x, q, f, w)
        err = batched_check(f"rof_chunk_batched B={B} {nx}x{ny} {dataterm}",
                            fr.rof_chunk_batched, fr.rof_chunk,
                            fr.rof_chunk_batched_plain, planes, scal, 4, ri,
                            dataterm)
        r = rows["rof_chunk_batched"]
        r["err"] = max(r["err"], err)
        if B == ENS_B:
            r.update(rof_batched_timings(planes, scal, ri, csize))
            r["plain_ms"] = time_ms(lambda: fr.rof_chunk_batched_plain(
                *planes, scal, ri), 5)
            n = nx * ny
            # x, q, f in (4 planes); new and previous x, q out (6)
            r["bound"] = bound(10 * B * n * 4,
                               B * n * (ri * ROF_ITER_OPS + ROF_NORM_OPS))
    rows["rof_chunk_batched_tiled"] = rof_batched_tiled_kernels(dev, ri)

    # ml: config 3's shape and a ragged one
    for seed, (B, L, nx, ny) in enumerate(((SMALL_ENS_B, ML_LABELS, ML_SIZE,
                                            ML_SIZE), (3, 5, 250, 190))):
        arrs = (rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 2 * L, nx, ny),
                0.1 * rng.randn(B, nx, ny), rng.rand(B, L, nx, ny))
        planes = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
        scal = batched_scal(620 + seed, B, ML_LMB, 1.0, dev)
        resident = fm.resident_ok(L, nx, ny, *fm.card_limits(dev, L, True))
        check(resident, f"ml_chunk_batched B={B} {nx}x{ny}x{L}: the shape "
              "rule streams")
        err = batched_check(f"ml_chunk_batched B={B} {nx}x{ny}x{L} "
                            "(resident path)", fm.ml_chunk_batched,
                            fm.ml_chunk, fm.ml_chunk_batched_plain, planes,
                            scal, 6, ri)
        r = rows["ml_chunk_batched"]
        r["err"] = max(r["err"], err)
        if B == SMALL_ENS_B:
            timed(r, lambda: fm.ml_chunk_batched(*planes, scal, ri),
                              20)
            r["plain_ms"] = time_ms(lambda: fm.ml_chunk_batched_plain(
                *planes, scal, ri), 5)
            n = nx * ny
            # u, q, s, f in; new and previous u, q, s out, per instance
            r["bound"] = bound(B * (10 * L + 3) * n * 4,
                               B * ml_chunk_ops(n, L, ri))

    # vol: vol256x8's shape, a ragged one with the three data terms, and
    # one slice
    cases = [(SMALL_ENS_B, VOL_LABELS, VOL_SIZE, VOL_SIZE, "square"),
             (3, 5, 190, 250, "square"), (3, 5, 190, 250, "wsquare"),
             (3, 5, 190, 250, "abs"), (2, 1, 64, 96, "square")]
    for seed, (B, L, nx, ny, dataterm) in enumerate(cases):
        arrs = (rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 3, L, nx, ny),
                rng.rand(B, L, nx, ny), 2.0 * (rng.rand(B, L, nx, ny) > 0.3))
        planes = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
        scal = batched_scal(630 + seed, B, VOL_LMB, 1.0, dev)
        err = batched_check(
            f"vol_chunk_batched B={B} {nx}x{ny}x{L} {dataterm}",
            fv.vol_chunk_batched, fv.vol_chunk, fv.vol_chunk_batched_plain,
            planes, scal, 4, ri, dataterm)
        r = rows["vol_chunk_batched"]
        r["err"] = max(r["err"], err)
        if B == SMALL_ENS_B:
            timed(r, lambda: fv.vol_chunk_batched(*planes, scal,
                                                           ri), 20)
            r["plain_ms"] = time_ms(lambda: fv.vol_chunk_batched_plain(
                *planes, scal, ri), 5)
            nvox = L * nx * ny
            # u, q, f in (5 volumes); new and previous u, q out (8)
            r["bound"] = bound(B * 13 * nvox * 4, B * vol_chunk_ops(nvox, ri))

    # deblur: deblur8x512's shape with config 2's blur, and a ragged one
    # with the asymmetric blur (nx2 - nx and ny2 - ny differ from the
    # motion blur's, the frames' planes of two sizes)
    for seed, (B, nx, ny, kern) in enumerate((
            (SMALL_ENS_B, DB_SIZE, DB_SIZE, motion_kernel()),
            (3, 250, 190, asym_kernel()))):
        taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
        nx2, ny2 = nx + kern.shape[1] - 1, ny + kern.shape[0] - 1
        arrs = (rng.rand(B, nx, ny), rng.randn(B, nx2, ny2),
                0.3 * rng.randn(B, 2, nx, ny), rng.rand(B, nx2, ny2),
                0.5 + rng.rand(B, nx2, ny2))
        planes = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
        scal = batched_scal(640 + seed, B, DB_LMB * (0.5 + rng.rand(B)),
                            1.0, dev)
        extra = (taps, 0.5, 0.2)
        err = batched_check(
            f"deblur_chunk_batched B={B} {nx}x{ny} ({len(taps)} taps)",
            fd.deblur_chunk_batched, fd.deblur_chunk,
            fd.deblur_chunk_batched_plain, planes, scal, 6, ri, *extra,
            errs=batched_scaled_errs)
        r = rows["deblur_chunk_batched"]
        r["err"] = max(r["err"], err)
        if B == SMALL_ENS_B:
            timed(r, lambda: fd.deblur_chunk_batched(
                *planes, scal, ri, *extra), 20)
            r["plain_ms"] = time_ms(lambda: fd.deblur_chunk_batched_plain(
                *planes, scal, ri, *extra), 5)
            n, m2, T = nx * ny, nx2 * ny2, len(taps)
            # per frame x, yv, q, fb, sv in and new and previous x, yv, q
            # out; the taps once
            r["bound"] = bound((B * (9 * n + 5 * m2) + 3 * T) * 4,
                               B * deblur_chunk_ops(n, m2, T, ri))

    # tight: tight8x128x4's shape and a ragged one with L = 3
    for seed, (B, L, nx, ny) in enumerate((
            (SMALL_ENS_B, TIGHT_LABELS, TIGHT_SIZE, TIGHT_SIZE),
            (3, 3, 250, 190))):
        k = L * (L - 1) // 2
        pt_ = pair_matrix(L).T
        taps = tuple((r_, m, float(pt_[r_, m])) for r_ in range(2 * L)
                     for m in range(2 * k) if pt_[r_, m] != 0.0)
        consts = tuple(float(np.float32(c))
                       for c in (1 / (L + 1), 1.0, 1 / L, 0.2, 1 / 3))
        arrs = (rng.rand(B, L, nx, ny), 0.1 * rng.randn(B, 2 * k, nx, ny),
                0.2 * rng.randn(B, 2 * L, nx, ny),
                0.1 * rng.randn(B, 2 * k, nx, ny), 0.1 * rng.randn(B, nx, ny),
                rng.rand(B, L, nx, ny))
        planes = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
        scal = batched_scal(650 + seed, B, TIGHT_LMB * (0.5 + rng.rand(B)),
                            1.0, dev)
        err = batched_check(
            f"tight_chunk_batched B={B} {nx}x{ny}x{L}",
            ft.tight_chunk_batched, ft.tight_chunk,
            ft.tight_chunk_batched_plain, planes, scal, 10, ri, taps, consts,
            errs=batched_scaled_errs)
        r = rows["tight_chunk_batched"]
        r["err"] = max(r["err"], err)
        if B == SMALL_ENS_B:
            timed(r, lambda: ft.tight_chunk_batched(
                *planes, scal, ri, taps, consts), 20)
            r["plain_ms"] = time_ms(lambda: ft.tight_chunk_batched_plain(
                *planes, scal, ri, taps, consts), 5)
            n, T = nx * ny, len(taps)
            # per instance u, v, q, p, s, f in and the new and previous
            # state out; the taps array once
            r["bound"] = bound((B * (10 * L + 12 * k + 3) * n + 4 * T
                                + 2 * L + 2 * k + 2) * 4,
                               B * tight_chunk_ops(n, L, k, T, ri))
    for name, r in rows.items():
        print(f"{name}: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})")
    return rows


def ensemble_run(b, warm, iters):
    """``warm`` iterations of ``BatchedPDHG`` ``b`` from its initial state,
    then ``iters`` more, timed on the host and synced by reading a scalar;
    (state, seconds of the timed part)."""
    s = b.run(b.initial_state(), warm, 0)
    float(s.tau[0])
    t0 = time.perf_counter()
    s = b.run(s, warm + iters, warm)
    float(s.tau[0])
    return s, time.perf_counter() - t0


def single_run(problem, opts, sopts, warm, iters):
    """The single-instance fused route on one instance, with the same two
    run calls as ``ensemble_run``; its final state."""
    from prost_tpu_torch.ops import FusedROFPDHG

    b = FusedROFPDHG(problem, opts, sopts)
    check(any(r is not None for r in (b.rof, b.ml, b.deblur, b.tight,
                                      b.vol)),
          "the single-instance fused route was not taken")
    s = b.run(b.initial_state(), warm, 0)
    return b.run(s, warm + iters, warm)


def ens_opts():
    """bench.py's options for every configuration: boyd, residual_iter
    10, no step scaling by the operator norm, all four tolerances 0 (no
    instance converges, every run goes to its end)."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import PDHGOptions

    return (PDHGOptions(stepsize="boyd", residual_iter=10,
                        scale_steps_operator=False),
            ptt.SolverOptions(verbose=False, tol_rel_primal=0.0,
                              tol_rel_dual=0.0, tol_abs_primal=0.0,
                              tol_abs_dual=0.0))


def phase_ensemble(card):
    """ensemble1024x128 (BASELINE config 5) as bench.py builds it, through
    BatchedPDHG: the fused batched route, then the generic batched path
    (the route set to None), each ENS_WARM + ENS_ITERS iterations; every
    instance's energy held fused against generic, three instances against
    single-instance fused solves."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.parallel import BatchedPDHG

    nx = ny = ENS_SIZE
    fs, lmbs = ensemble_data(ENS_B, nx, ny)
    opts, sopts = ens_opts()
    t0 = time.perf_counter()
    problems = [ensemble_problem(nx, ny, f, lmb) for f, lmb in zip(fs, lmbs)]
    b = BatchedPDHG(problems, opts, sopts)
    check(b.rof is not None, "the fused batched ROF route was not taken")
    print(f"ensemble {ENS_B}x{nx}x{ny}: set-up {time.perf_counter() - t0:.2f}"
          f" s (problems, stacking, matching); stacked leaves "
          f"{b.batched_problem.paths}")

    fr.reset_launch_counts()
    state, dt = ensemble_run(b, ENS_WARM, ENS_ITERS)
    launches = fr.launch_counts["rof_chunk_batched"]
    # the phase plan: one generic step (iteration 0), two chunks to the end
    # of the warm-up, then ENS_ITERS / 10 chunks
    want = 2 + ENS_ITERS // 10
    check(launches == want, f"rof_chunk_batched launches {launches}, the "
          f"phase plan has {want}")
    check(state.iteration.tolist() == [ENS_WARM + ENS_ITERS] * ENS_B
          and not bool(state.converged.any()),
          "the ensemble did not run every instance to its end")
    x = state.x.cpu().numpy()
    check(x.shape == (ENS_B, nx * ny) and np.all(np.isfinite(x)),
          "non-finite or misshapen ensemble result")
    e_fused = rof_energies(x, fs, lmbs, nx, ny)
    rate = ENS_B * ENS_ITERS / dt
    print(f"fused batched ensemble {ENS_B}x{nx}x{ny}: {ENS_ITERS} iterations "
          f"in {dt:.4f} s = {ENS_ITERS / dt:.1f} it/s = {rate:.1f} "
          f"instance-it/s, rof_chunk_batched launches {launches} (with the "
          f"warm-up's) [{card}]")

    b.rof = None  # the generic batched path, the JAX tests' idiom
    gstate, gdt = ensemble_run(b, ENS_WARM, ENS_ITERS)
    e_gen = rof_energies(gstate.x.cpu().numpy(), fs, lmbs, nx, ny)
    grate = ENS_B * ENS_ITERS / gdt
    rel = float(np.max(np.abs(e_fused - e_gen) / np.abs(e_gen)))
    print(f"generic batched ensemble {ENS_B}x{nx}x{ny}: {ENS_ITERS} "
          f"iterations in {gdt:.4f} s = {ENS_ITERS / gdt:.1f} it/s = "
          f"{grate:.1f} instance-it/s [{card}]; fused/generic "
          f"{rate / grate:.2f}x")
    sampled = [float(e_fused[i]) for i in ENS_SAMPLES]
    print(f"energy fused vs generic ensemble: max rel diff over the "
          f"{ENS_B} instances {rel:.3e} (tol {ENERGY_RTOL:g}); energies of "
          f"instances {ENS_SAMPLES}: {sampled}")
    check(rel <= ENERGY_RTOL, "fused and generic ensemble energies disagree")
    for i in ENS_SAMPLES:
        s = single_run(problems[i], opts, sopts, ENS_WARM, ENS_ITERS)
        e1 = rof_energies(s.x.cpu().numpy()[None], fs[i], [lmbs[i]], nx,
                          ny)[0]
        rel1 = abs(e_fused[i] - e1) / abs(e1)
        print(f"ensemble instance {i} vs a single-instance fused solve: "
              f"energy {e_fused[i]:.8f} vs {e1:.8f}, rel diff {rel1:.3e} "
              f"(tol {ENERGY_RTOL:g})")
        check(rel1 <= ENERGY_RTOL, f"ensemble instance {i} disagrees with "
              "its single-instance solve")
    del b, problems, state, gstate
    torch.cuda.empty_cache()
    return {"rof_chunk_batched": launches}, rate, grate


def phase_large_ensemble(card):
    """LARGE_ENS_B ROF instances of 2048x2048 (4-megapixel frames denoised
    together; ``ensemble_data``, config 5's options) through BatchedPDHG:
    the fused batched route, whose chunks take ``ROFBatchedChunk``'s tiled
    launch in place (no cluster holds an instance), counted against the
    phase plan, then the generic batched path, each ENS_WARM +
    SMALL_ENS_ITERS iterations; every instance's energy held fused against
    generic, the first and last against single-instance fused solves."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.parallel import BatchedPDHG

    B, nx, ny = LARGE_ENS_B, LARGE_ENS_SIZE, LARGE_ENS_SIZE
    fs, lmbs = ensemble_data(B, nx, ny)
    opts, sopts = ens_opts()
    t0 = time.perf_counter()
    problems = [ensemble_problem(nx, ny, f, lmb) for f, lmb in zip(fs, lmbs)]
    b = BatchedPDHG(problems, opts, sopts)
    check(b.rof is not None, "the fused batched ROF route was not taken")
    print(f"ensemble {B}x{nx}x{ny}: set-up {time.perf_counter() - t0:.2f} s; "
          f"lmb {[round(v, 4) for v in lmbs]}")

    fr.reset_launch_counts()
    state, dt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
    launches = fr.launch_counts["rof_chunk_batched_tiled"]
    call = b.rof["call"]
    # the phase plan: one generic step (iteration 0), two chunks to the end
    # of the warm-up, then SMALL_ENS_ITERS / 10 chunks
    want = 2 + SMALL_ENS_ITERS // 10
    check(call.inplace and call.route[0] == "tiled",
          f"the {B}x{nx}x{ny} ensemble's chunks took {call.route}")
    check(launches == fr.launch_counts["rof_chunk_batched"] == want,
          f"rof_chunk_batched_tiled launches {launches} (rof_chunk_batched "
          f"{fr.launch_counts['rof_chunk_batched']}), the phase plan has "
          f"{want}")
    check(state.iteration.tolist() == [ENS_WARM + SMALL_ENS_ITERS] * B
          and not bool(state.converged.any()),
          "the ensemble did not run every instance to its end")
    x = state.x.cpu().numpy()
    check(x.shape == (B, nx * ny) and np.all(np.isfinite(x)),
          "non-finite or misshapen ensemble result")
    e_fused = rof_energies(x, fs, lmbs, nx, ny)
    rate = B * SMALL_ENS_ITERS / dt
    print(f"fused batched ensemble {B}x{nx}x{ny} (tiled launch, tile "
          f"{call.route[1]}): {SMALL_ENS_ITERS} iterations in {dt:.4f} s = "
          f"{SMALL_ENS_ITERS / dt:.1f} it/s = {rate:.1f} instance-it/s, "
          f"rof_chunk_batched_tiled launches {launches} (with the "
          f"warm-up's) [{card}]")
    b.rof = None  # the generic batched path, the JAX tests' idiom
    gstate, gdt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
    e_gen = rof_energies(gstate.x.cpu().numpy(), fs, lmbs, nx, ny)
    grate = B * SMALL_ENS_ITERS / gdt
    rel = float(np.max(np.abs(e_fused - e_gen) / np.abs(e_gen)))
    print(f"generic batched ensemble {B}x{nx}x{ny}: {SMALL_ENS_ITERS} "
          f"iterations in {gdt:.4f} s = {grate:.1f} instance-it/s [{card}]; "
          f"fused/generic {rate / grate:.2f}x; energy max rel diff "
          f"{rel:.3e} (tol {ENERGY_RTOL:g}); energies {list(e_fused)}")
    check(rel <= ENERGY_RTOL, "fused and generic ensemble energies disagree")
    del gstate
    for i in (0, B - 1):
        s = single_run(problems[i], opts, sopts, ENS_WARM, SMALL_ENS_ITERS)
        e1 = rof_energies(s.x.cpu().numpy()[None], fs[i], [lmbs[i]], nx,
                          ny)[0]
        rel1 = abs(e_fused[i] - e1) / abs(e1)
        print(f"ensemble {B}x{nx}x{ny} instance {i} vs a single-instance "
              f"fused solve: energy {e_fused[i]:.8f} vs {e1:.8f}, rel diff "
              f"{rel1:.3e} (tol {ENERGY_RTOL:g})")
        check(rel1 <= ENERGY_RTOL, f"ensemble instance {i} disagrees with "
              "its single-instance solve")
    del b, problems, state
    torch.cuda.empty_cache()
    return {"rof_chunk_batched_tiled": launches}, rate, grate


def phase_small_ensembles(card):
    """SMALL_ENS_B instances of config 3 (the cow, each instance's gray
    levels with their own 0.05 noise) and of vol256x8 (each instance's
    slices with their own noise), fused batched against generic batched
    and against single-instance fused solves of two instances."""
    import torch

    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel import BatchedPDHG

    opts, sopts = ens_opts()
    B, L, nx, ny = SMALL_ENS_B, ML_LABELS, ML_SIZE, ML_SIZE
    rng = np.random.RandomState(42)
    gray = cow_gray(ny, nx)
    mls = [ml_unaries(gray + 0.05 * rng.randn(*gray.shape), L)
           for _ in range(B)]
    vols = [vol_data(VOL_LABELS, VOL_SIZE, VOL_SIZE, seed=42 + i)
            for i in range(B)]
    cases = (
        ("ml", fm, "ml_chunk_batched", mls,
         lambda f: ml_model(nx, ny, L, f, ML_LMB).finalize(),
         lambda x, f: ml_energy(x, f, ML_LMB, L, nx, ny)),
        ("vol", fv, "vol_chunk_batched", vols,
         lambda f: vol_model(VOL_SIZE, VOL_SIZE, VOL_LABELS, f).finalize(),
         lambda x, f: vol_energy(x, f, VOL_LMB, VOL_LABELS, VOL_SIZE,
                                 VOL_SIZE)))
    launches = {}
    for kind, mod, name, data, model, energy in cases:
        problems = [model(f) for f in data]
        b = BatchedPDHG(problems, opts, sopts)
        check(getattr(b, kind) is not None,
              f"the fused batched {kind} route was not taken")
        mod.reset_launch_counts()
        state, dt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        launches[name] = mod.launch_counts[name]
        check(launches[name] > 0, f"{name} was not launched")
        x = state.x.cpu().numpy()
        check(np.all(np.isfinite(x)), f"non-finite {kind} ensemble result")
        e_fused = np.array([energy(x[i], data[i]) for i in range(B)])
        ensemble_turns(kind, b, data, energy, card)
        setattr(b, kind, None)
        gstate, gdt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        gx = gstate.x.cpu().numpy()
        e_gen = np.array([energy(gx[i], data[i]) for i in range(B)])
        rel = float(np.max(np.abs(e_fused - e_gen) / np.abs(e_gen)))
        print(f"{kind} ensemble {B}x{x.shape[1]}: fused "
              f"{B * SMALL_ENS_ITERS / dt:.1f} instance-it/s, generic "
              f"{B * SMALL_ENS_ITERS / gdt:.1f} [{card}]; energy max rel "
              f"diff {rel:.3e} (tol {ENERGY_RTOL:g}); {name} launches "
              f"{launches[name]}")
        check(rel <= ENERGY_RTOL, f"fused and generic {kind} ensemble "
              "energies disagree")
        for i in (0, B - 1):
            s = single_run(problems[i], opts, sopts, ENS_WARM,
                           SMALL_ENS_ITERS)
            e1 = energy(s.x.cpu().numpy(), data[i])
            rel1 = abs(e_fused[i] - e1) / abs(e1)
            print(f"{kind} ensemble instance {i} vs a single-instance fused "
                  f"solve: rel diff {rel1:.3e} (tol {ENERGY_RTOL:g})")
            check(rel1 <= ENERGY_RTOL, f"{kind} ensemble instance {i} "
                  "disagrees with its single-instance solve")
        del b, problems, state, gstate
        torch.cuda.empty_cache()
    return launches


def ensemble_turns(kind, b, data, energy, card):
    """The ``kind`` (ml, vol, deblur or tight) ensemble ``b`` with the copying
    batched chunk call (``copying_routes``) and with the light call, in
    turns (copying, light, light, copying): the instance-it/s of each, and
    every instance's energy, which must be equal to the last digit (the
    kernels are bit-equal, the host's scalar work the same)."""
    B = b.batch
    runs = []
    for old in (True, False, False, True):
        if old:
            with copying_routes():
                state, dt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        else:
            state, dt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        x = state.x.cpu().numpy()
        runs.append((B * SMALL_ENS_ITERS / dt,
                     np.array([energy(x[i], data[i]) for i in range(B)])))
    (a, ea), (c, ec), (d, ed), (e, ee) = runs
    same = all(np.array_equal(ea, o) for o in (ec, ed, ee))
    print(f"{kind} ensemble {B} instances in turns: copying batched chunk "
          f"call {a:.1f} instance-it/s, light call {c:.1f}, {d:.1f}, copying "
          f"{e:.1f}; every instance's energy equal in the four runs: {same} "
          f"[{card}]")
    check(same, f"{kind} ensemble: the light and the copying chunk calls "
          "disagree")
    return {"copying": (a, e), "light": (c, d)}


def phase_conv_ensembles(card):
    """deblur8x512 (SMALL_ENS_B frames of config 2 sharing its blur) and
    tight8x128x4 (SMALL_ENS_B instances of tight128x4), each instance with
    its own noise, through BatchedPDHG: the fused batched route, counted
    against the phase plan, then the generic batched path on every
    instance's energy (tight also on its constraint residual and unity
    error, as the single tight solve), and instances 0 and B - 1 against
    single-instance fused solves within SINGLE_RTOL; each also with the
    light call in turns with the copying call (``ensemble_turns``)."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel import BatchedPDHG

    opts, sopts = ens_opts()
    B, L = SMALL_ENS_B, TIGHT_LABELS
    fbs = deblur_frames(B, DB_SIZE, DB_SIZE)
    unaries = tight_ensemble_unaries(B)
    cases = (
        ("deblur", fd, f"deblur{B}x{DB_SIZE}", fbs,
         lambda fb: deblur_model(DB_SIZE, DB_SIZE, fb).finalize(),
         lambda x, fb: (deblur_energy(x, fb, DB_LMB, DB_SIZE, DB_SIZE),)),
        ("tight", ft, f"tight{B}x{TIGHT_SIZE}x{L}", unaries,
         lambda f: tight_model(TIGHT_SIZE, TIGHT_SIZE, L, f).finalize(),
         lambda x, f: tight_measures(x, f, TIGHT_LMB, L, TIGHT_SIZE,
                                     TIGHT_SIZE)))
    launches = {}
    for kind, mod, cell, data, model, measures in cases:
        name = f"{kind}_chunk_batched"
        t0 = time.perf_counter()
        problems = [model(d) for d in data]
        b = BatchedPDHG(problems, opts, sopts)
        check(getattr(b, kind) is not None,
              f"the fused batched {kind} route was not taken")
        print(f"{cell}: set-up {time.perf_counter() - t0:.2f} s; stacked "
              f"leaves {b.batched_problem.paths}")
        mod.reset_launch_counts()
        state, dt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        launches[name] = mod.launch_counts[name]
        # one generic step, two chunks to the end of the warm-up, then one
        # chunk every 10 iterations
        want = 2 + SMALL_ENS_ITERS // 10
        check(launches[name] == want, f"{name} launches {launches[name]}, "
              f"the phase plan has {want}")
        check(state.iteration.tolist() == [ENS_WARM + SMALL_ENS_ITERS] * B
              and not bool(state.converged.any()),
              f"the {cell} ensemble did not run every instance to its end")
        x = state.x.cpu().numpy()
        check(np.all(np.isfinite(x)), f"non-finite {cell} result")
        fused = np.array([measures(x[i], data[i]) for i in range(B)])
        ensemble_turns(cell, b, data, lambda x, d: measures(x, d)[0], card)
        setattr(b, kind, None)  # the generic batched path
        gstate, gdt = ensemble_run(b, ENS_WARM, SMALL_ENS_ITERS)
        gx = gstate.x.cpu().numpy()
        gen = np.array([measures(gx[i], data[i]) for i in range(B)])
        rel = float(np.max(np.abs(fused[:, 0] - gen[:, 0])
                           / np.abs(gen[:, 0])))
        print(f"{cell}: fused {B * SMALL_ENS_ITERS / dt:.1f} instance-it/s, "
              f"generic {B * SMALL_ENS_ITERS / gdt:.1f} [{card}]; {name} "
              f"launches {launches[name]}; energies {fused[:, 0].tolist()}; "
              f"max rel diff to generic {rel:.3e} (tol {ENERGY_RTOL:g})")
        check(rel <= ENERGY_RTOL, f"fused and generic {cell} energies "
              "disagree")
        if kind == "tight":
            for j, what in ((1, "constraint residuals"),
                            (2, "unity errors")):
                worst = float(np.max(np.abs(fused[:, j] - gen[:, j])
                                     / gen[:, j]))
                print(f"{cell}: {what} {fused[:, j].tolist()}, max rel diff "
                      f"to generic {worst:.3e} (tol {TIGHT_MEASURE_RTOL:g})")
                check(worst <= TIGHT_MEASURE_RTOL,
                      f"fused and generic {cell} {what} disagree")
        for i in (0, B - 1):
            s = single_run(problems[i], opts, sopts, ENS_WARM,
                           SMALL_ENS_ITERS)
            e1 = measures(s.x.cpu().numpy(), data[i])[0]
            rel1 = abs(fused[i, 0] - e1) / abs(e1)
            print(f"{cell} instance {i} vs a single-instance fused solve: "
                  f"energy {fused[i, 0]:.8f} vs {e1:.8f}, rel diff "
                  f"{rel1:.3e} (tol {SINGLE_RTOL:g})")
            check(rel1 <= SINGLE_RTOL, f"{cell} instance {i} disagrees with "
                  "its single-instance solve")
        del b, problems, state, gstate
        torch.cuda.empty_cache()
    return launches


def phase_halo_kernels(dev):
    """The halo chunks at full width, bands of 1, 2 and 4 shards."""
    import torch

    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel.spatial_fused import window

    ri = 10
    H = 2 * ri + 2
    # mass on the dead q coordinates, which every version zeroes at entry
    rng = np.random.RandomState(600)
    L, nv = VOL_LABELS, VOL_SIZE
    vol = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(L, nv, nv), 0.3 * rng.randn(3, L, nv, nv),
        rng.rand(L, nv, nv), 2.0 * (rng.rand(L, nv, nv) > 0.3))]
    # name: (halo kernel, plain, whole-plane kernel, planes, the family's
    # two scalars, data term, output planes, bytes and operations of a
    # call on an extended block of nb pixels: the state and the data in,
    # the new and previous state out)
    cases = {
        "rof_chunk_halo": (
            fr.rof_chunk_halo, fr.rof_chunk_halo_plain, fr.rof_chunk,
            kernel_inputs(512, 512, 601, dev), [8.0, 1.0], ("square",), 4,
            lambda nb: (10 * nb * 4,
                        nb * (ri * ROF_ITER_OPS + ROF_NORM_OPS))),
        "ml_chunk_halo": (
            fm.ml_chunk_halo, fm.ml_chunk_halo_plain, fm.ml_chunk,
            ml_kernel_inputs(ML_LABELS, ML_SIZE, ML_SIZE, 602, dev),
            [ML_LMB, 1.0], (), 6,
            lambda nb: ((10 * ML_LABELS + 3) * nb * 4,
                        ml_chunk_ops(nb, ML_LABELS, ri))),
        "vol_chunk_halo": (
            fv.vol_chunk_halo, fv.vol_chunk_halo_plain, fv.vol_chunk, vol,
            [VOL_LMB, 1.0], ("square",), 4,
            lambda nb: (13 * L * nb * 4, vol_chunk_ops(L * nb, ri))),
    }
    rows = {}
    for name, (halo, plain, whole, planes, two, extra, n, cost) in (
            cases.items()):
        nx, ny = planes[0].shape[-2:]
        head = [0.9, 1.1, 1.0] + two
        ref = whole(*planes, torch.tensor(head, device=dev), ri, *extra)
        err = 0.0
        for shards in HALO_SHARDS:
            rs = nx // shards
            total = torch.zeros(4, dtype=torch.float64, device=dev)
            for rank in range(shards):
                lo = rank * rs - H
                ext = [window(a, lo, lo + rs + 2 * H) for a in planes]
                scal = torch.tensor(head + [lo, H, H + rs], device=dev)
                out = halo(*ext, scal, ri, nx, *extra)
                want = plain(*ext, scal, ri, nx, *extra)
                torch.cuda.synchronize()
                plane, rel = max_errs(out, want, n_planes=n)
                err = max(err, plane)
                owned = all(torch.equal(a[..., H:H + rs, :],
                                        b[..., rank * rs:(rank + 1) * rs, :])
                            for a, b in zip(out[:n], ref[:n]))
                print(f"{name} {nx}x{ny} band {rank} of {shards}: max abs "
                      f"err planes {plane:.3e} (tol {PLANE_ATOL:g}), max rel "
                      f"err norms {rel:.3e} (tol {NORM_RTOL:g}); owned rows "
                      f"{'bit-equal to' if owned else 'DIFFER from'} the "
                      "whole-plane kernel")
                check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
                      f"{name} disagrees with its plain version")
                check(owned, f"{name}: a band's owned rows differ from the "
                      "whole-plane kernel")
                check(all(bool(torch.isfinite(t).all()) for t in out),
                      f"{name} produced non-finite values")
                total += out[n].double()
                if shards == 1:
                    rows[name] = {
                        "plain_ms": time_ms(lambda: plain(*ext, scal, ri, nx,
                                                          *extra), 10),
                        "bound": bound(*cost(ext[0].shape[-2] * ny))}
                    timed(rows[name], lambda: halo(*ext, scal, ri, nx,
                                                   *extra), 50)
            rel = float(torch.max(torch.abs(total - ref[n].double())
                                  / torch.abs(ref[n].double())))
            print(f"{name} {nx}x{ny}: owned-row norms of {shards} bands "
                  f"against the whole plane's: max rel diff {rel:.3e} (tol "
                  f"{HALO_NORM_RTOL:g})")
            check(rel <= HALO_NORM_RTOL, f"{name}: the bands' norms do not "
                  "sum to the whole plane's")
        rows[name]["err"] = err
        r = rows[name]
        print(f"{name} {nx}x{ny} one shard ({nx + 2 * H} rows): kernel "
              f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows


def phase_halo_8b_kernels(dev):
    """The halo modes of slice 8b at full width, bands of 1, 2 and 4
    shards: ``deblur_chunk_halo`` at config 2's shape (512x512, the 9x9
    motion blur, bands of the 520 rows of its full-convolution grid; ri 10,
    halo 154, and ri 5, halo 84, for 4 shards of 130 rows),
    ``tight_chunk_halo`` at 128x128x4 (ri 10, halo 22) and
    ``admm_iter_halo`` at 512x512 (Chebyshev degree 10, halo 24) with and
    without the norms; each against its plain version, the owned rows
    against the whole-plane kernel (``deblur_chunk``, ``tight_chunk``,
    ``admm_chunk`` with count 1), the bands' norms summed against its
    norms; timed at the one-shard band (ADMM in place without the norms,
    the variant of 9 of a chunk's 10 iterations; ``admm_halo_turns``)."""
    import torch

    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel.spatial_fused import window

    rng = np.random.RandomState(610)
    # deblur: x, yv, q, fb, sv of config 2's shape
    n, kern = DB_SIZE, motion_kernel(DB_KLEN)
    n2 = n + DB_KLEN - 1
    taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
    deblur = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(n, n), rng.randn(n2, n2), 0.3 * rng.randn(2, n, n),
        rng.rand(n2, n2), 0.5 + rng.rand(n2, n2))]
    # tight: u, v, q, p, s, f of tight128x4
    L, nt = TIGHT_LABELS, TIGHT_SIZE
    k = L * (L - 1) // 2
    pt_ = pair_matrix(L).T
    ttaps = tuple((r, m, float(pt_[r, m])) for r in range(2 * L)
                  for m in range(2 * k) if pt_[r, m] != 0.0)
    tconsts = tuple(float(np.float32(c))
                    for c in (1 / (L + 1), 1.0, 1 / L, 0.2, 1 / 3))
    tight = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(L, nt, nt), 0.1 * rng.randn(2 * k, nt, nt),
        0.2 * rng.randn(2 * L, nt, nt), 0.1 * rng.randn(2 * k, nt, nt),
        0.1 * rng.randn(nt, nt), rng.rand(L, nt, nt))]
    admm = admm_kernel_inputs(ROF_SIZE, ROF_SIZE, 611, dev)
    degree, alpha = 10, 1.7

    def deblur_call(fn, ext, scal, ri):
        return fn(*ext, scal, ri, n, taps, 0.5, 0.2)

    def tight_call(fn, ext, scal, ri):
        return fn(*ext, scal, ri, nt, ttaps, tconsts)

    # name: (halo kernel, plain, whole-plane call (ri), planes, rows of the
    # partitioned grid, ri and halo by shard count, head of scal, planes
    # out, bytes and operations of the one-shard band)
    cases = {
        "deblur_chunk_halo": (
            lambda e, s, ri: deblur_call(fd.deblur_chunk_halo, e, s, ri),
            lambda e, s, ri: fd.deblur_chunk_plain(*e, s, ri, taps, 0.5,
                                                   0.2, n),
            lambda ri: fd.deblur_chunk(*deblur, torch.tensor(
                [0.9, 1.1, 1.0, DB_LMB, 1.0], device=dev), ri, taps, 0.5,
                0.2),
            deblur, n2,
            {s: (ri, fd.deblur_halo_rows(ri, taps))
             for s, ri in ((1, 10), (2, 10), (4, 5))},
            [0.9, 1.1, 1.0, DB_LMB, 1.0], 6,
            # x, yv, q, fb, sv, taps in; new and previous x, yv, q out; the
            # x-plane work on the image's rows of the band
            lambda rows: ((9 * rows * n + 5 * rows * n2 + 3 * len(taps)) * 4,
                          deblur_chunk_ops(n * n, rows * n2, len(taps), 10))),
        "tight_chunk_halo": (
            lambda e, s, ri: tight_call(ft.tight_chunk_halo, e, s, ri),
            lambda e, s, ri: tight_call(ft.tight_chunk_halo_plain, e, s, ri),
            lambda ri: ft.tight_chunk(*tight, torch.tensor(
                [0.9, 1.1, 1.0, TIGHT_LMB, 1.0], device=dev), ri, ttaps,
                tconsts),
            tight, nt, {s: (10, 22) for s in HALO_SHARDS},
            [0.9, 1.1, 1.0, TIGHT_LMB, 1.0], 10,
            lambda rows: (((10 * L + 12 * k + 3) * rows * nt + 4 * len(ttaps)
                           + 2 * L + 2 * k + 2) * 4,
                          tight_chunk_ops(rows * nt, L, k, len(ttaps), 10))),
        "admm_iter_halo": (
            None, None,
            lambda ri: fa.admm_chunk(*admm, torch.tensor(
                [1.3, 8.0, 1.0], device=dev), None, 1, 0, alpha, "square",
                degree),
            admm, ROF_SIZE,
            {s: (degree, fa.admm_cheby_halo_rows(degree))
             for s in HALO_SHARDS},
            None, 7,
            # xh, xp, xd, zh, zd, warm, f in (z_proj is only written), the
            # seven state arrays out: 19 planes; no norms
            lambda rows: (19 * rows * ROF_SIZE * 4,
                          rows * ROF_SIZE * admm_iter_ops(degree))),
    }
    rows_out = {}
    for name, (halo, plain, whole, planes, grid, geo, head, n_out,
               cost) in cases.items():
        err = 0.0
        ny = planes[0].shape[-1]
        nxg = planes[0].shape[-2]  # the image's rows
        wholes = {}
        for shards in HALO_SHARDS:
            ri, H = geo[shards]
            if ri not in wholes:
                wholes[ri] = whole(ri)
            ref = wholes[ri]
            rs = grid // shards
            total = torch.zeros(4, dtype=torch.float64, device=dev)
            for rank in range(shards):
                lo = rank * rs - H
                ext = [window(a, lo, lo + rs + 2 * H) for a in planes]
                if name == "admm_iter_halo":
                    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
                    tail = (ri, alpha, nxg, lo, H, H + rs, "square")
                    outs = [fa.admm_iter_halo(*ext, scal, *tail,
                                              with_norms=wn)
                            for wn in (True, False)]
                    wants = [fa.admm_iter_halo_plain(*ext, scal, *tail,
                                                     with_norms=wn)
                             for wn in (True, False)]
                    # the route's call: in place on its buffers
                    cur = [t.clone() for t in ext[:n_out]]
                    call = (lambda cur=cur, ext=ext, scal=scal, tail=tail:
                            fa.admm_iter_halo_(*cur, *ext[n_out:], scal,
                                               *tail, with_norms=False))
                    plain_call = (lambda ext=ext, scal=scal, tail=tail:
                                  fa.admm_iter_halo_plain(
                                      *ext, scal, *tail, with_norms=False))
                else:
                    scal = torch.tensor(head + [lo, H, H + rs], device=dev)
                    outs = [halo(ext, scal, ri)]
                    wants = [plain(ext, scal, ri)]
                    call = (lambda ext=ext, scal=scal, ri=ri:
                            halo(ext, scal, ri))
                    plain_call = (lambda ext=ext, scal=scal, ri=ri:
                                  plain(ext, scal, ri))
                torch.cuda.synchronize()
                for out, want in zip(outs, wants):
                    if name == "admm_iter_halo":
                        plane, rel = max_errs(out, want, n_planes=n_out)
                    else:
                        plane, rel = scaled_errs(out, want, n_out)
                    err = max(err, plane)
                    owned = all(torch.equal(a[..., H:H + rs, :],
                                            window(b, rank * rs,
                                                   (rank + 1) * rs))
                                for a, b in zip(out[:n_out], ref[:n_out]))
                    print(f"{name} band {rank} of {shards} (ri {ri}, halo "
                          f"{H}): max abs err planes {plane:.3e} (tol "
                          f"{PLANE_ATOL:g}), max rel err norms {rel:.3e} "
                          f"(tol {NORM_RTOL:g}); owned rows "
                          f"{'bit-equal to' if owned else 'DIFFER from'} "
                          "the whole-plane kernel")
                    check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
                          f"{name} disagrees with its plain version")
                    check(owned, f"{name}: a band's owned rows differ from "
                          "the whole-plane kernel")
                    check(all(bool(torch.isfinite(t).all()) for t in out),
                          f"{name} produced non-finite values")
                if name == "admm_iter_halo":
                    check(not bool(outs[1][n_out].any()),
                          "admm_iter_halo without norms returned norms")
                total += outs[0][n_out].double()
                if shards == 1 and name == "admm_iter_halo":
                    admm_halo_turns(ext, scal, tail)
                if shards == 1:
                    rows_out[name] = {
                        "plain_ms": time_ms(plain_call, 10),
                        "bound": bound(*cost(ext[0].shape[-2])),
                        "band": f"{ext[0].shape[-2]} rows"}
                    timed(rows_out[name], call, 50)
            rel = float(torch.max(torch.abs(total - ref[n_out].double())
                                  / torch.abs(ref[n_out].double())))
            print(f"{name}: owned-row norms of {shards} bands against the "
                  f"whole plane's: max rel diff {rel:.3e} (tol "
                  f"{HALO_NORM_RTOL:g})")
            check(rel <= HALO_NORM_RTOL, f"{name}: the bands' norms do not "
                  "sum to the whole plane's")
        r = rows_out[name]
        r["err"] = err
        print(f"{name} one shard ({r['band']}): kernel {r['ms']:.4f} "
              f"ms/call, plain {r['plain_ms']:.4f} ms/call, bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows_out


def phase_tiled_rof(dev):
    """Rows 6 and 5 tiled (``rof_tiled``: one launch a chunk over
    overlapping 2-D windows of the planes) against the streaming launch
    sequences they replace at the planes no grid-resident band holds, ri
    10: ``rof_chunk_`` at 2048x2048 (square, wsquare, abs), 2048x1536 and
    1000x777 (tiles that do not divide it), and ``rof_chunk_halo_`` on the
    2092x2048 band of one shard of a 2048-wide plane (square, wsquare),
    from planes with mass on the dead duals: planes, previous iterates and
    squared norms bit-equal, and within PLANE_ATOL / NORM_RTOL of the
    plain versions; ``rof_multichunk_`` at 2048x2048 (8 chunks under boyd,
    3 under alg1), 2048x1536 (boyd, 8) and 1000x777 (alg1, 3), every chunk
    run, and from a solve's start (x = f = the test image, q = 0) at
    tolerances at which boyd converges partway, after an odd and after an
    even number of chunks: planes, previous iterates, norms and sout
    bit-equal, and the solve's start within PLANE_ATOL / MC_NORM_RTOL of
    the plain version; each path's light call (``ROFChunk``,
    ``ROFMultichunk``) in place on buffers made once, in turns (streaming,
    tiled, tiled, streaming), with the hand-written kernels each launches
    per call and their traced device ms, at 2048x2048, 2048x1536 and on
    the band; the tiled chunk's time at 2048x2048 for other tiles than the
    rule's; the functional wrappers' calls and the plain versions timed
    for the kernels line."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, scalar_buffer
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, nan = 10, float("nan")
    rows = {"rof_chunk_tiled": {"err": 0.0},
            "rof_multichunk_tiled": {"err": 0.0}}
    scal = torch.tensor([0.9, 1.1, 1.0, ROF_LMB, 1.0], device=dev)
    sms, tsmem = fr.card_sms(dev), fr.tiled_limit(dev)

    def consts_of(nx, ny):
        return (np.sqrt(2 * nx * ny), np.sqrt(nx * ny), 1.5, 0.95, 1.05,
                0.8)

    def mscal(tol, tau=0.9, sigma=1.1):
        return torch.tensor([tau, sigma, 1.0, ROF_LMB, 1.0, 0.5, 0.0, 0.0,
                             1.0, tol, tol, tol, tol], device=dev)

    def both(label, fn, state, data, *args):
        """``fn`` in place on copies of ``state`` by each path: the tiled
        outputs, checked bit-equal to the streaming ones."""
        got = {}
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in state]
            prev = [torch.full_like(t, nan) for t in cur]
            out = fn(*cur, *prev, *data, *args, path=path)
            out = list(out) if isinstance(out, tuple) else [out]
            got[path] = cur + prev + [t.clone() for t in out]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["tiled"]))
              and all(bool(torch.isfinite(t).all()) for t in got["tiled"]),
              f"{label}: the tiled launch is not the launch sequence")
        return got["tiled"]

    def against_plain(label, out, ref, norm_tol):
        plane, rel = max_errs(out, ref)
        print(f"{label}: against the plain version max abs err planes "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
              f"{rel:.3e} (tol {norm_tol:g})")
        check(plane <= PLANE_ATOL and rel <= norm_tol,
              f"{label} disagrees with its plain version")
        return plane

    seed = 700
    for nx, ny, terms in ((2048, 2048, ("square", "wsquare", "abs")),
                          (2048, 1536, ("square",)),
                          (1000, 777, ("square", "abs"))):
        for dataterm in terms:
            x, q, f, w = kernel_inputs(nx, ny, seed, dev)
            seed += 1
            label = (f"rof_chunk_ {nx}x{ny} {dataterm}, tile "
                     f"{fr.tiled_tile(nx, ny, ri, dataterm, sms, tsmem)}")
            out = both(label, fr.rof_chunk_, [x, q], [f, w], scal, ri,
                       dataterm)
            print(f"{label}: tiled bit-equal to the launch sequence in the "
                  "planes, the previous iterates and the squared norms")
            err = against_plain(label, out, fr.rof_chunk_plain(
                x, q, f, w, scal, ri, dataterm), NORM_RTOL)
            rows["rof_chunk_tiled"]["err"] = max(
                rows["rof_chunk_tiled"]["err"], err)
    n, H = 2048, 2 * ri + 2
    band = [window(a, -H, n + H) for a in kernel_inputs(n, n, seed, dev)]
    bscal = torch.tensor([0.9, 1.1, 1.0, ROF_LMB, 1.0, -H, H, H + n],
                         device=dev)
    for dataterm in ("square", "wsquare"):
        label = (f"rof_chunk_halo_ {n + 2 * H}x{n} band {dataterm}, tile "
                 f"{fr.tiled_tile(n + 2 * H, n, ri, dataterm, sms, tsmem)}")
        out = both(label, fr.rof_chunk_halo_, band[:2], band[2:], bscal, ri,
                   n, dataterm)
        print(f"{label}: tiled bit-equal to the launch sequence in the "
              "planes, the previous iterates and the owned-row norms")
        against_plain(label, out, fr.rof_chunk_halo_plain(
            *band, bscal, ri, n, dataterm), NORM_RTOL)

    for nx, ny, stepsize, k, dataterm in (
            (2048, 2048, "boyd", 8, "square"),
            (2048, 2048, "alg1", 3, "wsquare"),
            (2048, 1536, "boyd", 8, "square"),
            (1000, 777, "alg1", 3, "abs")):
        x, q, f, w = kernel_inputs(nx, ny, seed, dev)
        seed += 1
        label = f"rof_multichunk_ {nx}x{ny} {dataterm} {stepsize}, {k} chunks"
        out = both(label, fr.rof_multichunk_, [x, q], [f, w], mscal(0.0),
                   ri, k, dataterm, stepsize, consts_of(nx, ny))
        check(out[5][6].item() == k, f"{label}: not every chunk ran")
        print(f"{label}: tiled bit-equal to the launch sequence in the "
              "planes, the previous iterates, the norms and sout")
    nx = ny = 2048
    fimg = torch.from_numpy(test_image(nx, ny)).to(dev)
    zero = torch.zeros((2, nx, ny), device=dev)
    wone = torch.ones_like(fimg)
    seen = {}
    for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4):
        sc = mscal(tol, 1.0, 1.0)
        out = both(f"rof_multichunk_ {nx}x{ny} from a solve's start, tol "
                   f"{tol:g}", fr.rof_multichunk_, [fimg, zero], [fimg, wone],
                   sc, ri, 8, "square", "boyd", consts_of(nx, ny))
        done = int(out[5][6].item())
        if out[5][5].item() == 1.0 and done < 8:
            seen.setdefault(done % 2, (tol, done))
        if len(seen) == 2:
            break
    check(len(seen) == 2, f"rof_multichunk_ {nx}x{ny}: no tolerances "
          f"converged after an odd and an even number of chunks ({seen})")
    print(f"rof_multichunk_ {nx}x{ny} from a solve's start: tiled bit-equal "
          f"to the launch sequence converging partway at (tolerance, "
          f"chunks) {sorted(seen.values())}")
    sc = mscal(0.0, 1.0, 1.0)
    out = fr.rof_multichunk(fimg, zero, fimg, wone, sc, ri, 8, "square",
                            "alg1", consts_of(nx, ny))
    rows["rof_multichunk_tiled"]["err"] = against_plain(
        f"rof_multichunk {nx}x{ny} alg1, 8 chunks, from a solve's start",
        out, fr.rof_multichunk_plain(fimg, zero, fimg, wone, sc, ri, 8,
                                     "square", "alg1", consts_of(nx, ny)),
        MC_NORM_RTOL)

    # the light calls in place, in turns
    def light_turns(label, nx, ny, band=None, reps=20):
        planes = kernel_inputs(nx, ny, 790, dev)
        if band is not None:
            planes = [window(a, -H, nx + H) for a in planes]
        x, q, f, w = planes
        m = {"nx": nx, "ny": ny, "f": f, "w": w, "dataterm": "square",
             "lmb": ROF_LMB, "radius": 1.0,
             "lmb_t": torch.tensor(ROF_LMB, device=dev),
             "radius_t": torch.tensor(1.0, device=dev),
             "tols_t": tuple(torch.tensor(0.0, device=dev)
                             for _ in range(4)),
             "adapt_consts": consts_of(nx, ny)}
        steps = [torch.tensor(v, device=dev)
                 for v in (0.9, 1.1, 1.0, 0.5, 0.0, 0.0)]
        it0, flag = torch.tensor(1, device=dev), torch.tensor(False,
                                                              device=dev)
        bufs = {p: ([x.clone(), q.clone()], [x.clone(), q.clone()])
                for p in ("streaming", "tiled")}
        out = {}
        for what in ("chunk",) if band else ("chunk", "multichunk"):
            calls = {}
            for p in ("streaming", "tiled"):
                if what == "chunk":
                    call = fr.ROFChunk(m, ri, dev, band, path=p)
                    calls[p] = (lambda c=call, b=bufs[p]:
                                c(*b, f, w, *steps[:3], flag))
                else:
                    call = fr.ROFMultichunk(m, ri, 8, "boyd", dev, path=p)
                    calls[p] = (lambda c=call, b=bufs[p]:
                                c(*b, *steps, it0, flag))
            (o1, o2), (t1, t2) = in_turns(calls["streaming"], calls["tiled"],
                                          reps)
            # whole traces: a chunk streams in 23 launches and tiles in 3
            # (the finish and the copy back), 8 chunks in 177 and 17
            k = 1 if what == "chunk" else 8
            ts = traced_until(calls["streaming"],
                              lambda c, k=k: len(c) == 22 * k + 1)
            tt = traced_until(calls["tiled"], lambda c, k=k: (
                c.count("rof_tiled") == k and len(c) == 2 * k + 1))
            got = counted(fr, calls["tiled"])
            check(got.get(f"rof_{what}_tiled") == 1 and set(tt["csrc"]) <= {
                "rof_tiled", "pdhg_finish", "rof_tiled_settle"},
                f"{label} {what}: the tiled call launched {tt['csrc']} "
                f"(counted {got})")
            print(f"{label} {what} light call in place, in turns: streaming "
                  f"{o1:.4f} ms, tiled {t1:.4f}, tiled {t2:.4f}, streaming "
                  f"{o2:.4f} ms/call; traced device ms: streaming "
                  f"{fmt_ms(ts['csrc_ms'])} ({len(ts['csrc'])} hand-written "
                  f"launches), tiled {fmt_ms(tt['csrc_ms'])} "
                  f"({len(tt['csrc'])}: {tt['csrc'].count('rof_tiled')} "
                  f"rof_tiled), PyTorch {fmt_ms(tt['torch_ms'])} ms in "
                  f"{tt['torch_kernels']} kernels")
            out[what] = {"streaming_ms": (o1, o2), "tiled_ms": (t1, t2),
                         "device_ms": (ts["csrc_ms"], tt["csrc_ms"]),
                         "launches": (len(ts["csrc"]), len(tt["csrc"]))}
        return out

    turns = {"2048x2048": light_turns("2048x2048", 2048, 2048),
             "2048x1536": light_turns("2048x1536", 2048, 1536),
             "band": light_turns(f"{n + 2 * H}x{n} band", n, n,
                                 (n, n + 2 * H, -H, H, H + n))}

    # the tiled chunk at 2048x2048 with other tiles than the rule's
    x, q, f, w = kernel_inputs(n, n, 791, dev)
    rule = fr.tiled_tile(n, n, ri, "square", sms, tsmem)
    sweep = {}
    for tile in (rule, (64, 64), (32, 64), (64, 32), (128, 32), (32, 128),
                 (48, 96), (16, 224), (144, 64)):
        if not fr.tiled_fits(*tile, ri, "square", tsmem) or tile in sweep:
            continue
        cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * fr._lib().prost_rof_num_blocks(n, n),
                              device=dev)
        scratch = fr._scratch("tiled", n, n, dev)
        sweep[tile] = time_ms(
            lambda: fr._launch_chunk("rof_chunk", cur, prev, f, w, sc,
                                     partial, scratch, ("tiled", tile), ri,
                                     "square"), 20)
    print(f"rof_chunk_ {n}x{n} tiled, ms a call (tiled launch, finish, copy "
          f"back; CUDA events) by tile (rows, columns), the rule's "
          f"{rule} first: " + ", ".join(f"{t}: {v:.4f}"
                                        for t, v in sweep.items()))
    # the rule's tile at count 1 (a window 3 pixels wider than the tile
    # each way, not 21) against count 10: about the call's fixed cost
    # (load, store, finish, copy back) and what an iteration adds
    per_count = {}
    for count in (1, ri):
        cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * fr._lib().prost_rof_num_blocks(n, n),
                              device=dev)
        scratch = fr._scratch("tiled", n, n, dev)
        per_count[count] = time_ms(
            lambda: fr._launch_chunk("rof_chunk", cur, prev, f, w, sc,
                                     partial, scratch, ("tiled", rule),
                                     count, "square"), 20)
    print(f"rof_chunk_ {n}x{n} tiled, tile {rule}, ms a call (CUDA events): "
          f"{per_count[1]:.4f} at count 1, {per_count[ri]:.4f} at count "
          f"{ri}: {(per_count[ri] - per_count[1]) / (ri - 1):.5f} ms an "
          f"iteration")

    # the kernels line: the functional wrappers at 2048x2048, square
    x, q, f, w = kernel_inputs(n, n, 792, dev)
    r = rows["rof_chunk_tiled"]
    timed(r, lambda: fr.rof_chunk(x, q, f, w, scal, ri), 20,
          lambda c: c.count("rof_tiled") == 1 and len(c) == 3, fr)
    r["plain_ms"] = time_ms(lambda: fr.rof_chunk_plain(x, q, f, w, scal, ri),
                            3)
    r["bound"] = bound(10 * n * n * 4,
                       n * n * (ri * ROF_ITER_OPS + ROF_NORM_OPS))
    r = rows["rof_multichunk_tiled"]
    sc = mscal(0.0, 1.0, 1.0)
    timed(r, lambda: fr.rof_multichunk(fimg, zero, fimg, wone, sc, ri, 8,
                                       "square", "alg1", consts_of(n, n)),
          10, lambda c: c.count("rof_tiled") == 8 and len(c) == 17, fr)
    r["plain_ms"] = time_ms(lambda: fr.rof_multichunk_plain(
        fimg, zero, fimg, wone, sc, ri, 8, "square", "alg1",
        consts_of(n, n)), 2)
    r["bound"] = bound(10 * n * n * 4,
                       8 * n * n * (ri * ROF_ITER_OPS + ROF_NORM_OPS))
    for name, r in rows.items():
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch rof_tiled "
              f"(counted {r['counted']})")
        print(f"{name} {n}x{n}: wrapper {r['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    rows["rof_chunk_tiled"]["turns"] = turns
    rows["rof_chunk_tiled"]["sweep"] = {str(k): v for k, v in sweep.items()}
    return rows


def phase_tiled_admm(dev):
    """Row 11 tiled (``admm_tiled``: a cooperative launch a chunk over
    overlapping 2-D windows of the planes, a grid barrier an iteration)
    against the streaming launch sequences it replaces at the planes no
    grid-resident band holds, Chebyshev degree 10: ``admm_chunk_`` at
    2048x2048 (square, wsquare, abs at ri 10, square at an odd count of 3)
    and 1000x777 (tiles that do not divide it; square, abs), from planes
    with mass on the dead duals: planes and squared norms bit-equal, and
    within PLANE_ATOL / NORM_RTOL of the plain versions; at 70x53 (every
    window's map meets an edge) and at degrees 1 and 43 at 2048x2048
    (count 3): bit-equal;
    ``admm_multichunk_`` at 2048x2048 (8 chunks of ri 10, square; 3 chunks
    of an odd count of 3, wsquare) and 1000x777 (3 chunks, abs), every
    chunk run, and from a solve's start (x_half = f = the test image) at
    tolerances at which rho adapts (a pending dual rescale other than 1
    folded into a later chunk's loads) and the multichunk converges
    partway, at counts 10 and 3: planes, norms and sout bit-equal, and the
    solve's start within PLANE_ATOL / MC_NORM_RTOL of the plain version;
    each path's light call (``ADMMChunk``, ``ADMMMultichunk``) in place on
    buffers made once, in turns (streaming, tiled, tiled, streaming), with
    the hand-written kernels each launches per call and their traced device
    ms; the functional wrappers' calls and the plain versions timed for
    the kernels line, beside the bound and the design's floor of one pass
    over device memory an iteration."""
    import torch

    from prost_tpu_torch.ops import fused_admm as fa

    ri, alpha, degree = 10, 1.7, 10
    rows = {"admm_chunk_tiled": {"err": 0.0},
            "admm_multichunk_tiled": {"err": 0.0}}
    sms, tsmem = fa.admm_card_limits(dev)[0], fa.admm_tiled_limit(dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)

    def consts_of(nx, ny):
        return (np.sqrt(2 * nx * ny), np.sqrt(nx * ny), 0.8, 1.01)

    def mscal(tol, rho=1.0):
        return torch.tensor([rho, ROF_LMB, 1.0, 1.05, 0.0, 0.0, 0.0, tol, tol,
                             tol, tol], device=dev)

    def both(label, fn, planes, data, *args):
        """``fn`` in place on copies of ``planes`` by each path: the tiled
        outputs, checked bit-equal to the streaming ones."""
        got = {}
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes]
            out = fn(*cur, *data, *args, path=path)
            out = list(out) if isinstance(out, tuple) else [out]
            got[path] = cur + [t.clone() for t in out]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["tiled"]))
              and all(bool(torch.isfinite(t).all()) for t in got["tiled"]),
              f"{label}: the tiled launch is not the launch sequence")
        return got["tiled"]

    def against_plain(label, out, ref, norm_tol):
        plane, rel = max_errs(out, ref, n_planes=7)
        print(f"{label}: against the plain version max abs err planes "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
              f"{rel:.3e} (tol {norm_tol:g})")
        check(plane <= PLANE_ATOL and rel <= norm_tol,
              f"{label} disagrees with its plain version")
        return plane

    seed = 900
    for nx, ny, count, terms in ((2048, 2048, ri, ("square", "wsquare",
                                                   "abs")),
                                 (2048, 2048, 3, ("square",)),
                                 (1000, 777, ri, ("square", "abs"))):
        for dataterm in terms:
            *planes, f, w = admm_kernel_inputs(nx, ny, seed, dev)
            seed += 1
            route = fa.admm_pick_route(None, nx, ny, dataterm, degree, dev,
                                       "admm_chunk")
            check(route[0] == "tiled", f"admm_chunk_ {nx}x{ny} {dataterm}: "
                  f"the shape rule takes {route}")
            label = (f"admm_chunk_ {nx}x{ny} {dataterm} count {count}, tile "
                     f"{route[1]}")
            out = both(label, fa.admm_chunk_, planes, [f, w], scal, None,
                       count, 0, alpha, dataterm, degree)
            print(f"{label}: tiled bit-equal to the launch sequence in the "
                  "planes and the squared norms")
            err = against_plain(label, out, fa.admm_chunk_plain(
                *planes, f, w, scal, None, count, 0, alpha, dataterm,
                degree), NORM_RTOL)
            rows["admm_chunk_tiled"]["err"] = max(
                rows["admm_chunk_tiled"]["err"], err)

    # every window's map meeting an edge (70x53), and the shallowest and
    # deepest degrees the rule tiles at 2048x2048 (interior and edge
    # windows)
    for nx, ny, deg in ((70, 53, 10), (2048, 2048, 1), (2048, 2048, 43)):
        *planes, f, w = admm_kernel_inputs(nx, ny, seed, dev)
        seed += 1
        tile = fa.admm_pick_route("tiled", nx, ny, "square", deg, dev,
                                  "admm_chunk")[1]
        label = (f"admm_chunk_ {nx}x{ny} square count 3 degree {deg}, tile "
                 f"{tile}")
        both(label, fa.admm_chunk_, planes, [f, w], scal, None, 3, 0, alpha,
             "square", deg)
        print(f"{label}: tiled bit-equal to the launch sequence in the "
              "planes and the squared norms")

    for nx, ny, count, k, dataterm in ((2048, 2048, ri, 8, "square"),
                                       (2048, 2048, 3, 3, "wsquare"),
                                       (1000, 777, ri, 3, "abs")):
        *planes, f, w = admm_kernel_inputs(nx, ny, seed, dev)
        seed += 1
        label = (f"admm_multichunk_ {nx}x{ny} {dataterm}, {k} chunks of "
                 f"{count}")
        out = both(label, fa.admm_multichunk_, planes, [f, w],
                   mscal(0.0, 1.3), count, k, alpha, degree,
                   consts_of(nx, ny), dataterm)
        check(out[8][5].item() == k, f"{label}: not every chunk ran")
        print(f"{label}: tiled bit-equal to the launch sequence in the "
              "planes, the norms and sout")

    # from a solve's start: rho adapts before the last executed chunk (its
    # rescale folded into the next chunk's loads) and the launch converges
    # partway
    nx = ny = 2048
    n = nx * ny
    fimg = torch.from_numpy(test_image(nx, ny)).to(dev)
    zero = torch.zeros_like(fimg)
    z = torch.zeros((2, nx, ny), device=dev)
    start = [fimg, zero, zero, z, z, z, zero]
    for count in (ri, 3):
        seen = []
        for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4):
            out = both(f"admm_multichunk_ {nx}x{ny} from a solve's start, "
                       f"count {count}, tol {tol:g}", fa.admm_multichunk_,
                       start, [fimg, fimg], mscal(tol), count, 8, alpha,
                       degree, consts_of(nx, ny))
            sout = out[8].tolist()
            done = int(sout[5])
            # at most one adaptation a chunk, each by delta >= 1.05 (delta
            # grows): a rho beyond 1.05^1.5 adapted at least twice, so at
            # least once before the last executed chunk
            twice = abs(np.log(sout[0])) > 1.5 * np.log(1.05)
            if sout[4] == 1.0 and done < 8 and twice:
                seen.append((tol, done, sout[0]))
            if len(seen) == 2:
                break
        check(seen, f"admm_multichunk_ {nx}x{ny} count {count}: no tolerance "
              "adapted rho before a partway convergence")
        print(f"admm_multichunk_ {nx}x{ny} from a solve's start, count "
              f"{count}: tiled bit-equal to the launch sequence, rho adapted "
              f"before the last executed chunk and converging partway at "
              f"(tolerance, chunks, rho) {seen}")
    sc = mscal(0.0)
    out = fa.admm_multichunk(*start, fimg, fimg, sc, ri, 8, alpha, degree,
                             consts_of(nx, ny))
    rows["admm_multichunk_tiled"]["err"] = against_plain(
        f"admm_multichunk {nx}x{ny}, 8 chunks, from a solve's start", out,
        fa.admm_multichunk_plain(*start, fimg, fimg, sc, ri, 8, alpha,
                                 degree, consts_of(nx, ny)), MC_NORM_RTOL)

    # the light calls in place, in turns
    *planes, f, w = admm_kernel_inputs(nx, ny, 990, dev)
    r = {"nx": nx, "ny": ny, "f": f, "w": w, "dataterm": "square",
         "lmb_t": scal[1], "radius_t": scal[2],
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "consts": consts_of(nx, ny)}
    s4 = [torch.tensor(v, device=dev) for v in (1.3, 1.05, 0.0, 0.0)]
    it0, flag = torch.tensor(0, device=dev), torch.tensor(False, device=dev)
    turns = {}
    for what, k in (("chunk", 1), ("multichunk", 8)):
        calls = {}
        for p in ("streaming", "tiled"):
            buf = [t.clone() for t in planes]
            if what == "chunk":
                call = fa.ADMMChunk(r, ri, alpha, degree, dev, path=p)
                calls[p] = (lambda c=call, b=buf: c(b, s4[0], flag))
            else:
                call = fa.ADMMMultichunk(r, ri, 8, alpha, degree, dev,
                                         path=p)
                calls[p] = (lambda c=call, b=buf: c(b, *s4, it0, flag))
            check(call.route[0] == p, f"admm {what}: the light call took "
                  f"{call.route}, not {p}")
        (o1, o2), (t1, t2) = in_turns(calls["streaming"], calls["tiled"],
                                      10 if k > 1 else 20)
        # whole traces: a chunk streams in 123 launches and tiles in 2
        # (the finish), 8 chunks in 985 and 17 (and the copy back)
        ts = traced_until(calls["streaming"],
                          lambda c, k=k: len(c) == 123 * k + (k > 1))
        tt = traced_until(calls["tiled"], lambda c, k=k: (
            c.count("admm_tiled") == k and len(c) == 2 * k + (k > 1)))
        got = counted(fa, calls["tiled"])
        check(got.get(f"admm_{what}_tiled") == 1
              and set(tt["csrc"]) <= {"admm_tiled", "admm_finish",
                                      "admm_tiled_settle"},
              f"admm {what}: the tiled call launched {tt['csrc']} (counted "
              f"{got})")
        print(f"admm {what} {nx}x{ny} light call in place, in turns: "
              f"streaming {o1:.4f} ms, tiled {t1:.4f}, tiled {t2:.4f}, "
              f"streaming {o2:.4f} ms/call; traced device ms: streaming "
              f"{fmt_ms(ts['csrc_ms'])} ({len(ts['csrc'])} hand-written "
              f"launches), tiled {fmt_ms(tt['csrc_ms'])} ({len(tt['csrc'])}: "
              f"{tt['csrc'].count('admm_tiled')} admm_tiled), PyTorch "
              f"{fmt_ms(tt['torch_ms'])} ms in {tt['torch_kernels']} "
              "kernels")
        turns[what] = {"streaming_ms": (o1, o2), "tiled_ms": (t1, t2),
                       "device_ms": (ts["csrc_ms"], tt["csrc_ms"]),
                       "launches": (len(ts["csrc"]), len(tt["csrc"]))}

    # the kernels line: the functional wrappers at 2048x2048, square
    r = rows["admm_chunk_tiled"]
    timed(r, lambda: fa.admm_chunk(*planes, f, w, scal, None, ri, 0, alpha,
                                   "square", degree), 20,
          lambda c: c == ["admm_tiled", "admm_finish"], fa)
    r["plain_ms"] = time_ms(lambda: fa.admm_chunk_plain(
        *planes, f, w, scal, None, ri, 0, alpha, "square", degree), 3)
    # xh, xp, xd, zh, zd, warm, f in and the seven state arrays out: 19
    # planes; the design's floor reads 9 planes (f included) and writes 8
    # an iteration, and reads 10 once for the norms
    r["bound"] = bound(19 * n * 4, n * (ri * admm_iter_ops(degree)
                                        + ADMM_NORM_OPS))
    r["floor_ms"] = (17 * ri + 10) * n * 4 / HBM_BYTES_PER_S * 1e3
    r = rows["admm_multichunk_tiled"]
    timed(r, lambda: fa.admm_multichunk(*start, fimg, fimg, sc, ri, 8,
                                        alpha, degree, consts_of(nx, ny)),
          10, lambda c: c.count("admm_tiled") == 8 and len(c) == 17, fa)
    r["plain_ms"] = time_ms(lambda: fa.admm_multichunk_plain(
        *start, fimg, fimg, sc, ri, 8, alpha, degree, consts_of(nx, ny)), 2)
    r["bound"] = bound(19 * n * 4, 8 * n * (ri * admm_iter_ops(degree)
                                            + ADMM_NORM_OPS
                                            + ADMM_RESCALE_OPS))
    r["floor_ms"] = 8 * rows["admm_chunk_tiled"]["floor_ms"]
    for name, r in rows.items():
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch admm_tiled (counted "
              f"{r['counted']})")
        print(f"{name} {nx}x{ny}: wrapper {r['ms']:.4f} ms/call (traced "
              f"device {fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
              f"one pass an iteration {r['floor_ms']:.5f} ms")
    rows["admm_chunk_tiled"]["turns"] = turns
    return rows


def phase_tiled_deblur(dev):
    """Row 19 tiled (``deblur_tiled``: a cooperative launch a chunk over
    overlapping 2-D windows of the planes, a grid barrier an iteration)
    against the streaming launch sequence it replaces at the planes no
    grid-resident band holds: ``deblur_chunk_`` with config 2's motion blur
    at 2048x2048 (ri 10, an odd count of 3, and with the flag set) and
    2048x1536, tests/test_fused_deblur.py's 5x5 blur at 1000x777 (tiles
    that do not divide it), a dense 9x9 blur (81 taps, their count known
    only at run time) at 1024x1024, each on the path the shape rule picks
    (tiled for any tap count, and no slower than the streaming sequence
    in the turns below), and ``deblur_chunk_halo_`` on the one-shard band
    of config 2 at 2048x2048 (the yv grid's 2056 rows and 154 of halo each
    side): planes, previous iterates and squared norms bit-equal, and
    within PLANE_ATOL of max(1, |plane|) / NORM_RTOL of the plain versions
    (``scaled_errs``); each shape's in-place call in turns (streaming,
    tiled, tiled, streaming) with the hand-written kernels each path
    launches per call and their traced device ms, and the route's light
    call (``DeblurChunk``) at 2048x2048; the functional wrappers' calls and
    the plain versions timed for the kernels line, beside the bound and
    the design's floor of one pass over device memory an iteration."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, sig_q, tau_t = 10, 0.5, 0.2
    rows = {"deblur_chunk_tiled": {"err": 0.0},
            "deblur_chunk_halo_tiled": {"err": 0.0}}
    head = [0.9, 1.1, 1.0, DB_LMB, 1.0]
    scal = torch.tensor(head, device=dev)

    def inputs(nx, ny, kern, seed):
        """x, yv, q, fb, sv on the card and the taps of ``kern`` (ky,
        kx)."""
        taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
        nx2, ny2 = nx + kern.shape[1] - 1, ny + kern.shape[0] - 1
        rng = np.random.RandomState(seed)
        arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2),
                0.3 * rng.randn(2, nx, ny), rng.rand(nx2, ny2),
                0.5 + rng.rand(nx2, ny2))
        return [torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in arrs], taps

    def both(label, fn, state, data, *args):
        """``fn`` in place on copies of ``state`` by each path: the tiled
        outputs (state, previous iterate, norms), checked bit-equal to the
        streaming ones."""
        got = {}
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in state]
            prev = [t.clone() for t in cur]
            norms2 = fn(*cur, *prev, *data, *args, path=path)
            got[path] = cur + prev + [norms2.clone()]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["tiled"]))
              and all(bool(torch.isfinite(t).all()) for t in got["tiled"]),
              f"{label}: the tiled launch is not the launch sequence")
        return got["tiled"]

    def against_plain(label, out, ref):
        plane, rel = scaled_errs(out, ref, 6)
        print(f"{label}: against the plain version max abs err planes / "
              f"max(1, |plane|) {plane:.3e} (tol {PLANE_ATOL:g}), max rel "
              f"err norms {rel:.3e} (tol {NORM_RTOL:g}, floor at the "
              "largest)")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"{label} disagrees with its plain version")
        return plane

    def turns(label, call_for, reps, count=ri):
        """The in-place call of each path in turns, and each traced (a
        chunk of ``count`` iterations)."""
        (s1, s2), (t1, t2) = in_turns(call_for("streaming"),
                                      call_for("tiled"), reps)
        # whole traces: the seed, a primal and a dual launch an
        # iteration, the norm partials and the finish; the tiled launch
        # and the finish
        ts = traced_until(call_for("streaming"),
                          lambda c: len(c) == 2 * count + 3)
        tt = traced_until(call_for("tiled"),
                          lambda c: c == ["deblur_tiled", "pdhg_finish"])
        got = counted(fd, call_for("tiled"))
        check(sum(v for k, v in got.items() if k.endswith("_tiled")) == 1
              and set(tt["csrc"]) <= {"deblur_tiled", "pdhg_finish"},
              f"{label}: the tiled call launched {tt['csrc']} (counted "
              f"{got})")
        print(f"{label} in place, in turns: streaming {s1:.4f} ms, tiled "
              f"{t1:.4f}, tiled {t2:.4f}, streaming {s2:.4f} ms/call; "
              f"traced device ms: streaming {fmt_ms(ts['csrc_ms'])} "
              f"({len(ts['csrc'])} hand-written launches), tiled "
              f"{fmt_ms(tt['csrc_ms'])} ({len(tt['csrc'])}: {tt['csrc']})")
        return {"streaming_ms": (s1, s2), "tiled_ms": (t1, t2),
                "device_ms": (ts["csrc_ms"], tt["csrc_ms"]),
                "launches": (len(ts["csrc"]), len(tt["csrc"]))}

    seen = {}
    cases = (("config 2", DB_LARGE, DB_LARGE, motion_kernel(), (ri, 3)),
             ("config 2", DB_LARGE, 1536, motion_kernel(), (ri,)),
             ("5x5", 1000, 777, asym_kernel(), (ri,)),
             ("dense 9x9", 1024, 1024, np.full((9, 9), 1.0 / 81), (3,)))
    for seed, (name, nx, ny, kern, counts) in enumerate(cases):
        state, taps = inputs(nx, ny, kern, 950 + seed)
        nx2, ny2 = state[1].shape
        route = fd.deblur_pick_route(None, nx2, ny, ny2, taps, dev,
                                     "deblur_chunk")
        check(route[0] == "tiled", f"deblur_chunk_ {nx}x{ny} {name}: the "
              f"shape rule takes {route}")
        for count in counts:
            label = (f"deblur_chunk_ {nx}x{ny} {name} ({len(taps)} taps) "
                     f"count {count}, tile {route[1]}")
            out = both(label, fd.deblur_chunk_, state[:3], state[3:], scal,
                       count, taps, sig_q, tau_t)
            print(f"{label}: tiled bit-equal to the launch sequence in the "
                  "planes, the previous iterates and the squared norms")
            err = against_plain(label, out, fd.deblur_chunk_plain(
                *state, scal, count, taps, sig_q, tau_t))
            rows["deblur_chunk_tiled"]["err"] = max(
                rows["deblur_chunk_tiled"]["err"], err)
        cur = [t.clone() for t in state[:3]]
        prev = [t.clone() for t in cur]
        seen[(nx, ny, name)] = turns(
            f"deblur_chunk_ {nx}x{ny} {name} count {counts[0]}",
            lambda p, a=cur, b=prev, d=state[3:], c=counts[0], tp=taps:
            lambda: fd.deblur_chunk_(*a, *b, *d, scal, c, tp, sig_q, tau_t,
                                     path=p), 10, counts[0])
        # the rule takes the tiled launch for any tap count: it must not
        # lose to the streaming sequence (5% for the spread of one call)
        got = seen[(nx, ny, name)]
        slower = max(got["tiled_ms"]) > 1.05 * min(got["streaming_ms"])
        print(f"deblur_chunk_ {nx}x{ny} {name} ({len(taps)} taps): the rule "
              f"takes {route[0]}, {max(got['tiled_ms']):.4f} ms a call "
              f"against streaming {min(got['streaming_ms']):.4f}: "
              f"{'slower' if slower else 'no slower'}")
        check(not slower, f"deblur_chunk_ {nx}x{ny} {name}: the rule's "
              "tiled launch is slower than the streaming sequence")
        if nx == ny == DB_LARGE:
            flagged = torch.cat([scal, torch.ones(1, device=dev)])
            out = both(f"deblur_chunk_ {nx}x{ny} with the flag",
                       fd.deblur_chunk_, state[:3], state[3:], flagged, ri,
                       taps, sig_q, tau_t)
            check(all(torch.equal(a, b) for a, b in zip(out[:6],
                                                       state[:3] * 2))
                  and not bool(out[6].any()),
                  "the flagged tiled chunk changed its planes")
            print(f"deblur_chunk_ {nx}x{ny} with the flag set: both paths "
                  "return their inputs and zero norms")
            big = (state, taps)

    # the one-shard band of config 2 at 2048x2048 (halo 154 at ri 10)
    (planes, taps), n = big, DB_LARGE
    nx2, ny2 = planes[1].shape
    H = fd.deblur_halo_rows(ri, taps)
    band = [window(a, -H, nx2 + H) for a in planes]
    bscal = torch.tensor(head + [-H, H, H + nx2], device=dev)
    route = fd.deblur_pick_route(None, nx2 + 2 * H, n, ny2, taps, dev,
                                 "deblur_chunk_halo")
    check(route[0] == "tiled", f"deblur_chunk_halo_ band: the shape rule "
          f"takes {route}")
    label = (f"deblur_chunk_halo_ {nx2 + 2 * H}x{n} band (halo {H}), tile "
             f"{route[1]}")
    out = both(label, fd.deblur_chunk_halo_, band[:3], band[3:], bscal, ri,
               n, taps, sig_q, tau_t)
    print(f"{label}: tiled bit-equal to the launch sequence in the planes, "
          "the previous iterates and the owned-row norms")
    rows["deblur_chunk_halo_tiled"]["err"] = against_plain(
        label, out, fd.deblur_chunk_plain(*band, bscal, ri, taps, sig_q,
                                          tau_t, n))
    cur = [t.clone() for t in band[:3]]
    prev = [t.clone() for t in cur]
    seen["band"] = turns(
        f"deblur_chunk_halo_ {nx2 + 2 * H}x{n} band",
        lambda p: lambda: fd.deblur_chunk_halo_(
            *cur, *prev, *band[3:], bscal, ri, n, taps, sig_q, tau_t,
            path=p), 10)

    # the route's light call at 2048x2048, in place on buffers made once
    m = {"nx": n, "ny": n, "nx2": nx2, "ny2": ny2, "taps": taps,
         "lmb": DB_LMB, "radius": 1.0, "sig_q": sig_q, "tau_t": tau_t}
    s3 = [torch.tensor(v, device=dev) for v in head[:3]]
    flag = torch.tensor(False, device=dev)
    calls = {}
    for p in ("streaming", "tiled"):
        call = fd.DeblurChunk(m, ri, dev, path=p)
        check(call.route[0] == p, f"DeblurChunk took {call.route}, not {p}")
        cur = [t.clone() for t in planes[:3]]
        prev = [t.clone() for t in cur]
        calls[p] = (lambda c=call, a=cur, b=prev: c(a, b, planes[3],
                                                   planes[4], *s3, flag))
    seen["light"] = turns(f"DeblurChunk {n}x{n} light call",
                          lambda p: calls[p], 20)

    # the kernels line: the functional wrappers at config 2's 2048x2048
    # and on its band; x, yv, q, fb, sv and the taps in, the new and the
    # previous x, yv and q out; the design's floor reads x, q_x, q_y, yv,
    # f_b and Sigma_v and writes the four state planes an iteration, and
    # reads x, q and yv, their previous iterates and Sigma_v once for the
    # norms
    for name, fn, args, nb, nb2 in (
            ("deblur_chunk_tiled", fd.deblur_chunk,
             (*planes, scal, ri, taps, sig_q, tau_t), n * n, nx2 * ny2),
            ("deblur_chunk_halo_tiled", fd.deblur_chunk_halo,
             (*band, bscal, ri, n, taps, sig_q, tau_t),
             (nx2 + 2 * H) * n, (nx2 + 2 * H) * ny2)):
        r = rows[name]
        T = len(taps)
        timed(r, lambda: fn(*args), 20,
              lambda c: c == ["deblur_tiled", "pdhg_finish"], fd)
        plain = (fd.deblur_chunk_plain if name == "deblur_chunk_tiled"
                 else lambda *a: fd.deblur_chunk_plain(*a[:7], *a[8:], a[7]))
        r["plain_ms"] = time_ms(lambda: plain(*args), 2)
        r["bound"] = bound((9 * nb + 5 * nb2 + 3 * T) * 4,
                           deblur_chunk_ops(nb, nb2, T, ri))
        r["floor_ms"] = ((ri * (6 * nb + 4 * nb2) + 6 * nb + 3 * nb2) * 4
                         / HBM_BYTES_PER_S * 1e3)
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch deblur_tiled (counted "
              f"{r['counted']})")
        print(f"{name}: wrapper {r['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
              f"one pass an iteration {r['floor_ms']:.5f} ms")
    rows["deblur_chunk_tiled"]["turns"] = {str(k): v for k, v in seen.items()}
    return rows


def tiled_both(label, fn, state, data, *args):
    """``fn`` (an in-place chunk wrapper) on copies of ``state`` by the
    streaming and the tiled path: the tiled outputs (state, previous
    iterate, and what ``fn`` returns), checked bit-equal to the streaming
    ones and finite."""
    import torch

    got = {}
    for path in ("streaming", "tiled"):
        cur = [t.clone() for t in state]
        prev = [t.clone() for t in cur]
        ret = fn(*cur, *prev, *data, *args, path=path)
        ret = [ret] if isinstance(ret, torch.Tensor) else list(ret)
        got[path] = cur + prev + [t.clone() for t in ret]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                  got["tiled"]))
          and all(bool(torch.isfinite(t).all()) for t in got["tiled"]),
          f"{label}: the tiled launch is not the launch sequence")
    print(f"{label}: tiled bit-equal to the launch sequence in the planes, "
          "the previous iterates and the norms")
    return got["tiled"]


def tiled_against_plain(label, out, ref, n_planes, norm_rtol=NORM_RTOL):
    """A tiled call's ``n_planes`` planes and norms against the plain
    version's (``scaled_errs``, PLANE_ATOL and ``norm_rtol``); returns the
    planes' error."""
    plane, rel = scaled_errs(out, ref, n_planes)
    print(f"{label}: against the plain version max abs err planes / "
          f"max(1, |plane|) {plane:.3e} (tol {PLANE_ATOL:g}), max rel err "
          f"norms {rel:.3e} (tol {norm_rtol:g}, floor at the largest)")
    check(plane <= PLANE_ATOL and rel <= norm_rtol,
          f"{label} disagrees with its plain version")
    return plane


def tiled_turns(mod, label, call_for, reps, streaming, tiled):
    """The in-place call of each path (``call_for(path)``) in turns, and
    each traced; the whole traces name ``streaming`` launches and the
    kernels of ``tiled``, and one tiled call counts one launch under a
    ``_tiled`` name of ``mod.launch_counts``."""
    (s1, s2), (t1, t2) = in_turns(call_for("streaming"), call_for("tiled"),
                                  reps)
    ts = traced_until(call_for("streaming"), lambda c: len(c) == streaming)
    tt = traced_until(call_for("tiled"), lambda c: c == tiled)
    got = counted(mod, call_for("tiled"))
    check(sum(v for k, v in got.items() if k.endswith("_tiled")) == 1
          and set(tt["csrc"]) <= set(tiled),
          f"{label}: the tiled call launched {tt['csrc']} (counted {got})")
    print(f"{label} in place, in turns: streaming {s1:.4f} ms, tiled "
          f"{t1:.4f}, tiled {t2:.4f}, streaming {s2:.4f} ms/call; traced "
          f"device ms: streaming {fmt_ms(ts['csrc_ms'])} "
          f"({len(ts['csrc'])} hand-written launches), tiled "
          f"{fmt_ms(tt['csrc_ms'])} ({len(tt['csrc'])}: "
          f"{sorted(set(tt['csrc']))})")
    return {"streaming_ms": (s1, s2), "tiled_ms": (t1, t2),
            "device_ms": (ts["csrc_ms"], tt["csrc_ms"]),
            "launches": (len(ts["csrc"]), len(tt["csrc"]))}


def phase_tiled_ml(dev):
    """Rows 16 and 14 tiled (``ml_tiled<L>``: a cooperative launch a chunk
    over overlapping 2-D windows of the planes, a grid barrier an
    iteration) against the streaming launch sequence they replace at the
    planes no grid-resident band holds: ``ml_chunk_`` at 512x512x8 (ri 10,
    an odd count of 3, and with the flag set), 512x384x8 and 300x211x5
    (tiles that do not divide it), ``ml_chunk_halo_`` on the one-shard band
    of 512x512x8 (556 rows, 22 of halo each side), and ``ml_multichunk_``
    at 512x512x8 (8 chunks of 10, every chunk run) and 300x211x5 (5 chunks
    of 3: an odd count and an odd number of chunks): planes, previous
    iterates and norms (and sout) bit-equal, and within PLANE_ATOL of
    max(1, |plane|) / NORM_RTOL (a multichunk's MC_NORM_RTOL) of the plain
    versions; each 512-wide call in place in turns (streaming, tiled,
    tiled, streaming) with the hand-written kernels each path launches per
    call and their traced device ms, and the route's light calls
    (``MLChunk``, ``MLMultichunk``) at 512x512x8; the functional wrappers'
    calls and the plain versions timed for the kernels line, beside the
    bound and the design's floor of one pass over device memory an
    iteration."""
    import torch

    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, scalar_buffer
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, L, n = 10, ML_LABELS, ML_LARGE
    rows = {"ml_chunk_tiled": {"err": 0.0}, "ml_multichunk_tiled":
            {"err": 0.0}, "ml_chunk_halo_tiled": {"err": 0.0}}
    head = [0.9, 1.1, 1.0, ML_LMB, 1.0]
    scal = torch.tensor(head, device=dev)

    def consts_of(L, nx, ny):
        m = nx * ny
        return (np.sqrt(2 * m * L + m), np.sqrt(m * L), 1.5, 0.95, 1.05,
                0.8)

    def mscal(tol):
        return torch.tensor([1.0, 1.0, 1.0, ML_LMB, 1.0, 0.5, 0.0, 0.0, 1.0,
                             tol, tol, tol, tol], device=dev)

    def against_plain(label, out, ref, norm_rtol=NORM_RTOL):
        return tiled_against_plain(label, out, ref, 6, norm_rtol)

    def turns(label, call_for, reps, streaming, tiled):
        return tiled_turns(fm, label, call_for, reps, streaming, tiled)

    one = ["ml_tiled", "pdhg_finish"]
    seen = {}
    for seed, (Lc, nx, ny, counts) in enumerate(((L, n, n, (ri, 3)),
                                                 (L, n, 384, (ri,)),
                                                 (5, 300, 211, (ri,)))):
        state = ml_kernel_inputs(Lc, nx, ny, 960 + seed, dev)
        # 300x211x5 fits the grid-resident launch: its tiled launch is
        # asked for
        route = fm.ml_pick_route(None if Lc == L else "tiled", Lc, nx, ny,
                                 dev, False, "ml_chunk")
        check(route[0] == "tiled", f"ml_chunk_ {nx}x{ny}x{Lc}: the shape "
              f"rule takes {route}")
        for count in counts:
            label = (f"ml_chunk_ {nx}x{ny}x{Lc} count {count}, tile "
                     f"{route[1]}")
            out = tiled_both(label, fm.ml_chunk_, state[:3], state[3:], scal,
                             count)
            err = against_plain(label, out, fm.ml_chunk_plain(
                *state, scal, count))
            rows["ml_chunk_tiled"]["err"] = max(
                rows["ml_chunk_tiled"]["err"], err)
        if nx == ny == n:
            flagged = torch.cat([scal, torch.ones(1, device=dev)])
            out = tiled_both(f"ml_chunk_ {nx}x{ny}x{Lc} with the flag",
                             fm.ml_chunk_, state[:3], state[3:], flagged, ri)
            check(all(torch.equal(a, b) for a, b in zip(out[:6],
                                                       state[:3] * 2))
                  and not bool(out[6].any()),
                  "the flagged tiled chunk changed its planes")
            print(f"ml_chunk_ {nx}x{ny}x{Lc} with the flag set: both paths "
                  "return their inputs and zero norms")
            big = state
        if Lc == L:
            cur = [t.clone() for t in state[:3]]
            prev = [t.clone() for t in cur]
            seen[f"{nx}x{ny}"] = turns(
                f"ml_chunk_ {nx}x{ny}x{Lc} count {ri}",
                lambda p, a=cur, b=prev, d=state[3:]:
                lambda: fm.ml_chunk_(*a, *b, *d, scal, ri, path=p), 10,
                2 * ri + 3, one)

    # the one-shard band of 512x512x8 (halo 22 at ri 10)
    H = 2 * ri + 2
    band = [window(a, -H, n + H) for a in big]
    bscal = torch.tensor(head + [-H, H, H + n], device=dev)
    route = fm.ml_pick_route(None, L, n + 2 * H, n, dev, False,
                             "ml_chunk_halo")
    check(route[0] == "tiled", f"ml_chunk_halo_ band: the shape rule takes "
          f"{route}")
    label = f"ml_chunk_halo_ {n + 2 * H}x{n}x{L} band (halo {H}), tile " \
            f"{route[1]}"
    out = tiled_both(label, fm.ml_chunk_halo_, band[:3], band[3:], bscal, ri,
                     n)
    rows["ml_chunk_halo_tiled"]["err"] = against_plain(
        label, out, fm.ml_chunk_halo_plain(*band, bscal, ri, n))
    cur = [t.clone() for t in band[:3]]
    prev = [t.clone() for t in cur]
    seen["band"] = turns(
        f"ml_chunk_halo_ {n + 2 * H}x{n}x{L} band",
        lambda p: lambda: fm.ml_chunk_halo_(*cur, *prev, *band[3:], bscal,
                                            ri, n, path=p), 10,
        2 * ri + 3, one)

    # the multichunk: every chunk run (tolerance 0) at 512x512x8, 8 chunks
    # of 10, and at 300x211x5, 5 chunks of 3 (slot B copied back)
    for seed, (Lc, nx, ny, count, k) in enumerate(((L, n, n, ri, 8),
                                                   (5, 300, 211, 3, 5))):
        state = ml_kernel_inputs(Lc, nx, ny, 970 + seed, dev)
        consts = consts_of(Lc, nx, ny)
        label = f"ml_multichunk_ {nx}x{ny}x{Lc}, {k} chunks of {count}"
        out = tiled_both(label, fm.ml_multichunk_, state[:3], state[3:],
                         mscal(0.0), count, k, "boyd", consts)
        check(out[7][5:].tolist() == [0.0, float(k)],
              f"{label}: not every chunk ran ({out[7].tolist()})")
        ref = fm.ml_multichunk_plain(*state, mscal(0.0), count, k, "boyd",
                                     consts)
        err = against_plain(label, out[:7], ref[:7], MC_NORM_RTOL)
        check(out[7][5:].tolist() == ref[7][5:].tolist(),
              f"{label}: sout's flag or chunk count disagrees with the "
              "plain version's")
        rows["ml_multichunk_tiled"]["err"] = max(
            rows["ml_multichunk_tiled"]["err"], err)
    mstate = ml_kernel_inputs(L, n, n, 970, dev)
    mcur = [t.clone() for t in mstate[:3]]
    mprev = [t.clone() for t in mcur]
    seen["multichunk"] = turns(
        f"ml_multichunk_ {n}x{n}x{L}, 8 chunks",
        lambda p: lambda: fm.ml_multichunk_(
            *mcur, *mprev, mstate[3], mscal(0.0), ri, 8, "boyd",
            consts_of(L, n, n), path=p), 3, 1 + 8 * (2 * ri + 2), one * 8)

    # the route's light calls at 512x512x8, in place on buffers made once
    m = {"L": L, "nx": n, "ny": n, "f": big[3], "radius": ML_LMB, "d_s": 1.0,
         "radius_t": torch.tensor(ML_LMB, device=dev),
         "d_s_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "adapt_consts": consts_of(L, n, n)}
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0, 0.5, 0.0,
                                                   0.0)]
    it0, flag = torch.tensor(1, device=dev), torch.tensor(False, device=dev)
    calls = {}
    for p in ("streaming", "tiled"):
        call = fm.MLChunk(m, ri, dev, path=p)
        multi = fm.MLMultichunk(m, ri, 8, "boyd", dev, path=p)
        check(call.route[0] == multi.route[0] == p,
              f"MLChunk / MLMultichunk took {call.route}, {multi.route}")
        cur = [t.clone() for t in big[:3]]
        prev = [t.clone() for t in cur]
        calls[("chunk", p)] = (lambda c=call, a=cur, b=prev:
                               c(a, b, big[3], *steps[:3], flag))
        calls[("multi", p)] = (lambda c=multi, a=cur, b=prev:
                               c(a, b, *steps, it0, flag))
    seen["light"] = turns(f"MLChunk {n}x{n}x{L} light call",
                          lambda p: calls[("chunk", p)], 20, 2 * ri + 3, one)
    seen["light_multi"] = turns(
        f"MLMultichunk {n}x{n}x{L} light call, 8 chunks",
        lambda p: calls[("multi", p)], 3, 1 + 8 * (2 * ri + 2), one * 8)

    # the rule's tile at counts 1 and 10: the call's fixed cost (the norm
    # pass, the finish) and what an iteration adds
    per_count = {}
    rule = fm.ml_pick_route(None, L, n, n, dev, False, "ml_chunk")
    for count in (1, ri):
        cur = [t.clone() for t in big[:3]]
        prev = [t.clone() for t in cur]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * fm._lib().prost_ml_num_blocks(n, n),
                              device=dev)
        scratch = fm._scratch("tiled", L, n, n, dev)
        per_count[count] = time_ms(
            lambda: fm._launch_chunk("ml_chunk", cur, prev, big[3], sc,
                                     partial, scratch, rule, count), 20)
    per_it = (per_count[ri] - per_count[1]) / (ri - 1)
    print(f"ml_chunk_ {n}x{n}x{L} tiled, tile {rule[1]}, ms a call (CUDA "
          f"events): {per_count[1]:.4f} at count 1, {per_count[ri]:.4f} at "
          f"count {ri}: {per_it:.5f} ms an iteration, "
          f"{per_count[1] - per_it:.5f} ms of fixed cost")
    seen["per_count"] = per_count

    # the kernels line: the functional wrappers at 512x512x8 and on its
    # band; u, q, s and f in, the new and the previous u, q and s out; the
    # design's floor reads u, q, s and f and writes u, q and s an
    # iteration, writes the previous iterate once and reads both iterates
    # for the norms
    mc = mscal(0.0)
    consts = consts_of(L, n, n)
    for name, fn, plain, args, nb, chunks, tiled in (
            ("ml_chunk_tiled", fm.ml_chunk, fm.ml_chunk_plain,
             (*big, scal, ri), n * n, 1, one),
            ("ml_chunk_halo_tiled", fm.ml_chunk_halo, fm.ml_chunk_halo_plain,
             (*band, bscal, ri, n), (n + 2 * H) * n, 1, one),
            ("ml_multichunk_tiled", fm.ml_multichunk, fm.ml_multichunk_plain,
             (*mstate, mc, ri, 8, "boyd", consts), n * n, 8, one * 8)):
        r = rows[name]
        timed(r, lambda: fn(*args), 10 if chunks > 1 else 20,
              lambda c, t=tiled: c == t, fm)
        r["plain_ms"] = time_ms(lambda: plain(*args), 1 if chunks > 1 else 2)
        r["bound"] = bound((10 * L + 3) * nb * 4,
                           ml_chunk_ops(nb, L, ri, chunks))
        r["floor_ms"] = (chunks * (ri * (7 * L + 2) + 9 * L + 3) * nb * 4
                         / HBM_BYTES_PER_S * 1e3)
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch ml_tiled (counted "
              f"{r['counted']})")
        print(f"{name}: wrapper {r['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
              f"one pass an iteration {r['floor_ms']:.5f} ms")
    rows["ml_chunk_tiled"]["turns"] = seen
    return rows


def phase_tiled_tight(dev):
    """Row 22 tiled (``tight_tiled<L>``: a cooperative launch a chunk over
    overlapping 2-D windows of the planes, a grid barrier an iteration)
    against the streaming launch sequence it replaces at the planes no
    grid-resident band holds: ``tight_chunk_`` at 512x512x4 (ri 10, odd
    counts of 3 and 1, and with the flag set) and 250x190x3 (tiles that do
    not divide it; the grid-resident launch holds it, so its tiled launch
    is asked for), ``tight_chunk_halo_`` on the one-shard band of
    512x512x4 (556 rows, 22 of halo each side): planes, previous iterates
    and norms bit-equal, and within PLANE_ATOL of max(1, |plane|) /
    NORM_RTOL of the plain versions; each 512-wide call in place in turns
    (streaming, tiled, tiled, streaming) with the hand-written kernels each
    path launches per call and their traced device ms, and the route's
    light call (``TightChunk``) at 512x512x4; the chunk at counts 2 and 10
    (its fixed cost and an iteration's); the functional wrappers' calls
    and the plain versions timed for the kernels line, beside the bound
    and the design's floor of one pass over device memory an
    iteration."""
    import torch

    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, scalar_buffer
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, L, n = 10, TIGHT_LABELS, TIGHT_LARGE
    k = L * (L - 1) // 2
    rows = {"tight_chunk_tiled": {"err": 0.0},
            "tight_chunk_halo_tiled": {"err": 0.0}}
    head = [0.9, 1.1, 1.0, TIGHT_LMB, 1.0]
    scal = torch.tensor(head, device=dev)
    one = ["tight_tiled", "pdhg_finish"]
    seen = {}

    def turns(label, call_for, reps):
        return tiled_turns(ft, label, call_for, reps, 2 * ri + 3, one)

    for seed, (Lc, nx, ny, counts) in enumerate(((L, n, n, (ri, 3, 1)),
                                                 (3, 250, 190, (ri,)))):
        state, taps, consts = tight_kernel_inputs(Lc, nx, ny, 980 + seed,
                                                  dev)
        route = ft.tight_pick_route(None if Lc == L else "tiled", Lc,
                                    Lc * (Lc - 1) // 2, len(taps), nx, ny,
                                    dev, "tight_chunk")
        check(route[0] == "tiled", f"tight_chunk_ {nx}x{ny}x{Lc}: the shape "
              f"rule takes {route}")
        for count in counts:
            label = (f"tight_chunk_ {nx}x{ny}x{Lc} count {count}, tile "
                     f"{route[1]}")
            out = tiled_both(label, ft.tight_chunk_, state[:5], state[5:],
                             scal, count, taps, consts)
            err = tiled_against_plain(label, out, ft.tight_chunk_plain(
                *state, scal, count, taps, consts), 10)
            rows["tight_chunk_tiled"]["err"] = max(
                rows["tight_chunk_tiled"]["err"], err)
        if nx == n:
            flagged = torch.cat([scal, torch.ones(1, device=dev)])
            out = tiled_both(f"tight_chunk_ {nx}x{ny}x{Lc} with the flag",
                             ft.tight_chunk_, state[:5], state[5:], flagged,
                             ri, taps, consts)
            check(all(torch.equal(a, b) for a, b in zip(out[:10],
                                                       state[:5] * 2))
                  and not bool(out[10].any()),
                  "the flagged tiled chunk changed its planes")
            print(f"tight_chunk_ {nx}x{ny}x{Lc} with the flag set: both "
                  "paths return their inputs and zero norms")
            big, btaps, bconsts = state, taps, consts
            cur = [t.clone() for t in state[:5]]
            prev = [t.clone() for t in cur]
            seen[f"{nx}x{ny}"] = turns(
                f"tight_chunk_ {nx}x{ny}x{Lc} count {ri}",
                lambda p: lambda: ft.tight_chunk_(
                    *cur, *prev, big[5], scal, ri, btaps, bconsts, path=p),
                10)
    T = len(btaps)

    # the one-shard band of 512x512x4 (halo 22 at ri 10)
    H = 2 * ri + 2
    band = [window(a, -H, n + H) for a in big]
    bscal = torch.tensor(head + [-H, H, H + n], device=dev)
    route = ft.tight_pick_route(None, L, k, T, n + 2 * H, n, dev,
                                "tight_chunk_halo")
    check(route[0] == "tiled", f"tight_chunk_halo_ band: the shape rule "
          f"takes {route}")
    label = (f"tight_chunk_halo_ {n + 2 * H}x{n}x{L} band (halo {H}), tile "
             f"{route[1]}")
    out = tiled_both(label, ft.tight_chunk_halo_, band[:5], band[5:], bscal,
                     ri, n, btaps, bconsts)
    rows["tight_chunk_halo_tiled"]["err"] = tiled_against_plain(
        label, out, ft.tight_chunk_halo_plain(*band, bscal, ri, n, btaps,
                                              bconsts), 10)
    bcur = [t.clone() for t in band[:5]]
    bprev = [t.clone() for t in bcur]
    seen["band"] = turns(
        f"tight_chunk_halo_ {n + 2 * H}x{n}x{L} band",
        lambda p: lambda: ft.tight_chunk_halo_(
            *bcur, *bprev, band[5], bscal, ri, n, btaps, bconsts, path=p),
        10)

    # the route's light call at 512x512x4, in place on buffers made once
    m = {"L": L, "k": k, "nx": n, "ny": n, "taps": btaps,
         "consts": bconsts, "radius": TIGHT_LMB, "d_s": 1.0}
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0)]
    flag = torch.tensor(False, device=dev)
    calls = {}
    for p in ("streaming", "tiled"):
        call = ft.TightChunk(m, ri, dev, path=p)
        check(call.route[0] == p, f"TightChunk took {call.route}")
        lcur = [t.clone() for t in big[:5]]
        lprev = [t.clone() for t in lcur]
        calls[p] = (lambda c=call, a=lcur, b=lprev:
                    c(a, b, big[5], *steps, flag))
    seen["light"] = turns(f"TightChunk {n}x{n}x{L} light call",
                          lambda p: calls[p], 20)

    # the rule's tile at counts 2 and 10 (even: no copy back): the call's
    # fixed cost (the launch, the last iteration's norm terms and previous
    # iterate, the norm pass, the finish) and what an iteration adds
    per_count = {}
    rule = ft.tight_pick_route(None, L, k, T, n, n, dev, "tight_chunk")
    kron = ft.kron_array(btaps, L, k, dev)
    consts10 = ft._consts10(bconsts)
    for count in (2, ri):
        pcur = [t.clone() for t in big[:5]]
        pprev = [t.clone() for t in pcur]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * ft._lib().prost_tight_num_blocks(n, n),
                              device=dev)
        scratch = ft._route_scratch("tiled", L, n, n, dev)
        per_count[count] = time_ms(
            lambda: ft._launch_chunk("tight_chunk", pcur, pprev, big[5],
                                     kron, sc, partial, scratch, rule, count,
                                     T, consts10), 20)
    per_it = (per_count[ri] - per_count[2]) / (ri - 2)
    print(f"tight_chunk_ {n}x{n}x{L} tiled, tile {rule[1]}, ms a call (CUDA "
          f"events): {per_count[2]:.4f} at count 2, {per_count[ri]:.4f} at "
          f"count {ri}: {per_it:.5f} ms an iteration, "
          f"{per_count[2] - 2 * per_it:.5f} ms of fixed cost")
    seen["per_count"] = per_count

    # the kernels line: the functional wrappers at 512x512x4 and on its
    # band; u, v, q, p, s, f and the taps in, the new and the previous
    # state out; the design's floor reads u, q, s, f, v and p and writes u,
    # q, s, v and p an iteration (7L + 8k + 2 planes), writes the previous
    # iterate once and reads both iterates for the norms
    for name, fn, plain, args, nb in (
            ("tight_chunk_tiled", ft.tight_chunk, ft.tight_chunk_plain,
             (*big, scal, ri, btaps, bconsts), n * n),
            ("tight_chunk_halo_tiled", ft.tight_chunk_halo,
             ft.tight_chunk_halo_plain,
             (*band, bscal, ri, n, btaps, bconsts), (n + 2 * H) * n)):
        r = rows[name]
        timed(r, lambda: fn(*args), 20, lambda c: c == one, ft)
        r["plain_ms"] = time_ms(lambda: plain(*args), 2)
        r["bound"] = bound(((10 * L + 12 * k + 3) * nb + 4 * T + 2 * L
                            + 2 * k + 2) * 4,
                           tight_chunk_ops(nb, L, k, T, ri))
        r["floor_ms"] = ((ri * (7 * L + 8 * k + 2) + 9 * L + 12 * k + 3)
                         * nb * 4 / HBM_BYTES_PER_S * 1e3)
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch tight_tiled (counted "
              f"{r['counted']})")
        print(f"{name}: wrapper {r['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
              f"one pass an iteration {r['floor_ms']:.5f} ms")
    rows["tight_chunk_tiled"]["turns"] = seen
    return rows


def vol_kernel_inputs(L, nx, ny, seed, dev):
    """u, q (with mass on its dead coordinates, which every path zeroes at
    entry), f and wsquare's w of a volumetric chunk on ``dev``."""
    import torch

    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(3, L, nx, ny),
            rng.rand(L, nx, ny), 2.0 * (rng.rand(L, nx, ny) > 0.3))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def phase_tiled_vol(dev):
    """Rows 28 and 27 tiled (``vol_tiled<L>``: a cooperative launch a chunk
    over overlapping 2-D windows of the volume, a grid barrier an
    iteration) against the streaming launch sequence they replace at the
    volumes no grid-resident band holds: ``vol_chunk_`` at 512x512x8 (ri
    10, an odd count of 3, wsquare and abs, and with the flag set) and
    300x211x5 (tiles that do not divide it; the grid-resident launch holds
    it, so its tiled launch is asked for), ``vol_chunk_halo_`` on the
    one-shard band of 512x512x8 (556 rows, 22 of halo each side), and
    ``vol_multichunk_`` at 512x512x8 (8 chunks of 10, every chunk run) and
    300x211x5 (5 chunks of 3: an odd count and an odd number of chunks):
    volumes, previous iterates and norms (and sout) bit-equal, and within
    PLANE_ATOL of max(1, |plane|) / NORM_RTOL (a multichunk's
    MC_NORM_RTOL) of the plain versions; each 512-wide call in place in
    turns (streaming, tiled, tiled, streaming) with the hand-written
    kernels each path launches per call and their traced device ms, and
    the route's light calls (``VolChunk``, ``VolMultichunk``) at 512x512x8;
    the chunk at counts 2 and 10 (its fixed cost and an iteration's); the
    functional wrappers' calls and the plain versions timed for the
    kernels line, beside the bound and the design's floor of one pass over
    device memory an iteration."""
    import torch

    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, scalar_buffer
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, L, n = 10, VOL_LABELS, VOL_LARGE
    rows = {"vol_chunk_tiled": {"err": 0.0}, "vol_multichunk_tiled":
            {"err": 0.0}, "vol_chunk_halo_tiled": {"err": 0.0}}
    head = [0.9, 1.1, 1.0, VOL_LMB, 1.0]
    scal = torch.tensor(head, device=dev)

    def consts_of(L, nx, ny):
        m = L * nx * ny
        return (np.sqrt(3 * m), np.sqrt(m), 1.5, 0.95, 1.05, 0.8)

    def mscal(tol):
        return torch.tensor([1.0, 1.0, 1.0, VOL_LMB, 1.0, 0.5, 0.0, 0.0, 1.0,
                             tol, tol, tol, tol], device=dev)

    def turns(label, call_for, reps, streaming, tiled):
        return tiled_turns(fv, label, call_for, reps, streaming, tiled)

    one = ["vol_tiled", "pdhg_finish"]
    seen = {}
    for seed, (Lc, nx, ny, cases) in enumerate((
            (L, n, n, ((ri, "square"), (3, "square"), (ri, "wsquare"),
                       (ri, "abs"))),
            (5, 300, 211, ((ri, "wsquare"), (3, "abs"))))):
        state = vol_kernel_inputs(Lc, nx, ny, 990 + seed, dev)
        # 300x211x5 fits the grid-resident launch: its tiled launch is
        # asked for
        route = fv.vol_pick_route(None if Lc == L else "tiled", Lc, nx, ny,
                                  "square", dev, False, "vol_chunk")
        check(route[0] == "tiled", f"vol_chunk_ {nx}x{ny}x{Lc}: the shape "
              f"rule takes {route}")
        for count, dt in cases:
            label = (f"vol_chunk_ {nx}x{ny}x{Lc} {dt} count {count}, tile "
                     f"{route[1]}")
            out = tiled_both(label, fv.vol_chunk_, state[:2], state[2:], scal,
                             count, dt)
            err = tiled_against_plain(label, out, fv.vol_chunk_plain(
                *state, scal, count, dt), 4)
            rows["vol_chunk_tiled"]["err"] = max(
                rows["vol_chunk_tiled"]["err"], err)
        if nx == n:
            flagged = torch.cat([scal, torch.ones(1, device=dev)])
            out = tiled_both(f"vol_chunk_ {nx}x{ny}x{Lc} with the flag",
                             fv.vol_chunk_, state[:2], state[2:], flagged, ri)
            check(all(torch.equal(a, b) for a, b in zip(out[:4],
                                                       state[:2] * 2))
                  and not bool(out[4].any()),
                  "the flagged tiled chunk changed its volumes")
            print(f"vol_chunk_ {nx}x{ny}x{Lc} with the flag set: both paths "
                  "return their inputs and zero norms")
            big = state
            cur = [t.clone() for t in state[:2]]
            prev = [t.clone() for t in cur]
            seen[f"{nx}x{ny}"] = turns(
                f"vol_chunk_ {nx}x{ny}x{Lc} count {ri}",
                lambda p: lambda: fv.vol_chunk_(*cur, *prev, *big[2:], scal,
                                                ri, path=p), 10,
                2 * ri + 3, one)

    # the one-shard band of 512x512x8 (halo 22 at ri 10)
    H = 2 * ri + 2
    band = [window(a, -H, n + H) for a in big]
    bscal = torch.tensor(head + [-H, H, H + n], device=dev)
    route = fv.vol_pick_route(None, L, n + 2 * H, n, "square", dev, False,
                              "vol_chunk_halo")
    check(route[0] == "tiled", f"vol_chunk_halo_ band: the shape rule takes "
          f"{route}")
    label = f"vol_chunk_halo_ {n + 2 * H}x{n}x{L} band (halo {H}), tile " \
            f"{route[1]}"
    out = tiled_both(label, fv.vol_chunk_halo_, band[:2], band[2:], bscal,
                     ri, n)
    rows["vol_chunk_halo_tiled"]["err"] = tiled_against_plain(
        label, out, fv.vol_chunk_halo_plain(*band, bscal, ri, n), 4)
    bcur = [t.clone() for t in band[:2]]
    bprev = [t.clone() for t in bcur]
    seen["band"] = turns(
        f"vol_chunk_halo_ {n + 2 * H}x{n}x{L} band",
        lambda p: lambda: fv.vol_chunk_halo_(*bcur, *bprev, *band[2:], bscal,
                                             ri, n, path=p), 10,
        2 * ri + 3, one)

    # the multichunk: every chunk run (tolerance 0) at 512x512x8, 8 chunks
    # of 10, and at 300x211x5, 5 chunks of 3 (slot B copied back)
    for seed, (Lc, nx, ny, count, k) in enumerate(((L, n, n, ri, 8),
                                                   (5, 300, 211, 3, 5))):
        state = vol_kernel_inputs(Lc, nx, ny, 995 + seed, dev)
        consts = consts_of(Lc, nx, ny)
        label = f"vol_multichunk_ {nx}x{ny}x{Lc}, {k} chunks of {count}"
        out = tiled_both(label, fv.vol_multichunk_, state[:2], state[2:],
                         mscal(0.0), count, k, "square", "boyd", consts)
        check(out[5][5:].tolist() == [0.0, float(k)],
              f"{label}: not every chunk ran ({out[5].tolist()})")
        ref = fv.vol_multichunk_plain(*state, mscal(0.0), count, k, "square",
                                      "boyd", consts)
        err = tiled_against_plain(label, out[:5], ref[:5], 4, MC_NORM_RTOL)
        check(out[5][5:].tolist() == ref[5][5:].tolist(),
              f"{label}: sout's flag or chunk count disagrees with the "
              "plain version's")
        rows["vol_multichunk_tiled"]["err"] = max(
            rows["vol_multichunk_tiled"]["err"], err)
    mstate = vol_kernel_inputs(L, n, n, 995, dev)
    mcur = [t.clone() for t in mstate[:2]]
    mprev = [t.clone() for t in mcur]
    seen["multichunk"] = turns(
        f"vol_multichunk_ {n}x{n}x{L}, 8 chunks",
        lambda p: lambda: fv.vol_multichunk_(
            *mcur, *mprev, *mstate[2:], mscal(0.0), ri, 8, "square", "boyd",
            consts_of(L, n, n), path=p), 3, 1 + 8 * (2 * ri + 2), one * 8)

    # the route's light calls at 512x512x8, in place on buffers made once
    m = {"L": L, "nx": n, "ny": n, "f": big[2], "w": big[3], "lmb": VOL_LMB,
         "radius": 1.0, "dataterm": "square",
         "lmb_t": torch.tensor(VOL_LMB, device=dev),
         "radius_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "adapt_consts": consts_of(L, n, n)}
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0, 0.5, 0.0,
                                                   0.0)]
    it0, flag = torch.tensor(1, device=dev), torch.tensor(False, device=dev)
    calls = {}
    for p in ("streaming", "tiled"):
        call = fv.VolChunk(m, ri, dev, path=p)
        multi = fv.VolMultichunk(m, ri, 8, "boyd", dev, path=p)
        check(call.route[0] == multi.route[0] == p,
              f"VolChunk / VolMultichunk took {call.route}, {multi.route}")
        lcur = [t.clone() for t in big[:2]]
        lprev = [t.clone() for t in lcur]
        calls[("chunk", p)] = (lambda c=call, a=lcur, b=lprev:
                               c(a, b, big[2], big[3], *steps[:3], flag))
        calls[("multi", p)] = (lambda c=multi, a=lcur, b=lprev:
                               c(a, b, *steps, it0, flag))
    seen["light"] = turns(f"VolChunk {n}x{n}x{L} light call",
                          lambda p: calls[("chunk", p)], 20, 2 * ri + 3, one)
    seen["light_multi"] = turns(
        f"VolMultichunk {n}x{n}x{L} light call, 8 chunks",
        lambda p: calls[("multi", p)], 3, 1 + 8 * (2 * ri + 2), one * 8)

    # the rule's tile at counts 2 and 10 (even: no copy back): the call's
    # fixed cost (the last iteration's norm terms and previous iterate, the
    # norm pass, the finish) and what an iteration adds
    per_count = {}
    rule = fv.vol_pick_route(None, L, n, n, "square", dev, False,
                             "vol_chunk")
    for count in (2, ri):
        pcur = [t.clone() for t in big[:2]]
        pprev = [t.clone() for t in pcur]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * fv._lib().prost_vol_num_blocks(n, n),
                              device=dev)
        scratch = fv._scratch("tiled", 0, L, n, n, dev)
        per_count[count] = time_ms(
            lambda: fv._launch_chunk("vol_chunk", pcur, pprev, big[2],
                                     big[3], sc, partial, scratch, rule,
                                     count, "square"), 20)
    per_it = (per_count[ri] - per_count[2]) / (ri - 2)
    print(f"vol_chunk_ {n}x{n}x{L} tiled, tile {rule[1]}, ms a call (CUDA "
          f"events): {per_count[2]:.4f} at count 2, {per_count[ri]:.4f} at "
          f"count {ri}: {per_it:.5f} ms an iteration, "
          f"{per_count[2] - 2 * per_it:.5f} ms of fixed cost")
    seen["per_count"] = per_count

    # the kernels line: the functional wrappers at 512x512x8 and on its
    # band; u, q and f in, the new and the previous u and q out (13
    # volumes, the bound of rows 23 and 26); the design's floor reads u, q
    # and f and writes u and q an iteration (9 volumes) and writes the
    # previous iterate once (4)
    mc = mscal(0.0)
    consts = consts_of(L, n, n)
    for name, fn, plain, args, nb, chunks, tiled in (
            ("vol_chunk_tiled", fv.vol_chunk, fv.vol_chunk_plain,
             (*big, scal, ri), L * n * n, 1, one),
            ("vol_chunk_halo_tiled", fv.vol_chunk_halo,
             fv.vol_chunk_halo_plain, (*band, bscal, ri, n),
             L * (n + 2 * H) * n, 1, one),
            ("vol_multichunk_tiled", fv.vol_multichunk,
             fv.vol_multichunk_plain,
             (*mstate, mc, ri, 8, "square", "boyd", consts), L * n * n, 8,
             one * 8)):
        r = rows[name]
        timed(r, lambda: fn(*args), 10 if chunks > 1 else 20,
              lambda c, t=tiled: c == t, fv)
        r["plain_ms"] = time_ms(lambda: plain(*args), 1 if chunks > 1 else 2)
        r["bound"] = bound(13 * nb * 4, vol_chunk_ops(nb, ri, chunks))
        r["floor_ms"] = (chunks * (9 * ri + 4) * nb * 4 / HBM_BYTES_PER_S
                         * 1e3)
        check(r["counted"].get(name) == 1,
              f"{name}: the wrapper did not launch vol_tiled (counted "
              f"{r['counted']})")
        print(f"{name}: wrapper {r['ms']:.4f} ms/call (traced device "
              f"{fmt_ms(r['traced']['csrc_ms'])} ms in "
              f"{len(r['traced']['csrc'])} hand-written launches, PyTorch "
              f"{fmt_ms(r['traced']['torch_ms'])}), plain {r['plain_ms']:.4f} "
              f"ms/call, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
              f"one pass an iteration {r['floor_ms']:.5f} ms")
    rows["vol_chunk_tiled"]["turns"] = seen
    return rows


def phase_resident_kernels(dev):
    """Rows 17, 12, 20, 23 and 24 as grid-resident launches (one cooperative
    launch a chunk) against their streaming launch sequences, whole plane
    and one-shard halo band, at the main path's shapes (deblur 512x512 with
    config 2's blur and its 828-row band; multilabel 256x256x8 and its
    300-row band; tight128x4 and its 172-row band; vol256x8 and its 300-row
    band; ri 10): both paths from the same inputs bit-equal in the
    planes and the norms; the path the shape rule takes; each path in
    place on buffers made once, in turns (streaming, resident, resident,
    streaming), with the hand-written kernels each launches per call and
    their traced device ms; and the call, the copying one (the functional
    wrapper on copies with buffers made per call, the streaming sequence)
    against the route's light call in place (``DeblurChunk``, ``MLChunk``,
    ``TightChunk``, ``VolChunk``), in turns, with the device ms of
    PyTorch's kernels around each."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.ops.pdhg_chunk import halo_copy
    from prost_tpu_torch.parallel.spatial_fused import window

    ri = 10
    rng = np.random.RandomState(620)
    n, kern = DB_SIZE, motion_kernel(DB_KLEN)
    n2 = n + DB_KLEN - 1
    taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
    db = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(n, n), rng.randn(n2, n2), 0.3 * rng.randn(2, n, n),
        rng.rand(n2, n2), 0.5 + rng.rand(n2, n2))]
    m_db = {"nx": n, "ny": n, "nx2": n2, "ny2": n2, "taps": taps,
            "lmb": DB_LMB, "radius": 1.0, "sig_q": 0.5, "tau_t": 0.2}
    Hd = fd.deblur_halo_rows(ri, taps)
    ext_db = [window(a, -Hd, n2 + Hd) for a in db]
    L, nm = ML_LABELS, ML_SIZE
    ml = ml_kernel_inputs(L, nm, nm, 621, dev)
    m_ml = {"L": L, "nx": nm, "ny": nm, "radius": ML_LMB, "d_s": 1.0}
    Hm = 2 * ri + 2
    ext_ml = [window(a, -Hm, nm + Hm) for a in ml]
    Lt, nt = TIGHT_LABELS, TIGHT_SIZE
    kt = Lt * (Lt - 1) // 2
    pt_ = pair_matrix(Lt).T
    t_taps = tuple((r, m, float(pt_[r, m])) for r in range(2 * Lt)
                   for m in range(2 * kt) if pt_[r, m] != 0.0)
    t_consts = tuple(float(np.float32(c))
                     for c in (1 / (Lt + 1), 1.0, 1 / Lt, 0.2, 1 / 3))
    tg = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(Lt, nt, nt), 0.1 * rng.randn(2 * kt, nt, nt),
        0.2 * rng.randn(2 * Lt, nt, nt), 0.1 * rng.randn(2 * kt, nt, nt),
        0.1 * rng.randn(nt, nt), rng.rand(Lt, nt, nt))]
    m_t = {"L": Lt, "k": kt, "nx": nt, "ny": nt, "taps": t_taps,
           "consts": t_consts, "radius": TIGHT_LMB, "d_s": 1.0}
    ext_t = [window(a, -Hm, nt + Hm) for a in tg]
    Lv, nv = VOL_LABELS, VOL_SIZE
    vl = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(Lv, nv, nv), 0.3 * rng.randn(3, Lv, nv, nv),
        rng.rand(Lv, nv, nv), 2.0 * (rng.rand(Lv, nv, nv) > 0.3))]
    m_v = {"L": Lv, "nx": nv, "ny": nv, "lmb": VOL_LMB, "radius": 1.0,
           "dataterm": "square"}
    ext_v = [window(a, -Hm, nv + Hm) for a in vl]

    def scal(*v):
        return torch.tensor(v, device=dev, dtype=torch.float32)

    head = (0.9, 1.1, 1.0)
    cases = {
        "deblur_chunk": (
            fd.deblur_chunk_, db, 3, (scal(*head, DB_LMB, 1.0), ri, taps,
                                      0.5, 0.2),
            fd.DeblurChunk(m_db, ri, dev), "deblur_resident"),
        "deblur_chunk_halo": (
            fd.deblur_chunk_halo_, ext_db, 3,
            (scal(*head, DB_LMB, 1.0, -Hd, Hd, Hd + n2), ri, n, taps, 0.5,
             0.2),
            fd.DeblurChunk(m_db, ri, dev, (n, n2 + 2 * Hd, -Hd, Hd,
                                           Hd + n2)), "deblur_resident"),
        "ml_chunk": (
            fm.ml_chunk_, ml, 3, (scal(*head, ML_LMB, 1.0), ri),
            fm.MLChunk(m_ml, ri, dev), "ml_resident"),
        "ml_chunk_halo": (
            fm.ml_chunk_halo_, ext_ml, 3,
            (scal(*head, ML_LMB, 1.0, -Hm, Hm, Hm + nm), ri, nm),
            fm.MLChunk(m_ml, ri, dev, (nm, nm + 2 * Hm, -Hm, Hm, Hm + nm)),
            "ml_resident"),
        "tight_chunk": (
            ft.tight_chunk_, tg, 5, (scal(*head, TIGHT_LMB, 1.0), ri, t_taps,
                                     t_consts),
            ft.TightChunk(m_t, ri, dev), "tight_resident"),
        "tight_chunk_halo": (
            ft.tight_chunk_halo_, ext_t, 5,
            (scal(*head, TIGHT_LMB, 1.0, -Hm, Hm, Hm + nt), ri, nt, t_taps,
             t_consts),
            ft.TightChunk(m_t, ri, dev, (nt, nt + 2 * Hm, -Hm, Hm, Hm + nt)),
            "tight_resident"),
        "vol_chunk": (
            fv.vol_chunk_, vl, 2, (scal(*head, VOL_LMB, 1.0), ri, "square"),
            fv.VolChunk(m_v, ri, dev), "vol_resident"),
        "vol_chunk_halo": (
            fv.vol_chunk_halo_, ext_v, 2,
            (scal(*head, VOL_LMB, 1.0, -Hm, Hm, Hm + nv), ri, nv, "square"),
            fv.VolChunk(m_v, ri, dev, (nv, nv + 2 * Hm, -Hm, Hm, Hm + nv)),
            "vol_resident"),
    }
    steps = [torch.tensor(v, device=dev) for v in head]
    flag = torch.tensor(False, device=dev)
    out = {}
    for name, (fn, planes, k, args, light, kernel) in cases.items():
        state, data = planes[:k], planes[k:]
        rows = state[0].shape[-2]
        check(light.resident, f"{name}: the shape rule streams {rows} rows")
        got = {}
        for path in ("streaming", "resident"):
            cur = [t.clone() for t in state]
            prev = [torch.empty_like(t) for t in state]
            norms2 = fn(*cur, *prev, *data, *args, path=path).clone()
            got[path] = cur + prev + [norms2]
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b)
                    for a, b in zip(got["streaming"], got["resident"]))
        check(equal and all(bool(torch.isfinite(t).all())
                            for t in got["resident"]),
              f"{name}: the resident launch is not the streaming sequence")
        bufs = {p: ([t.clone() for t in state], [t.clone() for t in state])
                for p in ("streaming", "resident")}

        def run(path, count=ri, fn=fn, data=data, args=args, bufs=bufs):
            return lambda: fn(*bufs[path][0], *bufs[path][1], *data,
                              args[0], count, *args[2:], path=path)

        def copying(fn=fn, state=state, data=data, args=args):
            return halo_copy(lambda *a: fn(*a, path="streaming"), state,
                             *data, *args)

        lcur = [t.clone() for t in state]
        lprev = [t.clone() for t in state]

        def call(light=light, lcur=lcur, lprev=lprev, data=data):
            return light(lcur, lprev, *data, *steps, flag)

        out[name] = resident_turns(f"{name} {rows} rows", run, copying, call,
                                   kernel, ri - 1, reps=50)
    sms, smem = fd.card_limits(dev)
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory a deblur block, {fm.card_limits(dev, L)[1]} a multilabel "
          f"block, {ft.card_limits(dev)[1]} a tight block, "
          f"{fv.card_limits(dev, Lv)[1]} a volumetric block")
    check(not fv.resident_ok(Lv, nv + 2 * Hm, nv, "wsquare",
                             *fv.card_limits(dev, Lv)),
          "the 300-row vol band with wsquare's weights takes the resident "
          "launch")
    route = fv.vol_pick_route(None, Lv, nv + 2 * Hm, nv, "wsquare", dev,
                              False, "vol_chunk_halo")
    before = fv.launch_counts["vol_chunk_halo_tiled"]
    out_ws = fv.vol_chunk_halo(*ext_v, scal(*head, VOL_LMB, 1.0, -Hm, Hm,
                                           Hm + nv), ri, nv, "wsquare")
    traced = csrc_launches(lambda: fv.vol_chunk_halo(
        *ext_v, scal(*head, VOL_LMB, 1.0, -Hm, Hm, Hm + nv), ri, nv,
        "wsquare"))[0]
    check(route[0] == "tiled"
          and all(bool(torch.isfinite(t).all()) for t in out_ws)
          and fv.launch_counts["vol_chunk_halo_tiled"] > before
          and "vol_resident" not in traced,
          f"vol_chunk_halo with wsquare on the 300-row band did not run "
          f"tiled ({route})")
    print(f"vol_chunk_halo wsquare {nv + 2 * Hm} rows: tiled by the shape "
          f"rule, tile {route[1]} ({len(traced)} hand-written launches)")
    return out


def phase_resident_multi(dev):
    """Rows 15 and 9 grid-resident against their launch sequences at the
    main path's shapes: ``ml_chunk_batched_`` at SMALL_ENS_B instances of
    config 3's 256x256x8 on a route's flat rows (ri 10), each instance also
    against ``ml_chunk_`` on it alone, and ``admm_multichunk_`` at config
    4's 512x512 (degree 10, ri 10, 8 chunks, every one run): both paths
    from the same inputs bit-equal; the path the shape rule takes; each
    path in place on buffers made once, in turns (streaming, resident,
    resident, streaming), with the hand-written kernels each launches per
    call and their traced device ms, and the resident launch's device ms
    at count 1; and the call, the copying one (the wrapper on copies with
    buffers made per call, the streaming sequence) against the route's
    light call in place (``MLBatchedChunk``, ``ADMMMultichunk``), in turns,
    with the device ms of PyTorch's kernels around each."""
    import torch

    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops.pdhg_chunk import halo_copy

    ri, degree, alpha, chunks = 10, 10, 1.7, 8
    out = {}

    # row 15: a route's flat x (B, L n) and y (B, 2 L n + n)
    B, L, n = SMALL_ENS_B, ML_LABELS, ML_SIZE
    N = n * n
    rng = np.random.RandomState(630)
    x = torch.from_numpy(rng.rand(B, L * N).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.concatenate(
        [0.3 * rng.randn(B, 2 * L * N), 0.1 * rng.randn(B, N)],
        1).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.rand(B, L, n, n).astype(np.float32)).to(dev)
    scal = batched_scal(631, B, ML_LMB, 1.0, dev)

    def views(xx, yy):
        return (xx.view(B, L, n, n), yy[:, :2 * L * N].view(B, 2 * L, n, n),
                yy[:, 2 * L * N:].view(B, n, n))

    light = fm.MLBatchedChunk({"L": L, "nx": n, "ny": n, "radius": scal[3],
                               "d_s": scal[4]}, B, ri, dev)
    check(light.resident, f"ml_chunk_batched: the shape rule streams "
          f"{B}x{n}x{n}x{L}")
    print(f"ml_chunk_batched {B}x{n}x{n}x{L}: the shape rule takes the "
          "resident path")
    got = {}
    for path in ("streaming", "resident"):
        cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
        norms2 = fm.ml_chunk_batched_(*views(*cur), *views(*prev), f, scal,
                                      ri, path=path).clone()
        got[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                  got["resident"]))
          and all(bool(torch.isfinite(t).all()) for t in got["resident"]),
          "ml_chunk_batched: the resident launch is not the streaming "
          "sequence")
    res = views(*got["resident"][:2]) + views(*got["resident"][2:4])
    for b in range(B):
        cur = [v[b].clone() for v in views(x, y)]
        prev = [torch.empty_like(t) for t in cur]
        one = fm.ml_chunk_(*cur, *prev, f[b], scal[:, b], ri,
                           path="resident")
        check(all(torch.equal(a[b], c) for a, c in zip(res, cur + prev))
              and torch.equal(got["resident"][4][:, b], one),
              f"ml_chunk_batched: instance {b} is not ml_chunk_ on it alone")
    bufs = {p: ([x.clone(), y.clone()], [x.clone(), y.clone()])
            for p in ("streaming", "resident")}

    def ml_run(path, count=ri):
        return lambda: fm.ml_chunk_batched_(
            *views(*bufs[path][0]), *views(*bufs[path][1]), f, scal, count,
            path=path)

    def ml_copying():
        return halo_copy(lambda *a: fm.ml_chunk_batched_(
            *a, path="streaming"), [v.contiguous() for v in views(x, y)], f,
            scal, ri)

    lcur, lprev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    flag = torch.tensor(False, device=dev)

    def ml_light():
        return light(views(*lcur), views(*lprev), f, scal[0], scal[1],
                     scal[2], flag)

    out["ml_chunk_batched"] = resident_turns(
        f"ml_chunk_batched {B}x{n}x{n}x{L}", ml_run, ml_copying, ml_light,
        "ml_resident_batched", ri - 1)

    # row 9: config 4's 512x512 from random state arrays, tolerance 0
    nx = ny = ROF_SIZE
    *planes, fa_f, fa_w = admm_kernel_inputs(nx, ny, 632, dev)
    consts = (np.sqrt(2 * nx * ny), np.sqrt(nx * ny), 0.8, 1.01)
    ascal = torch.tensor([1.3, 8.0, 1.0, 1.05, 0.0, 0.0, 0.0] + [0.0] * 4,
                         device=dev)
    r = {"nx": nx, "ny": ny, "f": fa_f, "w": fa_w, "dataterm": "square",
         "lmb_t": ascal[1], "radius_t": ascal[2],
         "tols_t": tuple(ascal[7:11]), "consts": consts}
    alight = fa.ADMMMultichunk(r, ri, chunks, alpha, degree, dev)
    check(alight.resident, f"admm_multichunk: the shape rule streams "
          f"{nx}x{ny}")
    print(f"admm_multichunk {nx}x{ny}: the shape rule takes the resident "
          "path")
    got = {}
    for path in ("streaming", "resident"):
        cur = [t.clone() for t in planes]
        norms, sout = fa.admm_multichunk_(*cur, fa_f, fa_w, ascal, ri,
                                          chunks, alpha, degree, consts,
                                          path=path)
        got[path] = cur + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                  got["resident"]))
          and all(bool(torch.isfinite(t).all()) for t in got["resident"])
          and got["resident"][8][5].item() == chunks,
          "admm_multichunk: the resident launch is not the launch sequence")
    abufs = {p: [t.clone() for t in planes]
             for p in ("streaming", "resident")}

    def admm_run(path, count=ri):
        return lambda: fa.admm_multichunk_(
            *abufs[path], fa_f, fa_w, ascal, count, chunks, alpha, degree,
            consts, path=path)

    def admm_copying():
        cp = [t.contiguous().clone() for t in planes]
        return cp, fa.admm_multichunk_(*cp, fa_f, fa_w, ascal, ri, chunks,
                                       alpha, degree, consts,
                                       path="streaming")

    lplanes = [t.clone() for t in planes]
    st = [torch.tensor(v, device=dev) for v in (1.3, 1.05, 0.0, 0.0)]
    it0 = torch.tensor(0, device=dev)

    def admm_light():
        return alight(lplanes, *st, it0, flag)

    out["admm_multichunk"] = resident_turns(
        f"admm_multichunk {nx}x{ny} degree {degree}, {chunks} chunks",
        admm_run, admm_copying, admm_light, "admm_multichunk_resident",
        chunks * (ri - 1))
    sms, smem = fa.admm_card_limits(dev)
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory an ADMM multichunk block (it holds "
          f"{fa.admm_resident_bytes(nx, ny, sms, 'square')} at {nx}x{ny}), "
          f"{fm.card_limits(dev, L, True)[1]} a batched multilabel block "
          f"(it holds {fm.resident_bytes(L, n, n, sms)})")
    return out


def phase_resident_batched(dev):
    """Rows 25, 18 and 21 grid-resident against their launch sequences at
    the main path's shapes, on a route's flat rows (ri 10):
    ``vol_chunk_batched_`` at SMALL_ENS_B volumes of vol256x8 (256x256x8),
    each volume also against ``vol_chunk`` on it alone,
    ``deblur_chunk_batched_`` at SMALL_ENS_B frames of config 2 (512x512,
    the motion blur's 7 taps), each frame also against ``deblur_chunk_``
    (resident) on it alone, and ``tight_chunk_batched_`` at SMALL_ENS_B
    instances of tight128x4 (128x128x4, side by side in one launch), each
    also against ``tight_chunk_`` on it alone: both paths from the same
    inputs bit-equal; the
    path the shape rule takes; each path in place on buffers made once, in
    turns (streaming, resident, resident, streaming), with the hand-written
    kernels each launches per call and their traced device ms, and the
    resident launch's device ms at count 1; and the call, the copying one
    (the wrapper on copies with buffers made per call, the streaming
    sequence) against the route's light call in place
    (``VolBatchedChunk``, ``DeblurBatchedChunk``, ``TightBatchedChunk``),
    in turns, with the device ms of PyTorch's kernels around each; and the
    deblur chunk's two resident forms, one frame a block and two
    (``deblur_pairs_turns``)."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.ops.pdhg_chunk import halo_copy

    ri, B = 10, SMALL_ENS_B
    flag = torch.tensor(False, device=dev)
    rng = np.random.RandomState(640)
    out = {}

    def case(name, kernel, fn, views, x, y, data, extra, light, one):
        """Row ``name``'s checks and timings on the route's rows x and y
        (``views`` cuts them into the chunk's planes); ``one(b, cur,
        prev)`` runs the single-instance kernel on instance b of the
        inputs in place and returns its norms."""
        label = f"{name} {B}x{'x'.join(map(str, views(x, y)[0].shape[1:]))}"
        check(light.resident, f"{label}: the shape rule streams")
        print(f"{label}: the shape rule takes the resident path")
        got = {}
        for path in ("streaming", "resident"):
            cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
            norms2 = fn(*views(*cur), *views(*prev), *data, ri, *extra,
                        path=path).clone()
            got[path] = cur + prev + [norms2]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["resident"]))
              and all(bool(torch.isfinite(t).all())
                      for t in got["resident"]),
              f"{label}: the resident launch is not the streaming sequence")
        res = views(*got["resident"][:2]) + views(*got["resident"][2:4])
        for b in range(B):
            cur = [v[b].contiguous().clone() for v in views(x, y)]
            prev = [torch.empty_like(t) for t in cur]
            norms = one(b, cur, prev)
            check(all(torch.equal(a[b], c) for a, c in zip(res, cur + prev))
                  and torch.equal(got["resident"][4][:, b], norms),
                  f"{label}: instance {b} is not the single-instance kernel "
                  "on it alone")
        print(f"{label}: each instance bit-equal to the single-instance "
              "kernel on it alone")
        bufs = {p: ([x.clone(), y.clone()], [x.clone(), y.clone()])
                for p in ("streaming", "resident")}

        def run(path, count=ri):
            return lambda: fn(*views(*bufs[path][0]), *views(*bufs[path][1]),
                              *data, count, *extra, path=path)

        def copying():
            return halo_copy(lambda *a: fn(*a, path="streaming"),
                             [v.contiguous() for v in views(x, y)], *data,
                             ri, *extra)

        lcur, lprev = [x.clone(), y.clone()], [x.clone(), y.clone()]
        steps = (data[-1][0], data[-1][1], data[-1][2])

        def call():
            return light(views(*lcur), views(*lprev), *data[:-1], *steps,
                         flag)

        out[name] = resident_turns(label, run, copying, call, kernel, ri - 1)

    # row 25: the volumes of vol256x8's ensemble, square data term
    L, n = VOL_LABELS, VOL_SIZE
    N = L * n * n
    x = torch.from_numpy(rng.rand(B, N).astype(np.float32)).to(dev)
    y = torch.from_numpy((0.3 * rng.randn(B, 3 * N)).astype(
        np.float32)).to(dev)
    f = torch.from_numpy(rng.rand(B, L, n, n).astype(np.float32)).to(dev)
    scal = batched_scal(641, B, VOL_LMB, 1.0, dev)

    def vol_views(xx, yy):
        return xx.view(B, L, n, n), yy.view(B, 3, L, n, n)

    def vol_one(b, cur, prev):
        o = fv.vol_chunk(*cur, f[b], f[b], scal[:, b], ri)
        for t, v in zip(cur + prev, o[:4]):
            t.copy_(v)
        return o[4]

    case("vol_chunk_batched", "vol_resident_batched", fv.vol_chunk_batched_,
         vol_views, x, y, (f, f, scal), (),
         fv.VolBatchedChunk({"L": L, "nx": n, "ny": n, "dataterm": "square",
                             "lmb": scal[3], "radius": scal[4]}, B, ri, dev),
         vol_one)

    # row 18: the frames of deblur8x512, config 2's motion blur
    n, kern = DB_SIZE, motion_kernel(DB_KLEN)
    n2 = n + DB_KLEN - 1
    m2, N = n2 * n2, n * n
    taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
    x = torch.from_numpy(rng.rand(B, N).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.concatenate(
        [rng.randn(B, m2), 0.3 * rng.randn(B, 2 * N)], 1).astype(
        np.float32)).to(dev)
    fb = torch.from_numpy(rng.rand(B, n2, n2).astype(np.float32)).to(dev)
    sv = torch.from_numpy((0.5 + rng.rand(B, n2, n2)).astype(
        np.float32)).to(dev)
    scal = batched_scal(642, B, DB_LMB * (0.5 + rng.rand(B)), 1.0, dev)

    def db_views(xx, yy):
        return (xx.view(B, n, n), yy[:, :m2].view(B, n2, n2),
                yy[:, m2:].view(B, 2, n, n))

    def db_one(b, cur, prev):
        return fd.deblur_chunk_(*cur, *prev, fb[b], sv[b], scal[:, b], ri,
                                taps, 0.5, 0.2, path="resident")

    m_db = {"nx": n, "ny": n, "nx2": n2, "ny2": n2, "taps": taps,
            "sig_q": 0.5, "tau_t": 0.2, "lmb": scal[3], "radius": scal[4]}
    case("deblur_chunk_batched", "deblur_resident_batched",
         fd.deblur_chunk_batched_, db_views, x, y, (fb, sv, scal),
         (taps, 0.5, 0.2), fd.DeblurBatchedChunk(m_db, B, ri, dev), db_one)
    out["deblur_chunk_batched"]["pairs"] = deblur_pairs_turns(
        db_views, x, y, fb, sv, scal, taps, ri)

    # row 21: the instances of tight8x128x4 side by side
    TL, tn = TIGHT_LABELS, TIGHT_SIZE
    k = TL * (TL - 1) // 2
    pt_ = pair_matrix(TL).T
    ttaps = tuple((r_, m, float(pt_[r_, m])) for r_ in range(2 * TL)
                  for m in range(2 * k) if pt_[r_, m] != 0.0)
    consts = tuple(float(np.float32(c))
                   for c in (1 / (TL + 1), 1.0, 1 / TL, 0.2, 1 / 3))
    tN, nL, nk2 = tn * tn, TL * tn * tn, 2 * k * tn * tn
    x = torch.from_numpy(np.concatenate(
        [rng.rand(B, nL), 0.1 * rng.randn(B, nk2)], 1).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(np.concatenate(
        [0.2 * rng.randn(B, 2 * nL), 0.1 * rng.randn(B, nk2),
         0.1 * rng.randn(B, tN)], 1).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.rand(B, TL, tn, tn).astype(np.float32)).to(dev)
    scal = batched_scal(643, B, TIGHT_LMB * (0.5 + rng.rand(B)), 1.0, dev)

    def tight_views(xx, yy):
        return (xx[:, :nL].view(B, TL, tn, tn),
                xx[:, nL:].view(B, 2 * k, tn, tn),
                yy[:, :2 * nL].view(B, 2 * TL, tn, tn),
                yy[:, 2 * nL:2 * nL + nk2].view(B, 2 * k, tn, tn),
                yy[:, 2 * nL + nk2:].view(B, tn, tn))

    def tight_one(b, cur, prev):
        return ft.tight_chunk_(*cur, *prev, f[b], scal[:, b], ri, ttaps,
                               consts)

    m_t = {"L": TL, "k": k, "nx": tn, "ny": tn, "taps": ttaps,
           "consts": consts, "radius": scal[3], "d_s": scal[4]}
    case("tight_chunk_batched", "tight_resident_batched",
         ft.tight_chunk_batched_, tight_views, x, y, (f, scal),
         (ttaps, consts), ft.TightBatchedChunk(m_t, B, ri, dev), tight_one)
    tsms, tsmem = ft.card_limits(dev, True)
    print(f"resident limits: {tsmem} bytes of dynamic shared memory a "
          f"batched tight block (it holds "
          f"{ft.resident_bytes(TL, k, len(ttaps), tn, tn, tsms // B)} at "
          f"{B} instances of {tn}x{tn}x{TL}, {tsms // B} blocks each)")
    sms, smem = fv.card_limits(dev, L)
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory a batched vol block (it holds "
          f"{fv.resident_bytes(L, VOL_SIZE, VOL_SIZE, sms)} at "
          f"{VOL_SIZE}x{VOL_SIZE}x{L}, "
          f"{fv.resident_bytes(L, VOL_SIZE, VOL_SIZE, sms, 'wsquare')} with "
          f"wsquare), {fd.card_limits(dev, fd.BATCHED)[1]} a batched deblur "
          f"block (it holds {fd.resident_bytes(n2, n, n2, taps, sms)}, two "
          f"frames {2 * fd.resident_bytes(n2, n, n2, taps, sms)} of "
          f"{fd.card_limits(dev, fd.PAIRS)[1]})")
    return out


def phase_resident_chunk_multi(dev):
    """Rows 8 and 26 grid-resident against their launch sequences at the
    main path's shapes: ``admm_chunk_`` (Chebyshev) at config 4's 512x512
    (degree 10, counts 1 and 10) and ``vol_multichunk_`` at vol256x8
    (256x256x8, ri 10, 8 chunks, every one run, boyd; and from a solve's
    start at a tolerance at which the launch converges before its last
    chunk): both paths from the same inputs bit-equal (ADMM: the 7 planes
    and the 4 squared norms; vol: the volumes, the previous iterates, the
    norms and sout); the path the shape rule takes; each path in place on
    buffers made once, in turns (streaming, resident, resident,
    streaming), with the hand-written kernels each launches per call and
    their traced device ms, and the resident launch's device ms at count
    1; and the call, the copying one (the wrapper on copies with buffers
    made per call, the launch sequence) against the route's light call in
    place (``ADMMChunk``, ``VolMultichunk``), in turns, with the device ms
    of PyTorch's kernels around each."""
    import torch

    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_vol as fv

    ri, degree, alpha, chunks = 10, 10, 1.7, 8
    flag = torch.tensor(False, device=dev)
    out = {}

    # row 8: config 4's 512x512 from random state arrays
    nx = ny = ROF_SIZE
    *planes, fa_f, fa_w = admm_kernel_inputs(nx, ny, 650, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    r = {"nx": nx, "ny": ny, "f": fa_f, "w": fa_w, "dataterm": "square",
         "lmb_t": scal[1], "radius_t": scal[2]}
    light = fa.ADMMChunk(r, ri, alpha, degree, dev)
    check(light.resident, f"admm_chunk: the shape rule streams {nx}x{ny}")
    print(f"admm_chunk {nx}x{ny} degree {degree}: the shape rule takes the "
          "resident path")
    for count in (1, ri):
        got = {}
        for path in ("streaming", "resident"):
            cur = [t.clone() for t in planes]
            norms2 = fa.admm_chunk_(*cur, fa_f, fa_w, scal, None, count, 0,
                                    alpha, "square", degree,
                                    path=path).clone()
            got[path] = cur + [norms2]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["resident"]))
              and all(bool(torch.isfinite(t).all()) for t in got["resident"])
              and bool((got["resident"][7] > 0).all()),
              f"admm_chunk count {count}: the resident launch is not the "
              "launch sequence")
    print(f"admm_chunk {nx}x{ny}: resident bit-equal to the launch sequence "
          "in the 7 planes and the 4 squared norms at counts 1 and 10")
    abufs = {p: [t.clone() for t in planes]
             for p in ("streaming", "resident")}

    def admm_run(path, count=ri):
        return lambda: fa.admm_chunk_(*abufs[path], fa_f, fa_w, scal, None,
                                      count, 0, alpha, "square", degree,
                                      path=path)

    def admm_copying():
        cp = [t.contiguous().clone() for t in planes]
        return cp, fa.admm_chunk_(*cp, fa_f, fa_w, scal, None, ri, 0, alpha,
                                  "square", degree, path="streaming")

    lplanes = [t.clone() for t in planes]
    rho = scal[0].clone()

    def admm_light():
        return light(lplanes, rho, flag)

    out["admm_chunk"] = resident_turns(
        f"admm_chunk {nx}x{ny} degree {degree}", admm_run, admm_copying,
        admm_light, "admm_chunk_resident", ri - 1, reps=50)

    # row 26: vol256x8 (bench.py's data), boyd
    L, n = VOL_LABELS, VOL_SIZE
    nvox = L * n * n
    f = torch.from_numpy(vol_data(L, n, n)).to(dev).reshape(L, n, n)
    rng = np.random.RandomState(651)
    u0 = torch.from_numpy(rng.rand(L, n, n).astype(np.float32)).to(dev)
    q0 = torch.from_numpy((0.3 * rng.randn(3, L, n, n)).astype(
        np.float32)).to(dev)
    consts = (np.sqrt(3 * nvox), np.sqrt(nvox), 1.5, 0.95, 1.05, 0.8)

    def vscal(tol, tau=0.9, sigma=1.1):
        return torch.tensor([tau, sigma, 1.0, VOL_LMB, 1.0, 0.5, 0.0, 0.0,
                             1.0, tol, tol, tol, tol], device=dev)

    m = {"L": L, "nx": n, "ny": n, "f": f, "w": f, "dataterm": "square",
         "lmb_t": torch.tensor(VOL_LMB, device=dev),
         "radius_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "adapt_consts": consts}
    vlight = fv.VolMultichunk(m, ri, chunks, "boyd", dev)
    check(vlight.resident, f"vol_multichunk: the shape rule streams "
          f"{n}x{n}x{L}")
    print(f"vol_multichunk {n}x{n}x{L}: the shape rule takes the resident "
          "path")

    def both(u, q, sc):
        got = {}
        for path in ("streaming", "resident"):
            cur, prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
            norms, sout = fv.vol_multichunk_(*cur, *prev, f, f, sc, ri,
                                             chunks, "square", "boyd",
                                             consts, path=path)
            got[path] = cur + prev + [norms.clone(), sout.clone()]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["resident"]))
              and all(bool(torch.isfinite(t).all())
                      for t in got["resident"]),
              "vol_multichunk: the resident launch is not the launch "
              "sequence")
        return got["resident"][5]

    sout = both(u0, q0, vscal(0.0))
    check(sout[6].item() == chunks, "vol_multichunk: not every chunk ran")
    # a solve's start (u = f, q = 0): the first tolerance at which the
    # launch converges before its last chunk
    for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4, 1e-4):
        sout = both(f, torch.zeros_like(q0), vscal(tol, 1.0, 1.0))
        if sout[5].item() == 1.0 and 1 < sout[6].item() < chunks:
            break
    check(sout[5].item() == 1.0 and sout[6].item() < chunks,
          "vol_multichunk: no tolerance converged mid-launch")
    print(f"vol_multichunk {n}x{n}x{L}: resident bit-equal to the launch "
          f"sequence in the volumes, previous iterates, norms and sout, "
          f"every chunk run and converging at tolerance {tol:g} after "
          f"{int(sout[6].item())} chunks (sout {sout.tolist()})")
    vbufs = {p: ([u0.clone(), q0.clone()], [u0.clone(), q0.clone()])
             for p in ("streaming", "resident")}
    sc0 = vscal(0.0)

    def vol_run(path, count=ri):
        return lambda: fv.vol_multichunk_(
            *vbufs[path][0], *vbufs[path][1], f, f, sc0, count, chunks,
            "square", "boyd", consts, path=path)

    def vol_copying():
        cur = [u0.clone(), q0.clone()]
        prev = [t.clone() for t in cur]
        return cur, prev, fv.vol_multichunk_(
            *cur, *prev, f, f, sc0, ri, chunks, "square", "boyd", consts,
            path="streaming")

    lcur, lprev = [u0.clone(), q0.clone()], [u0.clone(), q0.clone()]
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0, 0.5, 0.0,
                                                   0.0)]
    it0 = torch.tensor(1, device=dev)

    def vol_light():
        return vlight(lcur, lprev, *steps, it0, flag)

    out["vol_multichunk"] = resident_turns(
        f"vol_multichunk {n}x{n}x{L}, {chunks} chunks", vol_run, vol_copying,
        vol_light, "vol_multichunk_resident", chunks * (ri - 1))
    sms, smem = fv.card_limits(dev, L, multi=True)
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory a vol multichunk block (it holds "
          f"{fv.resident_bytes(L, n, n, sms, multi=True)} at {n}x{n}x{L}, "
          f"{fv.resident_bytes(L, n, n, sms, 'wsquare', True)} with "
          f"wsquare; {VOL_LARGE}x{VOL_LARGE}x{L} takes the tiled launch: "
          f"{fv.resident_bytes(L, VOL_LARGE, VOL_LARGE, sms, multi=True)}), "
          f"{fa.admm_card_limits(dev)[1]} an ADMM chunk block (it holds "
          f"{fa.admm_resident_bytes(nx, ny, sms, 'square')})")
    check(not fv.resident_ok(L, VOL_LARGE, VOL_LARGE, "square", sms, smem,
                             multi=True),
          f"the shape rule made {VOL_LARGE}x{VOL_LARGE}x{L}'s multichunk "
          "resident")
    return out


def phase_resident_rof(dev):
    """Rows 2 and 1, the main path's kernels, grid-resident against their
    launch sequences at config 1's 512x512 (ri 10): ``rof_chunk_`` at
    counts 1 and 10 for the square, wsquare and abs data terms (planes,
    previous iterates and squared norms) and ``rof_multichunk_`` with 8
    chunks, every one run, under boyd and alg1 for the three data terms,
    and from a solve's start at the first tolerance at which the launch
    converges before its last chunk (planes, previous iterates, norms and
    sout): both paths from the same inputs bit-equal; the path the shape
    rule takes (resident at 512x512; tiled at 2048x1536 and 2048x2048,
    where ``path="resident"`` raises); each path in place on buffers made
    once, in turns (streaming, resident, resident, streaming), with the
    hand-written kernels each launches per call and their traced device ms;
    and the copying call (the functional wrapper's work on copies with
    buffers made per call, the launch sequence) against the route's light
    call in place (``ROFChunk``, ``ROFMultichunk``), in turns."""
    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops.pdhg_chunk import halo_copy

    ri, chunks, n = 10, 8, ROF_SIZE
    flag = torch.tensor(False, device=dev)
    x0, q0, f, w = kernel_inputs(n, n, 660, dev)  # mass on the dead duals
    lmb = torch.tensor(ROF_LMB, device=dev)
    radius = torch.tensor(1.0, device=dev)
    consts = (np.sqrt(2 * n * n), np.sqrt(n * n), 1.5, 0.95, 1.05, 0.8)
    m = {"nx": n, "ny": n, "f": f, "w": w, "dataterm": "square",
         "lmb": ROF_LMB, "radius": 1.0, "lmb_t": lmb, "radius_t": radius,
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "adapt_consts": consts}
    light = fr.ROFChunk(m, ri, dev)
    mlight = fr.ROFMultichunk(m, ri, chunks, "boyd", dev)
    check(light.resident and mlight.resident,
          f"rof_chunk / rof_multichunk: the shape rule streams {n}x{n}")
    print(f"rof_chunk and rof_multichunk {n}x{n}: the shape rule takes the "
          "resident path")

    scal = torch.tensor([0.9, 1.1, 1.0, ROF_LMB, 1.0], device=dev)
    for dataterm in ("square", "wsquare", "abs"):
        for count in (1, ri):
            got = {}
            for path in ("streaming", "resident"):
                cur = [x0.clone(), q0.clone()]
                prev = [torch.full_like(t, float("nan")) for t in cur]
                norms2 = fr.rof_chunk_(*cur, *prev, f, w, scal, count,
                                       dataterm, path=path).clone()
                got[path] = cur + prev + [norms2]
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                          got["resident"]))
                  and all(bool(torch.isfinite(t).all())
                          for t in got["resident"])
                  and bool((got["resident"][4] > 0).all()),
                  f"rof_chunk {dataterm} count {count}: the resident launch "
                  "is not the launch sequence")
    print(f"rof_chunk {n}x{n}: resident bit-equal to the launch sequence in "
          "the planes, the previous iterates and the 4 squared norms at "
          "counts 1 and 10 for square, wsquare and abs")

    def mscal(tol, tau=0.9, sigma=1.1):
        return torch.tensor([tau, sigma, 1.0, ROF_LMB, 1.0, 0.5, 0.0, 0.0,
                             1.0, tol, tol, tol, tol], device=dev)

    def both(x, q, fd, sc, dataterm, stepsize):
        got = {}
        for path in ("streaming", "resident"):
            cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
            norms, sout = fr.rof_multichunk_(*cur, *prev, fd, w, sc, ri,
                                             chunks, dataterm, stepsize,
                                             consts, path=path)
            got[path] = cur + prev + [norms.clone(), sout.clone()]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["resident"]))
              and all(bool(torch.isfinite(t).all())
                      for t in got["resident"]),
              f"rof_multichunk {dataterm} {stepsize}: the resident launch is "
              "not the launch sequence")
        return got["resident"][5]

    for dataterm in ("square", "wsquare", "abs"):
        for stepsize in ("boyd", "alg1"):
            sout = both(x0, q0, f, mscal(0.0), dataterm, stepsize)
            check(sout[6].item() == chunks,
                  "rof_multichunk: not every chunk ran")
    # a solve's start (x = f = the test image, q = 0): the first tolerance
    # at which the launch converges before its last chunk
    fimg = torch.from_numpy(test_image(n, n)).to(dev)
    for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4, 1e-4):
        sout = both(fimg, torch.zeros_like(q0), fimg, mscal(tol, 1.0, 1.0),
                    "square", "boyd")
        if sout[5].item() == 1.0 and 1 < sout[6].item() < chunks:
            break
    check(sout[5].item() == 1.0 and sout[6].item() < chunks,
          "rof_multichunk: no tolerance converged mid-launch")
    print(f"rof_multichunk {n}x{n}: resident bit-equal to the launch "
          f"sequence in the planes, previous iterates, norms and sout, every "
          f"chunk run under boyd and alg1 for square, wsquare and abs, and "
          f"converging at tolerance {tol:g} after {int(sout[6].item())} "
          f"chunks (sout {sout.tolist()})")

    out = {}
    bufs = {p: [x0.clone(), q0.clone(), x0.clone(), q0.clone()]
            for p in ("streaming", "resident")}

    def chunk_run(path, count=ri):
        return lambda: fr.rof_chunk_(*bufs[path], f, w, scal, count,
                                     "square", path=path)

    def chunk_copying():
        return halo_copy(lambda *a: fr.rof_chunk_(*a, path="streaming"),
                         (x0, q0), f, w, scal, ri, "square")

    lcur, lprev = [x0.clone(), q0.clone()], [x0.clone(), q0.clone()]
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0, 0.5, 0.0,
                                                   0.0)]

    def chunk_light():
        return light(lcur, lprev, f, w, *steps[:3], flag)

    out["rof_chunk"] = resident_turns(
        f"rof_chunk {n}x{n}", chunk_run, chunk_copying, chunk_light,
        "rof_resident", ri - 1, reps=50)

    mbufs = {p: ([x0.clone(), q0.clone()], [x0.clone(), q0.clone()])
             for p in ("streaming", "resident")}
    sc0 = mscal(0.0)

    def multi_run(path, count=ri):
        return lambda: fr.rof_multichunk_(
            *mbufs[path][0], *mbufs[path][1], f, w, sc0, count, chunks,
            "square", "boyd", consts, path=path)

    def multi_copying():
        cur = [x0.clone(), q0.clone()]
        prev = [t.clone() for t in cur]
        return cur, prev, fr.rof_multichunk_(
            *cur, *prev, f, w, sc0, ri, chunks, "square", "boyd", consts,
            path="streaming")

    mcur, mprev = [x0.clone(), q0.clone()], [x0.clone(), q0.clone()]
    it0 = torch.tensor(1, device=dev)

    def multi_light():
        return mlight(mcur, mprev, *steps, it0, flag)

    out["rof_multichunk"] = resident_turns(
        f"rof_multichunk {n}x{n}, {chunks} chunks", multi_run, multi_copying,
        multi_light, "rof_multichunk_resident", chunks * (ri - 1))

    sms, smem = fr.card_limits(dev)
    msmem = fr.card_limits(dev, True)[1]
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory a ROF chunk block, {msmem} a multichunk block (they hold "
          f"{fr.resident_bytes(n, n, sms)} and "
          f"{fr.resident_bytes(n, n, sms, multi=True)} at {n}x{n}, "
          f"{fr.resident_bytes(n, n, sms, 'wsquare', True)} for the "
          f"multichunk with wsquare)")
    for nx, ny in ((2048, 1536), (2048, 2048)):
        check(fr.route_of(nx, ny, "square", ri, sms, smem,
                          fr.tiled_limit(dev)) == "tiled"
              and fr.route_of(nx, ny, "square", ri, sms, msmem,
                              fr.tiled_limit(dev), True) == "tiled",
              f"the shape rule did not tile {nx}x{ny}'s chunk or "
              "multichunk")
        bx, bq, bf, bw = kernel_inputs(nx, ny, 661, dev)
        for fn, args in ((fr.rof_chunk_, (scal, 2)),
                         (fr.rof_multichunk_, (mscal(0.0), 2, 2, "square",
                                               "boyd", consts))):
            try:
                fn(bx, bq, bx.clone(), bq.clone(), bf, bw, *args,
                   path="resident")
            except ptt.ProstError:
                continue
            check(False, f"{fn.__name__} {nx}x{ny}: path='resident' did not "
                  "raise")
        print(f"rof_chunk_ and rof_multichunk_ {nx}x{ny}: the shape rule "
              f"tiles ({fr.resident_bytes(nx, ny, sms)} bytes a resident "
              "block); path='resident' raises ProstError")
    return out


def phase_resident_ml_halo(dev):
    """Rows 13 and 3 grid-resident against their launch sequences at the
    main path's shapes: ``ml_multichunk_`` at config 3's 256x256x8 and the
    ragged 250x190x5 (ri 10, 8 chunks) under boyd and goldstein, every
    chunk run and, from a solve's start on the cow's unaries, at the first
    tolerance at which the launch converges before its last chunk (planes,
    previous iterates, norms and sout), and at 512x512x8 on the streaming
    path (``path="resident"`` raises); ``rof_chunk_halo_`` on config 1's
    512x512 cut into 1, 2 and 4 bands (ri 10, halo 22) for the square,
    wsquare and abs data terms: every band's resident launch bit-equal to
    its streaming sequence (planes, previous iterates, owned-row norms),
    its owned rows bit-equal to the whole-plane resident chunk's, and the
    bands' owned-row norms summed within HALO_NORM_RTOL of the whole
    plane's; the path the shape rule takes (2092x2048 is tiled); each path
    in place on buffers made once, in turns (streaming, resident,
    resident, streaming), with the hand-written kernels each launches per
    call and their traced device ms; and the call, the copying one (the
    wrapper on copies, the launch sequence, for the multichunk; for the
    halo chunk the sharded route's old call: the scalars stacked and the
    in-place halo chunk with buffers made per call) against the route's
    light call in place (``MLMultichunk``, ``ROFChunk`` on the band), in
    turns."""
    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.parallel.spatial_fused import window

    ri, chunks = 10, 8
    flag = torch.tensor(False, device=dev)
    out = {}

    # row 13
    def mscal(tol, tau=0.9, sigma=1.1):
        return torch.tensor([tau, sigma, 1.0, ML_LMB, 1.0, 0.5, 0.0, 0.0,
                             1.0, tol, tol, tol, tol], device=dev)

    def consts_of(L, nx, ny):
        n = nx * ny
        return (np.sqrt(2 * n * L + n), np.sqrt(n * L), 1.5, 0.95, 1.05,
                0.8)

    def both(u, q, s, f, sc, stepsize, label):
        L, nx, ny = u.shape
        got = {}
        for path in ("streaming", "resident"):
            cur = [u.clone(), q.clone(), s.clone()]
            prev = [torch.full_like(t, float("nan")) for t in cur]
            norms, sout = fm.ml_multichunk_(*cur, *prev, f, sc, ri, chunks,
                                            stepsize, consts_of(L, nx, ny),
                                            path=path)
            got[path] = cur + prev + [norms.clone(), sout.clone()]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["streaming"],
                                                      got["resident"]))
              and all(bool(torch.isfinite(t).all())
                      for t in got["resident"]),
              f"ml_multichunk {label}: the resident launch is not the "
              "launch sequence")
        return got["resident"][7]

    for seed, (L, nx, ny) in enumerate(((ML_LABELS, ML_SIZE, ML_SIZE),
                                        (5, 250, 190))):
        shape = f"{nx}x{ny}x{L}"
        check(fm.resident_ok(L, nx, ny, *fm.card_limits(dev, L, multi=True),
                             multi=True),
              f"ml_multichunk: the shape rule streams {shape}")
        u, q, s, f = ml_kernel_inputs(L, nx, ny, 670 + seed, dev)
        fcow = torch.from_numpy(ml_unaries(cow_gray(ny, nx), L)).to(
            dev).reshape(L, nx, ny)
        zeros = [torch.zeros_like(fcow), torch.zeros((2 * L, nx, ny),
                                                     device=dev),
                 torch.zeros((nx, ny), device=dev)]
        for stepsize in ("boyd", "goldstein"):
            sout = both(u, q, s, f, mscal(0.0), stepsize,
                        f"{shape} {stepsize}")
            check(sout[5:].tolist() == [0.0, chunks],
                  "ml_multichunk: not every chunk ran")
            for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4, 1e-4):
                sout = both(*zeros, fcow, mscal(tol, 1.0, 1.0), stepsize,
                            f"{shape} {stepsize} tol {tol:g}")
                if sout[5].item() == 1.0 and 1 < sout[6].item() < chunks:
                    break
            check(sout[5].item() == 1.0 and sout[6].item() < chunks,
                  f"ml_multichunk {shape} {stepsize}: no tolerance "
                  "converged mid-launch")
            print(f"ml_multichunk {shape} {stepsize}: resident bit-equal to "
                  f"the launch sequence in the planes, previous iterates, "
                  f"norms and sout, every chunk run and converging at "
                  f"tolerance {tol:g} after {int(sout[6].item())} chunks "
                  f"(sout {sout.tolist()})")

    L, n = ML_LABELS, ML_SIZE
    u0, q0, s0, f = ml_kernel_inputs(L, n, n, 672, dev)
    consts = consts_of(L, n, n)
    m = {"L": L, "nx": n, "ny": n, "f": f,
         "radius_t": torch.tensor(ML_LMB, device=dev),
         "d_s_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(0.0, device=dev) for _ in range(4)),
         "adapt_consts": consts}
    mlight = fm.MLMultichunk(m, ri, chunks, "boyd", dev)
    check(mlight.resident, f"MLMultichunk: the shape rule streams "
          f"{n}x{n}x{L}")
    mbufs = {p: ([u0.clone(), q0.clone(), s0.clone()],
                 [u0.clone(), q0.clone(), s0.clone()])
             for p in ("streaming", "resident")}
    sc0 = mscal(0.0)

    def multi_run(path, count=ri):
        return lambda: fm.ml_multichunk_(
            *mbufs[path][0], *mbufs[path][1], f, sc0, count, chunks, "boyd",
            consts, path=path)

    def multi_copying():
        cur = [u0.clone(), q0.clone(), s0.clone()]
        prev = [t.clone() for t in cur]
        return cur, prev, fm.ml_multichunk_(*cur, *prev, f, sc0, ri, chunks,
                                            "boyd", consts,
                                            path="streaming")

    lcur = [u0.clone(), q0.clone(), s0.clone()]
    lprev = [t.clone() for t in lcur]
    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0, 0.5, 0.0,
                                                   0.0)]
    it0 = torch.tensor(1, device=dev)

    def multi_light():
        return mlight(lcur, lprev, *steps, it0, flag)

    out["ml_multichunk"] = resident_turns(
        f"ml_multichunk {n}x{n}x{L}, {chunks} chunks", multi_run,
        multi_copying, multi_light, "ml_multichunk_resident",
        chunks * (ri - 1))
    sms, smem = fm.card_limits(dev, L, multi=True)
    print(f"resident limits: {sms} SMs, {smem} bytes of dynamic shared "
          f"memory a multilabel multichunk block (it holds "
          f"{fm.resident_bytes(L, n, n, sms, True)} at {n}x{n}x{L}; "
          f"{ML_LARGE}x{ML_LARGE}x{L} streams: "
          f"{fm.resident_bytes(L, ML_LARGE, ML_LARGE, sms, True)})")
    check(fm.ml_pick_route(None, L, ML_LARGE, ML_LARGE, dev, True,
                           "ml_multichunk")[0] == "tiled",
          f"the shape rule did not tile {ML_LARGE}x{ML_LARGE}x{L}'s "
          "multichunk")
    bu, bq, bs, bf = ml_kernel_inputs(L, ML_LARGE, ML_LARGE, 673, dev)
    bargs = (bf, mscal(0.0), 2, 2, "boyd", consts_of(L, ML_LARGE, ML_LARGE))
    try:
        fm.ml_multichunk_(bu, bq, bs, bu.clone(), bq.clone(), bs.clone(),
                          *bargs, path="resident")
        check(False, "ml_multichunk_ 512x512x8: path='resident' did not "
              "raise")
    except ptt.ProstError:
        pass
    traced = csrc_launches(lambda: fm.ml_multichunk_(
        bu, bq, bs, bu.clone(), bq.clone(), bs.clone(), *bargs),
        lambda c: len(c) > 1)[0]
    check("ml_multichunk_resident" not in traced
          and traced.count("ml_tiled") == 2
          and all(bool(torch.isfinite(t).all()) for t in (bu, bq, bs)),
          f"ml_multichunk_ {ML_LARGE}x{ML_LARGE}x{L} did not run tiled")
    print(f"ml_multichunk_ {ML_LARGE}x{ML_LARGE}x{L}: tiled by the shape "
          f"rule ({len(traced)} hand-written launches at 2 chunks of 2); "
          "path='resident' raises ProstError")

    # row 3
    nr, H = ROF_SIZE, 2 * ri + 2
    planes = kernel_inputs(nr, nr, 674, dev)  # mass on the dead duals
    head = [0.9, 1.1, 1.0, ROF_LMB, 1.0]
    for dataterm in ("square", "wsquare", "abs"):
        whole = [t.clone() for t in planes[:2]]
        wprev = [torch.empty_like(t) for t in whole]
        wn = fr.rof_chunk_(*whole, *wprev, *planes[2:],
                           torch.tensor(head, device=dev), ri, dataterm,
                           path="resident").clone()
        for shards in HALO_SHARDS:
            rs = nr // shards
            total = torch.zeros(4, dtype=torch.float64, device=dev)
            for rank in range(shards):
                lo = rank * rs - H
                ext = [window(a, lo, lo + rs + 2 * H) for a in planes]
                scal = torch.tensor(head + [lo, H, H + rs], device=dev)
                check(fr.resident_ok(rs + 2 * H, nr, dataterm,
                                     *fr.card_limits(dev)),
                      f"rof_chunk_halo: the shape rule streams the "
                      f"{rs + 2 * H}-row band")
                got = {}
                for path in ("streaming", "resident"):
                    cur = [t.clone() for t in ext[:2]]
                    prev = [torch.full_like(t, float("nan")) for t in cur]
                    norms2 = fr.rof_chunk_halo_(*cur, *prev, *ext[2:], scal,
                                                ri, nr, dataterm,
                                                path=path).clone()
                    got[path] = cur + prev + [norms2]
                torch.cuda.synchronize()
                res = got["resident"]
                check(all(torch.equal(a, b) for a, b in
                          zip(got["streaming"], res))
                      and all(bool(torch.isfinite(t).all()) for t in res),
                      f"rof_chunk_halo {dataterm} band {rank} of {shards}: "
                      "the resident launch is not the launch sequence")
                check(all(torch.equal(a[..., H:H + rs, :],
                                      b[..., rank * rs:(rank + 1) * rs, :])
                          for a, b in zip(res[:4], whole + wprev)),
                      f"rof_chunk_halo {dataterm} band {rank} of {shards}: "
                      "the owned rows are not the whole-plane chunk's")
                total += res[4].double()
            rel = float(torch.max(torch.abs(total - wn.double())
                                  / torch.abs(wn.double())))
            check(rel <= HALO_NORM_RTOL,
                  f"rof_chunk_halo {dataterm}: the norms of {shards} bands "
                  "do not sum to the whole plane's")
            print(f"rof_chunk_halo {nr}x{nr} {dataterm}, {shards} band(s) of "
                  f"{rs + 2 * H} rows: resident bit-equal to the launch "
                  f"sequence in the planes, previous iterates and owned-row "
                  f"norms; owned rows bit-equal to the whole-plane resident "
                  f"chunk; the bands' norms against the whole plane's: max "
                  f"rel diff {rel:.3e} (tol {HALO_NORM_RTOL:g})")
    ext = [window(a, -H, nr + H) for a in planes]
    scal = torch.tensor(head + [-H, H, H + nr], device=dev)
    hbufs = {p: ([t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]])
             for p in ("streaming", "resident")}

    def halo_run(path, count=ri):
        return lambda: fr.rof_chunk_halo_(*hbufs[path][0], *hbufs[path][1],
                                          *ext[2:], scal, count, nr,
                                          path=path)

    # the sharded route's old call: the scalars stacked from the state's
    # and the route's tensors, the in-place halo chunk with buffers made
    # per call, on the route's buffers
    ccur, cprev = [t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]]
    consts_t = [torch.tensor(v, device=dev) for v in head[3:]]
    rows_t = [torch.tensor(float(v), device=dev) for v in (-H, H, H + nr)]

    def halo_copying():
        sc = torch.stack([*steps[:3], *consts_t, *rows_t,
                          flag.to(torch.float32)])
        return fr.rof_chunk_halo_(*ccur, *cprev, *ext[2:], sc, ri, nr,
                                  path="streaming")

    rm = {"nx": nr, "ny": nr, "dataterm": "square", "lmb": ROF_LMB,
          "radius": 1.0}
    hlight = fr.ROFChunk(rm, ri, dev, (nr, nr + 2 * H, -H, H, H + nr))
    check(hlight.resident, f"ROFChunk: the shape rule streams the "
          f"{nr + 2 * H}-row band")
    hcur, hprev = [t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]]

    def halo_light():
        return hlight(hcur, hprev, *ext[2:], *steps[:3], flag)

    out["rof_chunk_halo"] = resident_turns(
        f"rof_chunk_halo {nr + 2 * H}x{nr} band", halo_run, halo_copying,
        halo_light, "rof_resident", ri - 1, reps=50)
    sms, smem = fr.card_limits(dev)
    big = 2048 + 2 * H
    print(f"resident limits: a ROF chunk block holds "
          f"{fr.resident_bytes(nr + 2 * H, nr, sms)} bytes on the "
          f"{nr + 2 * H}-row band ({smem} allowed); the {big}x2048 band "
          f"is tiled ({fr.resident_bytes(big, 2048, sms)} bytes a resident "
          "block)")
    check(fr.route_of(big, 2048, "square", ri, sms, smem,
                      fr.tiled_limit(dev)) == "tiled",
          f"the shape rule did not tile the {big}x2048 band")
    return out


def deblur_pairs_turns(views, x, y, fb, sv, scal, taps, ri, reps=20):
    """Row 18's two grid-resident forms at deblur8x512's shape, in place
    on a route's rows ``x``, ``y`` (``views`` cuts them into the frames'
    planes): the frames one after another (``deblur_resident_batched``
    with G = 1, a block of 512 threads a frame) and two at a time side by
    side (G = 2, a block of 1024 threads, each half a frame, the form the
    shape rule takes, whose traced device ms
    ``resident_turns`` reports), from the same inputs bit-equal; in turns
    (serial, pairs, pairs, serial), each a launch with no PyTorch kernel
    around it, timed by CUDA events."""
    import torch

    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops.pdhg_chunk import (S_CONV, S_LEN,
                                                instance_strides,
                                                scalar_buffer)

    dev = x.device
    B, nx, ny = views(x, y)[0].shape
    nx2, ny2 = views(x, y)[1].shape[-2:]
    limits = fd.card_limits(dev, fd.PAIRS)
    check(fd.pairs_ok(nx2, ny, ny2, taps, *limits),
          f"deblur_chunk_batched: two {nx}x{ny} frames do not fit a block "
          f"({2 * fd.resident_bytes(nx2, ny, ny2, taps, limits[0])} bytes, "
          f"{limits[1]} allowed)")
    taps_t = fd.taps_array(tuple(taps), dev)

    def form(pairs, count=ri):
        cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = torch.empty(4 * B * fd._lib().prost_deblur_num_blocks(
            nx2, ny2), dtype=torch.float32, device=dev)
        scratch = fd._scratch("resident", nx, ny, nx2, ny2, dev, B, pairs)
        st, pv = views(*cur), views(*prev)
        strides = instance_strides(st, pv, "deblur_chunk_batched_")

        def go():
            fd._launch_batched(st, pv, fb, sv, taps_t, sc, partial, scratch,
                               True, count, taps, 0.5, 0.2, strides, pairs)
            return sc

        return go, cur + prev

    outs = {}
    for pairs in (False, True):
        go, bufs = form(pairs)
        sc = go()
        outs[pairs] = bufs + [sc[:, 15:19].clone()]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(outs[False], outs[True])),
          "deblur_chunk_batched: the frames two at a time are not the frames "
          "one after another")
    (s1, s2), (p1, p2) = in_turns(form(False)[0], form(True)[0], reps)
    (c1, c2), (q1, q2) = in_turns(form(False, 1)[0], form(True, 1)[0], reps)
    print(f"deblur_chunk_batched {B}x{nx}x{ny}, two frames a block: "
          f"bit-equal to one frame a block; in place, in turns: one a block "
          f"{s1:.4f} ms, two {p1:.4f}, two {p2:.4f}, one {s2:.4f} ms/call; "
          f"at count 1: one a block {c1:.4f} ms, two {q1:.4f}, two "
          f"{q2:.4f}, one {c2:.4f} ms/call")
    return {"serial_ms": (s1, s2), "pairs_ms": (p1, p2),
            "count1_serial_ms": (c1, c2), "count1_pairs_ms": (q1, q2)}


def resident_turns(label, run, copying, call, kernel, extra_iters,
                   reps=20):
    """The timings of one resident redesign: ``run(path, count)`` makes a
    call of its in-place form on buffers made once; ``copying`` and
    ``call`` the copying call and the route's light call.  Both paths in
    turns (streaming, resident, resident, streaming; ``reps`` calls
    each), their traced hand-written launches and device ms, the resident
    launch at count 1 (``extra_iters``: the iterations that the full
    count adds), and the two calls in turns.  Fails unless the resident
    path and the light call are one launch of ``kernel``."""
    (o1, o2), (r1, r2) = in_turns(run("streaming"), run("resident"), reps)
    t_old, t_new = traced_call(run("streaming")), traced_call(
        run("resident"))
    one = traced_call(run("resident", 1))["csrc_ms"]
    check(t_new["csrc"] == [kernel],
          f"{label}: the resident path launched {t_new['csrc']}")
    (c1, c2), (l1, l2) = in_turns(copying, call, reps)
    t_copy, t_call = traced_call(copying), traced_call(call)
    check(t_call["csrc"] == [kernel],
          f"{label}: the light call launched {t_call['csrc']}")
    print(f"{label}: resident launch bit-equal to the streaming sequence; "
          f"in place, in turns: streaming {o1:.4f} ms, resident {r1:.4f}, "
          f"resident {r2:.4f}, streaming {o2:.4f} ms/call; hand-written "
          f"launches per call: streaming {len(t_old['csrc'])} "
          f"({t_old['csrc_ms']:.4f} ms of device time traced), resident "
          f"{len(t_new['csrc'])} ({kernel}; {t_new['csrc_ms']:.4f} ms; at "
          f"count 1 {one:.4f} ms, each further iteration "
          f"{(t_new['csrc_ms'] - one) / extra_iters:.5f} ms)")
    print(f"{label}, the call in turns: copying (wrapper on copies, "
          f"streaming) {c1:.4f} ms, light call {l1:.4f}, light call "
          f"{l2:.4f}, copying {c2:.4f} ms/call; traced: copying "
          f"{len(t_copy['csrc'])} hand-written ({t_copy['csrc_ms']:.4f} ms) "
          f"and {t_copy['torch_kernels']} PyTorch kernels "
          f"({t_copy['torch_ms']:.4f} ms), light call {len(t_call['csrc'])} "
          f"({t_call['csrc_ms']:.4f} ms) and {t_call['torch_kernels']} "
          f"({t_call['torch_ms']:.4f} ms)")
    return {"streaming_ms": (o1, o2), "resident_ms": (r1, r2),
            "copying_call_ms": (c1, c2), "light_call_ms": (l1, l2),
            "launches": (len(t_old["csrc"]), len(t_new["csrc"])),
            "device_ms": (t_old["csrc_ms"], t_new["csrc_ms"]),
            "count1_device_ms": one}


def copying_routes():
    """A context in which the ROF, deblur, multilabel, tight and volumetric
    routes, whole-plane (``FusedROFPDHG``) and halo-sharded
    (``ShardedFusedROF``, ``ShardedFusedDeblur``,
    ``ShardedFusedMultilabel``, ``ShardedFusedTight``,
    ``ShardedFusedVol``), ``BatchedPDHG``'s multilabel, volumetric,
    deblur and tight routes, the ROF, multilabel and volumetric routes'
    multichunks and ``FusedROFADMM``'s chunks and multichunks make the
    copying call that the light calls replace: the scalars
    stacked per chunk, the functional wrapper on copies of the state with
    buffers made per call, the streaming launch sequence, and y and y_prev
    concatenated after the chunk (whole plane, ensemble, the ROF,
    multilabel and vol multichunks' copies of the state planes); the
    scalars stacked from tensors made once per route and the in-place
    halo chunk with buffers made per call (sharded); the scalars stacked,
    copies of the seven state arrays, the launch sequence and sout stacked
    (ADMM)."""
    import contextlib

    import torch

    from prost_tpu_torch.backend.admm import (admm_residual_adapt,
                                              cg_tolerance)
    from prost_tpu_torch.backend.pdhg import hold_if
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.ops.pdhg_chunk import (canonical_duals, chunk_state,
                                                halo_copy, multichunk_state,
                                                run_pdhg_route)
    from prost_tpu_torch.ops.phases import K_CHUNKS
    from prost_tpu_torch.parallel import ensemble as ens
    from prost_tpu_torch.parallel import spatial_fused as sf

    def streaming(fn):
        return lambda *a: fn(*a, path="streaming")

    def flat_y(q, s):
        return torch.cat([q.reshape(-1), s.reshape(-1)])

    def rows(B, *planes):
        """The (B, n) rows of a state vector from its per-instance
        planes."""
        return torch.cat([a.reshape(B, -1) for a in planes], dim=1)

    def deblur_chunk(b, s):
        d, ri = b.deblur, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([s.tau, s.sigma, s.theta, d["lmb_t"],
                            d["radius_t"], s.converged.to(s.x.dtype)])
        x2, yv2, q2, xp, yvp, qp, norms2 = halo_copy(
            streaming(fd.deblur_chunk_), fd._planes(d, s.x, s.y), d["fb"],
            d["sv"], scal, ri, d["taps"], d["sig_q"], d["tau_t"])
        return chunk_state(b, s, ri, x2.reshape(-1),
                           torch.cat([yv2.reshape(-1), q2.reshape(-1)]),
                           xp.reshape(-1),
                           torch.cat([yvp.reshape(-1), qp.reshape(-1)]),
                           norms2)

    def ml_chunk(b, s):
        m, ri = b.ml, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([s.tau, s.sigma, s.theta, m["radius_t"],
                            m["d_s_t"], s.converged.to(s.x.dtype)])
        u2, q2, s2, up, qp, sp, norms2 = halo_copy(
            streaming(fm.ml_chunk_), fm._planes(m, s.x, s.y), m["f"], scal,
            ri)
        return chunk_state(b, s, ri, u2.reshape(-1), flat_y(q2, s2),
                           up.reshape(-1), flat_y(qp, sp), norms2)

    def tight_chunk(b, s):
        t, ri = b.tight, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([s.tau, s.sigma, s.theta, t["radius_t"],
                            t["d_s_t"], s.converged.to(s.x.dtype)])
        u2, v2, q2, p2, s2, up, vp, qp, pp, sp, norms2 = halo_copy(
            streaming(ft.tight_chunk_), ft._planes(t, s.x, s.y), t["f"], scal,
            ri, t["taps"], t["consts"])

        def flat(*planes):
            return torch.cat([a.reshape(-1) for a in planes])

        return chunk_state(b, s, ri, flat(u2, v2), flat(q2, p2, s2),
                           flat(up, vp), flat(qp, pp, sp), norms2)

    def vol_chunk(b, s):
        v, ri = b.vol, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([s.tau, s.sigma, s.theta, v["lmb_t"],
                            v["radius_t"], s.converged.to(s.x.dtype)])
        u2, q2, up, qp, norms2 = halo_copy(
            streaming(fv.vol_chunk_), fv._volumes(v, s.x, s.y), v["f"],
            v["w"], scal, ri, v["dataterm"])
        return chunk_state(b, s, ri, u2.reshape(-1), q2.reshape(-1),
                           up.reshape(-1), qp.reshape(-1), norms2)

    def tight_run(b, state, until, start):
        return run_pdhg_route(b, state, until, start,
                              lambda s: tight_chunk(b, s))

    def vol_multi(b, s):
        v, ri = b.vol, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([
            s.tau, s.sigma, s.theta, v["lmb_t"], v["radius_t"],
            s.arg_alpha, s.arb_l, s.arb_u, s.iteration.to(s.x.dtype),
            *v["tols_t"], s.converged.to(s.x.dtype)])
        cur = [t.contiguous().clone() for t in fv._volumes(v, s.x, s.y)]
        prev = [t.clone() for t in cur]
        norms, sc = fv.vol_multichunk_(
            *cur, *prev, v["f"], v["w"], scal, ri, K_CHUNKS, v["dataterm"],
            b.opts.stepsize, v["adapt_consts"], path="streaming")
        return multichunk_state(s, ri, *[t.reshape(-1) for t in cur + prev],
                                norms, sc)

    def rof_chunk(b, s):
        r, ri = b.rof, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([s.tau, s.sigma, s.theta, r["lmb_t"],
                            r["radius_t"], s.converged.to(s.x.dtype)])
        x2, q2, xp, qp, norms2 = halo_copy(
            streaming(fr.rof_chunk_), fr._planes(r, s.x, s.y), r["f"],
            r["w"], scal, ri, r["dataterm"])
        return chunk_state(b, s, ri, x2.reshape(-1), q2.reshape(-1),
                           xp.reshape(-1), qp.reshape(-1), norms2)

    def rof_multi(b, s):
        r, ri = b.rof, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([
            s.tau, s.sigma, s.theta, r["lmb_t"], r["radius_t"],
            s.arg_alpha, s.arb_l, s.arb_u, s.iteration.to(s.x.dtype),
            *r["tols_t"], s.converged.to(s.x.dtype)])
        cur = [t.contiguous().clone() for t in fr._planes(r, s.x, s.y)]
        prev = [t.clone() for t in cur]
        norms, sc = fr.rof_multichunk_(
            *cur, *prev, r["f"], r["w"], scal, ri, K_CHUNKS, r["dataterm"],
            b.opts.stepsize, r["adapt_consts"], path="streaming")
        return multichunk_state(s, ri, *[t.reshape(-1) for t in cur + prev],
                                norms, sc)

    def ml_multi(b, s):
        m, ri = b.ml, max(int(b.opts.residual_iter), 1)
        scal = torch.stack([
            s.tau, s.sigma, s.theta, m["radius_t"], m["d_s_t"],
            s.arg_alpha, s.arb_l, s.arb_u, s.iteration.to(s.x.dtype),
            *m["tols_t"], s.converged.to(s.x.dtype)])
        cur = [t.contiguous().clone() for t in fm._planes(m, s.x, s.y)]
        prev = [t.clone() for t in cur]
        norms, sc = fm.ml_multichunk_(
            *cur, *prev, m["f"], scal, ri, K_CHUNKS, b.opts.stepsize,
            m["adapt_consts"], path="streaming")
        return multichunk_state(s, ri, cur[0].reshape(-1),
                                flat_y(cur[1], cur[2]), prev[0].reshape(-1),
                                flat_y(prev[1], prev[2]), norms, sc)

    def rof_run(b, state, until, start):
        r = b.rof
        return run_pdhg_route(b, state, until, start,
                              lambda s: rof_chunk(b, s),
                              canonical_duals(1, r["nx"], r["ny"]),
                              lambda s: rof_multi(b, s))

    def vol_run(b, state, until, start):
        v = b.vol
        return run_pdhg_route(b, state, until, start,
                              lambda s: vol_chunk(b, s),
                              canonical_duals(v["L"], v["nx"], v["ny"]),
                              lambda s: vol_multi(b, s))

    def halo_step(fn, consts, extra):
        """A halo route's copying ``_chunk_step``: scal8 stacked from the
        state's scalars and tensors of the route's two scalars and row
        context (made on its first chunk), ``fn`` in place on the route's
        buffers with buffers of its own made per call, the launch
        sequence."""
        def step(self, s, cur, prev):
            if "_copy_scal" not in self.__dict__:
                like = s.tau
                self._copy_scal = [like.new_full((), float(v)) for v in (
                    *(self.m[k] for k in consts), self.lo, self.halo,
                    self.halo + self.rows)]
            scal = torch.stack([s.tau, s.sigma, s.theta, *self._copy_scal,
                                s.converged.to(s.tau.dtype)])
            return fn(*cur, *prev, *self.data, scal, self.ri, self.m["nx"],
                      *extra(self.m), path="streaming")
        return step

    def deblur_run(b, state, until, start):
        return run_pdhg_route(b, state, until, start,
                              lambda s: deblur_chunk(b, s))

    def ml_run(b, state, until, start):
        m = b.ml
        return run_pdhg_route(b, state, until, start,
                              lambda s: ml_chunk(b, s),
                              canonical_duals(m["L"], m["nx"], m["ny"]),
                              lambda s: ml_multi(b, s))


    def ml_batched(self, s, done):
        m, B = self.ml, self.batch
        L, nx, ny = m["L"], m["nx"], m["ny"]
        n2 = 2 * L * nx * ny
        u2, q2, s2, up, qp, sp, norms2 = halo_copy(
            streaming(fm.ml_chunk_batched_),
            (s.x.reshape(B, L, nx, ny), s.y[:, :n2].reshape(B, 2 * L, nx, ny),
             s.y[:, n2:].reshape(B, nx, ny)), m["f"],
            self._scal(s, m["radius"], m["d_s"], done), self.ri)
        return self._after_chunk(s, u2.reshape(B, -1), rows(B, q2, s2),
                                 up.reshape(B, -1), rows(B, qp, sp),
                                 norms2, done)

    def vol_batched(self, s, done):
        v, B = self.vol, self.batch
        L, nx, ny = v["L"], v["nx"], v["ny"]
        u2, q2, up, qp, norms2 = halo_copy(
            streaming(fv.vol_chunk_batched_),
            (s.x.reshape(B, L, nx, ny), s.y.reshape(B, 3, L, nx, ny)),
            v["f"], v["w"], self._scal(s, v["lmb"], v["radius"], done),
            self.ri, v["dataterm"])
        return self._after_chunk(s, u2.reshape(B, -1), q2.reshape(B, -1),
                                 up.reshape(B, -1), qp.reshape(B, -1),
                                 norms2, done)

    def deblur_batched(self, s, done):
        d, B = self.deblur, self.batch
        nx, ny, nx2, ny2 = d["nx"], d["ny"], d["nx2"], d["ny2"]
        m2 = nx2 * ny2
        x2, yv2, q2, xp, yvp, qp, norms2 = halo_copy(
            streaming(fd.deblur_chunk_batched_),
            (s.x.reshape(B, nx, ny), s.y[:, :m2].reshape(B, nx2, ny2),
             s.y[:, m2:].reshape(B, 2, nx, ny)), d["fb"], d["sv"],
            self._scal(s, d["lmb"], d["radius"], done), self.ri, d["taps"],
            d["sig_q"], d["tau_t"])
        return self._after_chunk(s, x2.reshape(B, -1), rows(B, yv2, q2),
                                 xp.reshape(B, -1), rows(B, yvp, qp),
                                 norms2, done)

    def tight_batched(self, s, done):
        t, B = self.tight, self.batch
        L, k, nx, ny = t["L"], t["k"], t["nx"], t["ny"]
        nL, nk2 = nx * ny * L, 2 * nx * ny * k
        x, y = s.x, s.y
        u2, v2, q2, p2, s2, up, vp, qp, pp, sp, norms2 = halo_copy(
            streaming(ft.tight_chunk_batched_),
            (x[:, :nL].reshape(B, L, nx, ny),
             x[:, nL:].reshape(B, 2 * k, nx, ny),
             y[:, :2 * nL].reshape(B, 2 * L, nx, ny),
             y[:, 2 * nL:2 * nL + nk2].reshape(B, 2 * k, nx, ny),
             y[:, 2 * nL + nk2:].reshape(B, nx, ny)), t["f"],
            self._scal(s, t["radius"], t["d_s"], done), self.ri, t["taps"],
            t["consts"])
        return self._after_chunk(s, rows(B, u2, v2), rows(B, q2, p2, s2),
                                 rows(B, up, vp), rows(B, qp, pp, sp),
                                 norms2, done)

    def admm_chunk(b, s):
        r, opts = b.rof, b.run_opts
        ri, dt = max(int(opts.residual_iter), 1), s.x_half.dtype
        cheby = b.mode == "cheby"
        cg_tols = None
        if not cheby:
            it_f = (s.iteration + 1 + r["steps"]).to(dt)
            cg_tols = torch.clamp(cg_tolerance(it_f, opts),
                                  min=10.0 * torch.finfo(dt).eps)
        scal = torch.stack([s.rho, r["lmb_t"], r["radius_t"],
                            s.converged.to(dt)])
        planes = [t.contiguous().clone()
                  for t in fa._planes_of(s, r["nx"], r["ny"])]
        norms = torch.sqrt(fa.admm_chunk_(
            *planes, r["f"], r["w"], scal, cg_tols, ri, opts.cg_max_iter,
            opts.alpha, r["dataterm"], opts.cheby_degree if cheby else None,
            path="streaming"))
        new = fa._with_planes(s, planes, iteration=s.iteration + ri)
        new = admm_residual_adapt(b.problem, opts, b.tols, new, norms[0],
                                  norms[1], norms[2], norms[3])
        return hold_if(s.converged, s, new)

    def admm_multi(b, s):
        r, opts = b.rof, b.run_opts
        ri, dt = max(int(opts.residual_iter), 1), s.x_half.dtype
        scal = torch.stack([
            s.rho, r["lmb_t"], r["radius_t"], s.delta, s.arb_l, s.arb_u,
            s.iteration.to(dt), *r["tols_t"], s.converged.to(dt)])
        planes = [t.contiguous().clone()
                  for t in fa._planes_of(s, r["nx"], r["ny"])]
        norms, sc = fa.admm_multichunk_(
            *planes, r["f"], r["w"], scal, ri, K_CHUNKS, opts.alpha,
            opts.cheby_degree, r["consts"], r["dataterm"], path="streaming")
        new = fa._with_planes(
            s, planes, rho=sc[0], delta=sc[1], arb_l=sc[2], arb_u=sc[3],
            converged=sc[4] > 0.5, primal_residual=norms[0],
            primal_var_norm=norms[1], dual_residual=norms[2],
            dual_var_norm=norms[3],
            iteration=s.iteration + sc[5].to(torch.int32) * ri)
        return hold_if(s.converged, s, new)

    patches = [(fr, "_fused_rof_run", rof_run),
               (fr, "fused_deblur_run", deblur_run),
               (fr, "fused_ml_run", ml_run),
               (fr, "fused_tight_run", tight_run),
               (fr, "fused_vol_run", vol_run),
               (ens.BatchedPDHG, "_ml_chunk", ml_batched),
               (ens.BatchedPDHG, "_vol_chunk", vol_batched),
               (ens.BatchedPDHG, "_deblur_chunk", deblur_batched),
               (ens.BatchedPDHG, "_tight_chunk", tight_batched),
               (fa, "_fused_chunk", admm_chunk),
               (fa, "_multi_chunk", admm_multi),
               (sf.ShardedFusedROF, "_chunk_step", halo_step(
                   fr.rof_chunk_halo_, ("lmb", "radius"),
                   lambda m: (m["dataterm"],))),
               (sf.ShardedFusedDeblur, "_chunk_step", halo_step(
                   fd.deblur_chunk_halo_, ("lmb", "radius"),
                   lambda m: (m["taps"], m["sig_q"], m["tau_t"]))),
               (sf.ShardedFusedMultilabel, "_chunk_step", halo_step(
                   fm.ml_chunk_halo_, ("radius", "d_s"), lambda m: ())),
               (sf.ShardedFusedTight, "_chunk_step", halo_step(
                   ft.tight_chunk_halo_, ("radius", "d_s"),
                   lambda m: (m["taps"], m["consts"]))),
               (sf.ShardedFusedVol, "_chunk_step", halo_step(
                   fv.vol_chunk_halo_, ("lmb", "radius"),
                   lambda m: (m["dataterm"],)))]

    @contextlib.contextmanager
    def patched():
        saved = [(obj, name, obj.__dict__.get(name, None))
                 for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            yield
        finally:
            for obj, name, fn in saved:
                if fn is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, fn)

    return patched()


def route_turns(label, solve, energy, card="", exact=False):
    """``solve()`` (a 2000-iteration solve: (result, backend, dt)) with the
    copying chunk call (``copying_routes``) and with the light call, in
    turns (copying, light, light, copying): the iterating it/s of each and
    their energies, which must agree (the kernels are bit-equal, the
    host's scalar work the same): within SINGLE_RTOL, or with ``exact``
    to the last digit."""
    runs = []
    for old in (True, False, False, True):
        if old:
            with copying_routes():
                res, backend, _ = solve()
        else:
            res, backend, _ = solve()
        runs.append((res.iterations / backend.loop_s, energy(res.x),
                     res.iterations))
    (a, ea, ia), (b, eb, ib), (c, ec, ic), (d, ed, id_) = runs
    rel = max(abs(e - ea) / abs(ea) for e in (eb, ec, ed))
    print(f"{label} in turns: copying chunk call {a:.1f} it/s, light call "
          f"{b:.1f}, {c:.1f}, copying {d:.1f} it/s ({ia}, {ib}, {ic}, {id_} "
          f"iterations); energies' max rel diff {rel:.3e} (tol "
          f"{SINGLE_RTOL:g}) [{card}]")
    check((rel == 0.0 if exact else rel <= SINGLE_RTOL)
          and len({ia, ib, ic, id_}) == 1,
          f"{label}: the light and the copying chunk calls disagree")
    return {"copying_it_s": (a, d), "it_s": (b, c)}


def phase_route_turns(card):
    """Config 1, config 2, config 3, tight128x4, vol256x8 and config 4
    through the fused routes, the light chunk calls (config 1, vol256x8 and
    config 4: chunk and multichunk) against the copying ones
    (``route_turns``), 2000 iterations at 1e-5."""
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions

    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    f1 = test_image(ROF_SIZE, ROF_SIZE).reshape(-1)
    out = {"rof": route_turns(
        f"config 1 fused route {ROF_SIZE}x{ROF_SIZE}",
        lambda: timed_solve(recording("pdhg", opts), ROF_SIZE, ROF_SIZE, f1,
                            ROF_LMB, 2000),
        lambda x: rof_energy(x, f1, ROF_LMB, ROF_SIZE, ROF_SIZE), card=card,
        exact=True)}
    fb = deblur_data(DB_SIZE, DB_SIZE)
    f = ml_unaries(cow_gray(ML_SIZE, ML_SIZE), ML_LABELS)
    out["deblur"] = route_turns(
        f"config 2 fused route {DB_SIZE}x{DB_SIZE}",
        lambda: run_model(recording("pdhg", opts),
                          deblur_model(DB_SIZE, DB_SIZE, fb),
                          DB_SIZE * DB_SIZE, 2000),
        lambda x: deblur_energy(x, fb, DB_LMB, DB_SIZE, DB_SIZE), card=card)
    out["ml"] = route_turns(
        f"config 3 fused route {ML_SIZE}x{ML_SIZE}x{ML_LABELS}",
        lambda: run_model(recording("pdhg", opts),
                          ml_model(ML_SIZE, ML_SIZE, ML_LABELS, f, ML_LMB),
                          ML_SIZE * ML_SIZE * ML_LABELS, 2000),
        lambda x: ml_energy(x, f, ML_LMB, ML_LABELS, ML_SIZE, ML_SIZE),
        card=card)
    L, nt = TIGHT_LABELS, TIGHT_SIZE
    k = L * (L - 1) // 2
    t_f = tight_unaries(nt, nt, L)
    out["tight"] = route_turns(
        f"tight128x4 fused route {nt}x{nt}x{L}",
        lambda: run_model(recording("pdhg", opts),
                          tight_model(nt, nt, L, t_f), nt * nt * (L + 2 * k),
                          2000),
        lambda x: tight_measures(x, t_f, TIGHT_LMB, L, nt, nt)[0],
        card=card, exact=True)
    vol_f = vol_data(VOL_LABELS, VOL_SIZE, VOL_SIZE)
    out["vol"] = route_turns(
        f"vol256x8 fused route {VOL_SIZE}x{VOL_SIZE}x{VOL_LABELS}",
        lambda: run_model(recording("pdhg", opts),
                          vol_model(VOL_SIZE, VOL_SIZE, VOL_LABELS, vol_f),
                          VOL_SIZE * VOL_SIZE * VOL_LABELS, 2000),
        lambda x: vol_energy(x, vol_f, VOL_LMB, VOL_LABELS, VOL_SIZE,
                             VOL_SIZE), card=card, exact=True)
    f4 = test_image(ROF_SIZE, ROF_SIZE).reshape(-1)
    out["admm"] = route_turns(
        f"config 4 fused route {ROF_SIZE}x{ROF_SIZE} (Chebyshev ADMM)",
        lambda: timed_solve(recording("admm", ADMMOptions(residual_iter=10)),
                            ROF_SIZE, ROF_SIZE, f4, ROF_LMB, 2000),
        lambda x: rof_energy(x, f4, ROF_LMB, ROF_SIZE, ROF_SIZE), card=card,
        exact=True)
    return out


def admm_halo_turns(ext, scal, tail):
    """Row 10 at the one-shard band: ``admm_iter_halo_`` with the norms
    (the route's last iteration of a chunk) in turns with the launch
    sequence of ``admm_chunk`` at count 1 on the band's planes as a whole
    plane (old, new, new, old), both in place on buffers made once and
    each call with its own scratch as ``admm_iter_halo_`` makes it; the
    hand-written kernels each launches per call, and the cooperative
    launch's blocks."""
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops.pdhg_chunk import launch

    lib = fa._lib()
    degree, alpha = tail[0], tail[1]
    nx, ny = ext[0].shape
    old_bufs = [t.clone() for t in ext[:7]]
    new_bufs = [t.clone() for t in ext[:7]]
    coeffs = fa._coeff_array(degree)

    def old():
        wk = fa._Work(lib, old_bufs, scal, 3)
        launch(lib, "prost_admm_chunk", "admm_chunk", fa.launch_counts,
               ext[0].device, wk.buffers(*ext[7:]), nx, ny, None, 1,
               fa.DATATERMS["square"], degree, coeffs, 0, alpha, 1.0 - alpha)

    def new():
        fa.admm_iter_halo_(*new_bufs, *ext[7:], scal, *tail)

    (o1, o2), (n1, n2) = in_turns(old, new, 50)
    (lo, do), (ln, dn) = csrc_launches(old), csrc_launches(new)
    print(f"admm_iter_halo_ with norms at {nx}x{ny} in turns: admm_chunk "
          f"count 1 {o1:.4f} ms, cooperative {n1:.4f}, cooperative "
          f"{n2:.4f}, admm_chunk {o2:.4f} ms/call; hand-written launches "
          f"per call: admm_chunk {len(lo)} ({do:.4f} ms of device time "
          f"traced), admm_iter_halo_ {len(ln)} ({', '.join(ln)}; "
          f"{dn:.4f} ms); {lib.prost_admm_coop_blocks()} blocks of 512 "
          "threads")
    check(ln == ["admm_iter_coop"], f"admm_iter_halo_ launched {ln}")


SHARDED_KINDS = ("rof", "ml", "vol", "deblur", "tight", "admm")


def sharded_solves(rank, world, init_method, card):
    """This rank's part of phase 16: config 1, config 3, vol256x8, config
    2, tight128x4 and config 4 solved through the halo-sharded routes, and
    ensemble1024x128 through BatchedPDHG over a dp mesh, on the NCCL group;
    {kind: results}."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel import (ShardedFusedADMM,
                                          ShardedFusedDeblur,
                                          ShardedFusedMultilabel,
                                          ShardedFusedROF, ShardedFusedTight,
                                          ShardedFusedVol, make_mesh)

    torch.cuda.set_device(rank)
    ptt.set_device(f"cuda:{rank}")
    dist.init_process_group("nccl", init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh((world,), axis_names=("sp",))
        ml_f = ml_unaries(cow_gray(ML_SIZE, ML_SIZE), ML_LABELS)
        vol_f = vol_data(VOL_LABELS, VOL_SIZE, VOL_SIZE)
        n = ROF_SIZE
        rof_f = test_image(n, n).reshape(-1)
        db_fb = deblur_data(DB_SIZE, DB_SIZE)
        L, nt = TIGHT_LABELS, TIGHT_SIZE
        k = L * (L - 1) // 2
        t_f = tight_unaries(nt, nt, L)
        # config 2's halo is 154 rows at ri 10 (the blur's row reach is 7):
        # shards of fewer rows of the 520-row grid run at ri 5 (halo 84)
        db_taps = fd.kernel_taps(torch.as_tensor(motion_kernel(DB_KLEN).T,
                                                 dtype=torch.float32))
        db_rows = (DB_SIZE + DB_KLEN - 1) // world
        db_ri = 10 if db_rows >= fd.deblur_halo_rows(10, db_taps) else 5
        pdhg = PDHGOptions(stepsize="boyd", residual_iter=10)
        runs = {
            "rof": (ShardedFusedROF, fr, lambda: rof_model(
                n, n, rof_f, ROF_LMB), n * n,
                lambda x: rof_energy(x, rof_f, ROF_LMB, n, n)),
            "ml": (ShardedFusedMultilabel, fm, lambda: ml_model(
                ML_SIZE, ML_SIZE, ML_LABELS, ml_f, ML_LMB),
                ML_SIZE * ML_SIZE * ML_LABELS,
                lambda x: ml_energy(x, ml_f, ML_LMB, ML_LABELS, ML_SIZE,
                                    ML_SIZE)),
            "vol": (ShardedFusedVol, fv, lambda: vol_model(
                VOL_SIZE, VOL_SIZE, VOL_LABELS, vol_f),
                VOL_SIZE * VOL_SIZE * VOL_LABELS,
                lambda x: vol_energy(x, vol_f, VOL_LMB, VOL_LABELS,
                                     VOL_SIZE, VOL_SIZE)),
            "deblur": (ShardedFusedDeblur, fd, lambda: deblur_model(
                DB_SIZE, DB_SIZE, db_fb), DB_SIZE * DB_SIZE,
                lambda x: deblur_energy(x, db_fb, DB_LMB, DB_SIZE, DB_SIZE)),
            "tight": (ShardedFusedTight, ft, lambda: tight_model(
                nt, nt, L, t_f), nt * nt * (L + 2 * k),
                lambda x: tight_measures(x, t_f, TIGHT_LMB, L, nt, nt)[0]),
            "admm": (ShardedFusedADMM, fa, lambda: rof_model(
                n, n, rof_f, ROF_LMB), n * n,
                lambda x: rof_energy(x, rof_f, ROF_LMB, n, n)),
        }
        out = {}
        for kind in SHARDED_KINDS:
            cls, mod, model, ncols, energy = runs[kind]
            opts = {"admm": ("admm", ADMMOptions(residual_iter=10)),
                    "deblur": ("pdhg", PDHGOptions(stepsize="boyd",
                                                   residual_iter=db_ri))
                    }.get(kind, ("pdhg", pdhg))

            def make(p, o, so, cls=cls):
                return cls(p, o, so, mesh)

            def solve(iters, opts=opts, make=make, model=model,
                      ncols=ncols):
                return run_model(recording(*opts, make), model(), ncols,
                                 iters)

            solve(200)  # warm-up
            mod.reset_launch_counts()
            res, backend, dt = solve(2000)
            name = ("admm_iter_halo" if kind == "admm"
                    else f"{kind}_chunk_halo")
            launches = {k: v for k, v in mod.launch_counts.items() if v}
            check(set(launches) == {name} and launches[name] > 0,
                  f"the sharded {kind} route launched {launches}")
            counts = backend.made.exchange.counts
            print(f"rank {rank}: sharded {kind} solve: "
                  f"{rates(res, backend, dt)}; launches {launches}, "
                  f"exchanges {counts} [{card}]")
            out[kind] = {"result": res.result.value,
                         "iterations": res.iterations,
                         "it_s": res.iterations / backend.loop_s,
                         "energy": energy(res.x),
                         "launches": mod.launch_counts[name],
                         "name": name, "ri": opts[1].residual_iter,
                         "backend": dist.get_backend()}
            if kind in ("rof", "ml", "deblur", "vol", "tight"):
                out[kind]["turns"] = route_turns(
                    f"rank {rank}: sharded {kind} route on {world} rank(s)",
                    lambda solve=solve: solve(2000), energy, card)
        out["admm65"] = cheby65(rank, world, mesh, card)
        out["deblur2048"] = deblur_large_sharded(rank, world, mesh, card)
        out["ml512"] = ml_large_sharded(rank, world, mesh, card)
        out["tight512"] = tight_large_sharded(rank, world, mesh, card)
        out["vol512"] = vol_large_sharded(rank, world, mesh, card)
        out["dp"] = dp_ensemble(rank, world, card)
        return out
    finally:
        dist.destroy_process_group()


def deblur_large_sharded(rank, world, mesh, card):
    """ShardedFusedDeblur on config 2 at 2048x2048 (DB_LARGE, 300
    iterations at ri 10): each rank's band of the yv grid with its 154
    rows of halo each side takes the tiled halo chunk; its energy against
    the one-card fused route's, which each rank solves too.  Returns the
    tiled halo launches and the relative difference."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.parallel import ShardedFusedDeblur

    n = DB_LARGE
    fb = deblur_data(n, n)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    one, _, _ = run_model(recording("pdhg", opts), deblur_model(n, n, fb),
                          n * n, 300, num_cback_calls=2)
    fd.reset_launch_counts()
    res, backend, _ = run_model(
        recording("pdhg", opts,
                  lambda p, o, so: ShardedFusedDeblur(p, o, so, mesh)),
        deblur_model(n, n, fb), n * n, 300, num_cback_calls=2)
    launches = {k: v for k, v in fd.launch_counts.items() if v}
    check(set(launches) == {"deblur_chunk_halo", "deblur_chunk_halo_tiled"}
          and launches["deblur_chunk_halo_tiled"]
          == launches["deblur_chunk_halo"] > 0,
          f"the sharded {n}x{n} deblur route launched {launches}")
    e, e1 = (deblur_energy(r.x, fb, DB_LMB, n, n) for r in (res, one))
    rel = abs(e - e1) / abs(e1)
    print(f"rank {rank}: sharded deblur solve {n}x{n} on {world} rank(s) "
          f"(tiled halo chunk, route {backend.made.call.route}): "
          f"{res.result.value} after {res.iterations} iterations, "
          f"{res.iterations / backend.loop_s:.1f} it/s; energy {e:.6f}, "
          f"one card {e1:.6f}, rel diff {rel:.3e} (tol {ENERGY_RTOL:g}); "
          f"launches {launches} [{card}]")
    check(rel <= ENERGY_RTOL, f"the sharded {n}x{n} deblur energy "
          "disagrees with the one-card fused route's")
    return {"launches": launches["deblur_chunk_halo_tiled"], "rel": rel}


def ml_large_sharded(rank, world, mesh, card):
    """ShardedFusedMultilabel on the cow's unaries at 512x512x8 (ML_LARGE,
    300 iterations at ri 10): each rank's band with its 22 rows of halo
    each side takes the tiled halo chunk; its energy against the one-card
    fused route's (tiled too), which each rank solves too.  Returns the
    tiled halo launches and the relative difference."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.parallel import ShardedFusedMultilabel

    n, L = ML_LARGE, ML_LABELS
    f = ml_unaries(cow_gray(n, n), L)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    one, _, _ = run_model(recording("pdhg", opts),
                          ml_model(n, n, L, f, ML_LMB), n * n * L, 300,
                          num_cback_calls=2)
    fm.reset_launch_counts()
    res, backend, _ = run_model(
        recording("pdhg", opts,
                  lambda p, o, so: ShardedFusedMultilabel(p, o, so, mesh)),
        ml_model(n, n, L, f, ML_LMB), n * n * L, 300, num_cback_calls=2)
    launches = {k: v for k, v in fm.launch_counts.items() if v}
    check(set(launches) == {"ml_chunk_halo", "ml_chunk_halo_tiled"}
          and launches["ml_chunk_halo_tiled"] == launches["ml_chunk_halo"]
          > 0, f"the sharded {n}x{n}x{L} multilabel route launched "
          f"{launches}")
    e, e1 = (ml_energy(r.x, f, ML_LMB, L, n, n) for r in (res, one))
    rel = abs(e - e1) / abs(e1)
    print(f"rank {rank}: sharded multilabel solve {n}x{n}x{L} on {world} "
          f"rank(s) (tiled halo chunk, route {backend.made.call.route}): "
          f"{res.result.value} after {res.iterations} iterations, "
          f"{res.iterations / backend.loop_s:.1f} it/s; energy {e:.6f}, one "
          f"card {e1:.6f}, rel diff {rel:.3e} (tol {ENERGY_RTOL:g}); "
          f"launches {launches} [{card}]")
    check(rel <= ENERGY_RTOL, f"the sharded {n}x{n}x{L} multilabel energy "
          "disagrees with the one-card fused route's")
    return {"launches": launches["ml_chunk_halo_tiled"], "rel": rel}


def tight_large_sharded(rank, world, mesh, card):
    """ShardedFusedTight on junction_gray's unaries at 512x512x4
    (TIGHT_LARGE, 300 iterations at ri 10): each rank's band with its 22
    rows of halo each side takes the tiled halo chunk; its energy against
    the one-card fused route's (tiled too), which each rank solves too.
    Returns the tiled halo launches and the relative difference."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel import ShardedFusedTight

    n, L = TIGHT_LARGE, TIGHT_LABELS
    ncols = n * n * (L + L * (L - 1))
    f = tight_unaries(n, n, L)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    one, _, _ = run_model(recording("pdhg", opts), tight_model(n, n, L, f),
                          ncols, 300, num_cback_calls=2)
    ft.reset_launch_counts()
    res, backend, _ = run_model(
        recording("pdhg", opts,
                  lambda p, o, so: ShardedFusedTight(p, o, so, mesh)),
        tight_model(n, n, L, f), ncols, 300, num_cback_calls=2)
    launches = {key: v for key, v in ft.launch_counts.items() if v}
    check(set(launches) == {"tight_chunk_halo", "tight_chunk_halo_tiled"}
          and launches["tight_chunk_halo_tiled"]
          == launches["tight_chunk_halo"] > 0,
          f"the sharded {n}x{n}x{L} tight route launched {launches}")
    e, e1 = (tight_measures(r.x, f, TIGHT_LMB, L, n, n)[0]
             for r in (res, one))
    rel = abs(e - e1) / abs(e1)
    print(f"rank {rank}: sharded tight solve {n}x{n}x{L} on {world} rank(s) "
          f"(tiled halo chunk, route {backend.made.call.route}): "
          f"{res.result.value} after {res.iterations} iterations, "
          f"{res.iterations / backend.loop_s:.1f} it/s; energy {e:.6f}, one "
          f"card {e1:.6f}, rel diff {rel:.3e} (tol {ENERGY_RTOL:g}); "
          f"launches {launches} [{card}]")
    check(rel <= ENERGY_RTOL, f"the sharded {n}x{n}x{L} tight energy "
          "disagrees with the one-card fused route's")
    return {"launches": launches["tight_chunk_halo_tiled"], "rel": rel}


def vol_large_sharded(rank, world, mesh, card):
    """ShardedFusedVol on 8 noisy slices of data/dog.png at 512x512x8
    (VOL_LARGE, 300 iterations at ri 10): each rank's band with its 22
    rows of halo each side takes the tiled halo chunk; its energy against
    the one-card fused route's (tiled too), which each rank solves too.
    Returns the tiled halo launches and the relative difference."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel import ShardedFusedVol

    n, L = VOL_LARGE, VOL_LABELS
    f = vol_data(L, n, n)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    one, _, _ = run_model(recording("pdhg", opts), vol_model(n, n, L, f),
                          n * n * L, 300, num_cback_calls=2)
    fv.reset_launch_counts()
    res, backend, _ = run_model(
        recording("pdhg", opts,
                  lambda p, o, so: ShardedFusedVol(p, o, so, mesh)),
        vol_model(n, n, L, f), n * n * L, 300, num_cback_calls=2)
    launches = {k: v for k, v in fv.launch_counts.items() if v}
    check(set(launches) == {"vol_chunk_halo", "vol_chunk_halo_tiled"}
          and launches["vol_chunk_halo_tiled"] == launches["vol_chunk_halo"]
          > 0, f"the sharded {n}x{n}x{L} volumetric route launched "
          f"{launches}")
    e, e1 = (vol_energy(r.x, f, VOL_LMB, L, n, n) for r in (res, one))
    rel = abs(e - e1) / abs(e1)
    print(f"rank {rank}: sharded vol solve {n}x{n}x{L} on {world} rank(s) "
          f"(tiled halo chunk, route {backend.made.call.route}): "
          f"{res.result.value} after {res.iterations} iterations, "
          f"{res.iterations / backend.loop_s:.1f} it/s; energy {e:.6f}, one "
          f"card {e1:.6f}, rel diff {rel:.3e} (tol {ENERGY_RTOL:g}); "
          f"launches {launches} [{card}]")
    check(rel <= ENERGY_RTOL, f"the sharded {n}x{n}x{L} volumetric energy "
          "disagrees with the one-card fused route's")
    return {"launches": launches["vol_chunk_halo_tiled"], "rel": rel}


def cheby65(rank, world, mesh, card):
    """ShardedFusedADMM at Chebyshev degree 65, above the 64 that a fixed
    launch argument of its halo iteration once held (ROADMAP C3), on
    config 4's model (ROF 512x512): 300 iterations against the one-card
    fused ADMM route at the same degree; None where a shard holds fewer
    rows than the degree's halo (136)."""
    from prost_tpu_torch.backend import ADMMOptions
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.parallel import ShardedFusedADMM

    n = ROF_SIZE
    if n // world < fa.admm_cheby_halo_rows(65):
        print(f"rank {rank}: Chebyshev degree 65 not run: shards of "
              f"{n // world} rows")
        return None
    f = test_image(n, n).reshape(-1)
    opts = ADMMOptions(residual_iter=10, cheby_degree=65)
    fa.reset_launch_counts()
    res, backend, dt = run_model(
        recording("admm", opts,
                  lambda p, o, so: ShardedFusedADMM(p, o, so, mesh)),
        rof_model(n, n, f, ROF_LMB), n * n, 300)
    launches = fa.launch_counts["admm_iter_halo"]
    one, one_b, one_dt = run_model(recording("admm", opts),
                                   rof_model(n, n, f, ROF_LMB), n * n, 300)
    e, e_one = (rof_energy(r.x, f, ROF_LMB, n, n) for r in (res, one))
    rel = abs(e - e_one) / abs(e_one)
    print(f"rank {rank}: sharded ADMM at Chebyshev degree 65 on {world} "
          f"rank(s): {rates(res, backend, dt)}, admm_iter_halo launches "
          f"{launches}; energy {e:.8f}, one-card fused route "
          f"{e_one:.8f} ({rates(one, one_b, one_dt)}), rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g}) [{card}]")
    check(launches > 0 and rel <= ENERGY_RTOL,
          "the sharded ADMM route at degree 65 disagrees with one card")
    return {"energy": e, "one_card": e_one, "rel": rel}

def dp_ensemble(rank, world, card):
    """ensemble1024x128 through BatchedPDHG over a dp mesh of the group's
    ranks, ENS_WARM + 300 iterations; on rank 0 every field of every
    instance (gathered) against the one-card BatchedPDHG's, bit for bit."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.parallel import BatchedPDHG, make_mesh

    iters = 300
    fs, lmbs = ensemble_data(ENS_B, ENS_SIZE, ENS_SIZE)
    problems = [ensemble_problem(ENS_SIZE, ENS_SIZE, f, lmb)
                for f, lmb in zip(fs, lmbs)]
    opts, sopts = ens_opts()
    b = BatchedPDHG(problems, opts, sopts,
                    make_mesh((world,), axis_names=("dp",)))
    check(b.rof is not None and b.batch == ENS_B // world,
          "the dp ensemble did not take the fused route on its share")
    fr.reset_launch_counts()
    state, dt = ensemble_run(b, ENS_WARM, iters)
    launches = fr.launch_counts["rof_chunk_batched"]
    rate = ENS_B * iters / dt
    gathered = {k: b.gather(v) for k, v in vars(state).items()}
    print(f"rank {rank}: dp ensemble {ENS_B}x{ENS_SIZE}x{ENS_SIZE} on "
          f"{world} rank(s), {b.batch} instances each: {iters} iterations in "
          f"{dt:.4f} s = {rate:.1f} instance-it/s, rof_chunk_batched "
          f"launches {launches}, flag all-reduces {b.flag_reduces} [{card}]")
    equal = None
    if rank == 0:
        one = BatchedPDHG(problems, opts, sopts)
        ref, _ = ensemble_run(one, ENS_WARM, iters)
        equal = all(torch.equal(gathered[k], v)
                    for k, v in vars(ref).items())
        del one, ref
    del b, problems, state, gathered
    torch.cuda.empty_cache()
    return {"equal": equal, "rate": rate, "launches": launches}


def _sharded_rank(rank, world, init_method, card, results):
    """A spawned rank of phase 16 (more than one card)."""
    try:
        results.put((rank, sharded_solves(rank, world, init_method, card),
                     None))
    except Exception as e:  # reported by the parent
        results.put((rank, None, repr(e)))


def phase_sharded_solve(card, one_card):
    """Phase 16: the halo-sharded routes on one NCCL rank per card, each
    energy against ``one_card[kind]``, the one-card fused route's; the
    sharded deblur route at 2048x2048, the sharded multilabel route at
    512x512x8, the sharded tight route at 512x512x4 and the sharded
    volumetric route at 512x512x8 on their tiled halo chunks
    (``deblur_large_sharded``, ``ml_large_sharded``, ``tight_large_sharded``,
    ``vol_large_sharded``)."""
    import multiprocessing as mp
    import os
    import tempfile

    import torch

    world = torch.cuda.device_count()
    init = f"file://{os.path.join(tempfile.mkdtemp(), 'pg')}"
    if world == 1:
        per_rank = [sharded_solves(0, 1, init, card)]
    else:
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_sharded_rank,
                             args=(r, world, init, card, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            got = dict((r, (out, err)) for r, out, err in
                       (results.get(timeout=900) for _ in range(world)))
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        errors = [f"rank {r}: {e}" for r, (_, e) in got.items() if e]
        check(not errors, f"sharded solves failed: {errors}")
        per_rank = [got[r][0] for r in range(world)]
    launches = {}
    for kind in SHARDED_KINDS:
        res = per_rank[0][kind]
        rel = abs(res["energy"] - one_card[kind]) / abs(one_card[kind])
        print(f"sharded {kind} solve on {world} rank(s), backend "
              f"{res['backend']}, residual_iter {res['ri']}: {res['result']} "
              f"after {res['iterations']} iterations, {res['it_s']:.1f} "
              f"it/s; energy {res['energy']:.8f}, one-card fused "
              f"{one_card[kind]:.8f}, rel diff {rel:.3e} (tol "
              f"{ENERGY_RTOL:g}) [{card}]")
        check(rel <= ENERGY_RTOL, f"the sharded {kind} energy disagrees "
              "with the one-card fused route's")
        check(all(r[kind]["energy"] == res["energy"] for r in per_rank),
              f"the ranks disagree on the sharded {kind} solution")
        launches[res["name"]] = sum(r[kind]["launches"] for r in per_rank)
    launches["deblur_chunk_halo_tiled"] = sum(
        r["deblur2048"]["launches"] for r in per_rank)
    launches["ml_chunk_halo_tiled"] = sum(r["ml512"]["launches"]
                                          for r in per_rank)
    launches["tight_chunk_halo_tiled"] = sum(r["tight512"]["launches"]
                                             for r in per_rank)
    launches["vol_chunk_halo_tiled"] = sum(r["vol512"]["launches"]
                                           for r in per_rank)
    c65 = per_rank[0]["admm65"]
    if c65 is not None:
        print(f"sharded ADMM at Chebyshev degree 65 on {world} rank(s): "
              f"energy rel diff to one card {c65['rel']:.3e} (tol "
              f"{ENERGY_RTOL:g}) [{card}]")
    dp = per_rank[0]["dp"]
    print(f"dp ensemble on {world} rank(s): every field of every instance "
          f"{'equal to' if dp['equal'] else 'DIFFERS from'} the one-card "
          f"BatchedPDHG's; {dp['rate']:.1f} instance-it/s [{card}]")
    check(dp["equal"], "the dp ensemble differs from the one-card run")
    return launches


def clone_args(args):
    """``args`` with every tensor in it (also in lists and tuples)
    cloned."""
    import torch

    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, (list, tuple)):
        return type(args)(clone_args(a) for a in args)
    if isinstance(args, dict):
        return {k: clone_args(v) for k, v in args.items()}
    return args


class first_calls:
    """A context in which each light-call class of ``classes`` keeps its
    first call (the object and clones of the call's arguments, taken
    before it runs) in ``seen`` by class name, and runs as before."""

    def __init__(self, *classes):
        self.classes, self.seen = classes, {}

    def __enter__(self):
        self.saved = {c: c.__dict__.get("__call__") for c in self.classes}
        for cls in self.classes:
            orig = cls.__call__

            def call(obj, *args, _orig=orig, _name=cls.__name__, **kw):
                if _name not in self.seen:
                    self.seen[_name] = (obj, clone_args(args),
                                        clone_args(kw))
                return _orig(obj, *args, **kw)

            cls.__call__ = call
        return self.seen

    def __exit__(self, *exc):
        for cls, fn in self.saved.items():
            if fn is None:
                del cls.__call__
            else:
                cls.__call__ = fn


# rows of PERF.md's kernel table that the JAX package bands at its large
# shapes, each a tiled launch in the port: their traced calls at those
# shapes (phase_batched_kernels, phase_large)
BANDED = {}


def banded_row(row, label, seen, name, nbytes, ops):
    """BANDED's entry for table row ``row``: one call of the light call
    ``seen[name]`` (its first call of a solve, on clones of its
    arguments) traced, beside its bound."""
    if name not in seen:
        print(f"row {row} {label}: the solve made no {name} call (not "
              "measured)")
        return
    obj, args, kw = seen[name]
    # the card's tracer loses some of a call's kernels in more than half
    # of its traces late in a run: the fullest of eight
    t = max((traced_call(lambda: obj(*clone_args(args), **clone_args(kw)))
             for _ in range(8)), key=lambda t: len(t["csrc"]))
    check(len(t["csrc"]) > 0, f"{label}: no hand-written launch traced")
    b = bound(nbytes, ops)
    BANDED[row] = {"call": label, "launches_per_call": len(t["csrc"]),
                   "device_ms": t["csrc_ms"], "bound_ms": b[0],
                   "bound_by": b[1]}
    print(f"row {row} {label}: {len(t['csrc'])} hand-written launches a "
          f"call, {t['csrc_ms']:.4f} ms of device time traced, bound "
          f"{b[0]:.5f} ms ({b[1]})")


def vol_large(card, ri=10):
    """Phase 14's volumetric route at 512x512x8 (VOL_LARGE, 300
    iterations): its multichunks and chunks on the tiled path by the shape
    rule, their first calls traced as rows 27 and 28 (``banded_row``), the
    solve in turns with the streaming sequence (tiled, streaming,
    streaming, tiled: it/s, the energies equal).  Returns the tiled
    launches."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import fused_vol as fv

    tiled = {}
    nx = ny = VOL_LARGE
    L = VOL_LABELS
    f = vol_data(L, nx, ny)
    v_opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    fv.reset_launch_counts()
    with first_calls(fv.VolChunk, fv.VolMultichunk) as seen:
        res, backend, dt = run_model(
            recording("pdhg", v_opts), vol_model(nx, ny, L, f), nx * ny * L,
            300, num_cback_calls=2)
    launches = single_launches(fv)
    counted = {k: fv.launch_counts[k] for k in ("vol_chunk_tiled",
                                                "vol_multichunk_tiled")}
    nvox = nx * ny * L
    banded_row(28, f"vol_chunk {nx}x{ny}x{L} (tiled path)", seen,
               "VolChunk", 13 * nvox * 4, vol_chunk_ops(nvox, ri))
    banded_row(27, f"vol_multichunk {nx}x{ny}x{L} (8 chunks, tiled path)",
               seen, "VolMultichunk", 13 * nvox * 4,
               vol_chunk_ops(nvox, ri, 8))
    check(backend.made.vol is not None
          and all(v > 0 for v in launches.values()),
          f"a volumetric kernel was not launched at {nx}x{ny}x{L}: "
          f"{launches}")
    routes = (backend.made.vol["multi"].route,
              backend.made.vol["call"].route)
    check(all(r[0] == "tiled" for r in routes)
          and counted["vol_chunk_tiled"] == launches["vol_chunk"] > 0
          and counted["vol_multichunk_tiled"] == launches["vol_multichunk"]
          > 0, f"the {nx}x{ny}x{L} volumetric multichunks and chunks did "
          f"not run tiled: {routes}, {counted} tiled of {launches}")
    tiled.update(counted)
    e_tiled = vol_energy(res.x, f, VOL_LMB, L, nx, ny)
    check(np.isfinite(e_tiled), "the volumetric energy is not finite")
    print(f"fused vol solve {nx}x{ny}x{L} (multichunk and chunk on the "
          f"tiled path, tiles {routes[0][1]} and {routes[1][1]}; tiled "
          f"launches {counted}): {rates(res, backend, dt)}; energy "
          f"{e_tiled:.6f}, launches {launches} [{card}]")
    its = []
    for p in ("tiled", "streaming", "streaming", "tiled"):
        res, backend, dt = run_model(
            recording("pdhg", v_opts, vol_path=p), vol_model(nx, ny, L, f),
            nx * ny * L, 300, num_cback_calls=2)
        check(backend.made.vol["call"].route[0] == p
              and backend.made.vol["multi"].route[0] == p,
              f"the {nx}x{ny}x{L} volumetric solve did not take the {p} "
              "path")
        check(vol_energy(res.x, f, VOL_LMB, L, nx, ny) == e_tiled,
              f"the {p} {nx}x{ny}x{L} volumetric solve's energy is not the "
              "tiled one's")
        its.append(res.iterations / backend.loop_s)
    print(f"fused vol solve {nx}x{ny}x{L} in turns, iterating it/s: tiled "
          f"{its[0]:.1f}, streaming {its[1]:.1f}, streaming {its[2]:.1f}, "
          f"tiled {its[3]:.1f}; the four energies equal [{card}]")
    return tiled


def phase_large(card):
    """Both fused ROF routes at 2048x2048, the fused multilabel route at
    512x512x8, the deblur route at 2048x2048, the tight route at 512x512x4
    and the volumetric route at 512x512x8 (the JAX package's banded sizes):
    300 iterations in two callback epochs, each reaching the multichunk
    phase of the routes that have one; the PDHG ROF route's and the
    Chebyshev ADMM route's chunks and multichunks, and the deblur route's
    chunks, on the tiled path (their launches returned for the kernels
    line), the multilabel and volumetric routes' chunks and multichunks
    (``vol_large``) and the tight route's chunks on the tiled path too,
    and each of these solves in turns with the streaming sequence (tiled,
    streaming, streaming, tiled: it/s, the energies equal)."""
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops import fused_rof as fr
    from prost_tpu_torch.ops import fused_tight as ft

    nx = ny = 2048
    lmb = 16.0
    f = test_image(nx, ny).reshape(-1)
    ri = 10
    tiled = {}
    for kind, opts, mod in (
            ("pdhg", PDHGOptions(stepsize="boyd", residual_iter=10), fr),
            ("admm", ADMMOptions(residual_iter=10), fa)):
        mod.reset_launch_counts()
        res, backend, dt = timed_solve(recording(kind, opts), nx, ny, f, lmb,
                                       300, num_cback_calls=2)
        launches = single_launches(mod)
        check(all(v > 0 for v in launches.values()),
              f"a {kind} kernel was not launched at 2048x2048: {launches}")
        if kind == "pdhg":
            routes = (backend.made.rof["multi"].route,
                      backend.made.rof["call"].route)
            names = ("rof_chunk_tiled", "rof_multichunk_tiled")
        else:
            routes = (backend.made.rof["call"].route,
                      backend.made.rof["chunk"].route)
            names = ("admm_chunk_tiled", "admm_multichunk_tiled")
        counted = {k: mod.launch_counts[k] for k in names}
        check(all(r[0] == "tiled" for r in routes)
              and all(v > 0 for v in counted.values()),
              f"the 2048x2048 {kind} multichunk and chunk did not run "
              f"tiled: {routes}, {counted}")
        tiled.update(counted)
        e_tiled = rof_energy(res.x, f, lmb, nx, ny)
        print(f"fused {kind} solve 2048x2048 (multichunk and chunk on the "
              f"tiled path, tiles {routes[0][1]} and {routes[1][1]}; tiled "
              f"launches {counted}): {rates(res, backend, dt)}; energy "
              f"{e_tiled:.6f}, launches {launches} [{card}]")
        turns = []
        for p in ("tiled", "streaming", "streaming", "tiled"):
            paths = ({"rof_path": p} if kind == "pdhg"
                     else {"admm_path": p})
            res, backend, dt = timed_solve(recording(kind, opts, **paths),
                                           nx, ny, f, lmb, 300,
                                           num_cback_calls=2)
            key = "call" if kind == "pdhg" else "chunk"
            check(backend.made.rof[key].route[0] == p,
                  f"the 2048x2048 {kind} solve did not take the {p} path")
            check(rof_energy(res.x, f, lmb, nx, ny) == e_tiled,
                  f"the {p} 2048x2048 {kind} solve's energy is not the "
                  "tiled one's")
            turns.append(res.iterations / backend.loop_s)
        print(f"fused {kind} solve 2048x2048 in turns, iterating it/s: "
              f"tiled {turns[0]:.1f}, streaming {turns[1]:.1f}, "
              f"streaming {turns[2]:.1f}, tiled {turns[3]:.1f}; the four "
              f"energies equal [{card}]")

    nx = ny = ML_LARGE
    L = ML_LABELS
    f = ml_unaries(cow_gray(ny, nx), L)
    ml_opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    fm.reset_launch_counts()
    with first_calls(fm.MLChunk, fm.MLMultichunk) as seen:
        res, backend, dt = run_model(
            recording("pdhg", ml_opts), ml_model(nx, ny, L, f, ML_LMB),
            nx * ny * L, 300, num_cback_calls=2)
    launches = single_launches(fm)
    counted = {k: fm.launch_counts[k] for k in ("ml_chunk_tiled",
                                                "ml_multichunk_tiled")}
    n = nx * ny
    banded_row(16, f"ml_chunk {nx}x{ny}x{L} (tiled path)", seen, "MLChunk",
               (10 * L + 3) * n * 4, ml_chunk_ops(n, L, ri))
    banded_row(14, f"ml_multichunk {nx}x{ny}x{L} (8 chunks, tiled path)",
               seen, "MLMultichunk", (10 * L + 3) * n * 4,
               ml_chunk_ops(n, L, ri, 8))
    check(backend.made.ml is not None and all(v > 0
                                               for v in launches.values()),
          f"a multilabel kernel was not launched at {nx}x{ny}x{L}: "
          f"{launches}")
    routes = (backend.made.ml["multi"].route, backend.made.ml["call"].route)
    check(all(r[0] == "tiled" for r in routes)
          and counted["ml_chunk_tiled"] == launches["ml_chunk"] > 0
          and counted["ml_multichunk_tiled"] == launches["ml_multichunk"]
          > 0, f"the {nx}x{ny}x{L} multichunks and chunks did not run "
          f"tiled: {routes}, {counted} tiled of {launches}")
    tiled.update(counted)
    e_tiled = ml_energy(res.x, f, ML_LMB, L, nx, ny)
    print(f"fused multilabel solve {nx}x{ny}x{L} (multichunk and chunk on "
          f"the tiled path, tiles {routes[0][1]} and {routes[1][1]}; tiled "
          f"launches {counted}): {rates(res, backend, dt)}; energy "
          f"{e_tiled:.6f}, launches {launches} [{card}]")
    its = []
    for p in ("tiled", "streaming", "streaming", "tiled"):
        res, backend, dt = run_model(
            recording("pdhg", ml_opts, ml_path=p),
            ml_model(nx, ny, L, f, ML_LMB), nx * ny * L, 300,
            num_cback_calls=2)
        check(backend.made.ml["call"].route[0] == p
              and backend.made.ml["multi"].route[0] == p,
              f"the {nx}x{ny}x{L} multilabel solve did not take the {p} "
              "path")
        check(ml_energy(res.x, f, ML_LMB, L, nx, ny) == e_tiled,
              f"the {p} {nx}x{ny}x{L} multilabel solve's energy is not the "
              "tiled one's")
        its.append(res.iterations / backend.loop_s)
    print(f"fused multilabel solve {nx}x{ny}x{L} in turns, iterating it/s: "
          f"tiled {its[0]:.1f}, streaming {its[1]:.1f}, streaming "
          f"{its[2]:.1f}, tiled {its[3]:.1f}; the four energies equal "
          f"[{card}]")

    nx = ny = DB_LARGE
    fb = deblur_data(nx, ny)
    db_opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    fd.reset_launch_counts()
    with first_calls(fd.DeblurChunk) as seen:
        res, backend, dt = run_model(recording("pdhg", db_opts),
                                     deblur_model(nx, ny, fb), nx * ny, 300,
                                     num_cback_calls=2)
    launches = single_launches(fd)
    route = backend.made.deblur["call"].route
    counted = fd.launch_counts["deblur_chunk_tiled"]
    check(route[0] == "tiled" and counted == launches["deblur_chunk"] > 0,
          f"the {nx}x{ny} deblur chunks did not run tiled: {route}, "
          f"{counted} tiled of {launches}")
    tiled["deblur_chunk_tiled"] = counted
    dm = seen["DeblurChunk"][0].m
    n, m2, T = nx * ny, dm["nx2"] * dm["ny2"], len(dm["taps"])
    banded_row(19, f"deblur_chunk {nx}x{ny} ({T} taps, tiled path)", seen,
               "DeblurChunk", (9 * n + 5 * m2 + 3 * T) * 4,
               deblur_chunk_ops(n, m2, T, ri))
    e_tiled = deblur_energy(res.x, fb, DB_LMB, nx, ny)
    print(f"fused deblur solve {nx}x{ny} (tiled path, tile {route[1]}; "
          f"tiled launches {counted}): {rates(res, backend, dt)}; energy "
          f"{e_tiled:.6f}, launches {launches} [{card}]")
    its = []
    for p in ("tiled", "streaming", "streaming", "tiled"):
        res, backend, dt = run_model(
            recording("pdhg", db_opts, deblur_path=p),
            deblur_model(nx, ny, fb), nx * ny, 300, num_cback_calls=2)
        check(backend.made.deblur["call"].route[0] == p,
              f"the {nx}x{ny} deblur solve did not take the {p} path")
        check(deblur_energy(res.x, fb, DB_LMB, nx, ny) == e_tiled,
              f"the {p} {nx}x{ny} deblur solve's energy is not the tiled "
              "one's")
        its.append(res.iterations / backend.loop_s)
    print(f"fused deblur solve {nx}x{ny} in turns, iterating it/s: tiled "
          f"{its[0]:.1f}, streaming {its[1]:.1f}, streaming {its[2]:.1f}, "
          f"tiled {its[3]:.1f}; the four energies equal [{card}]")

    nx = ny = TIGHT_LARGE
    L = TIGHT_LABELS
    k = L * (L - 1) // 2
    f = tight_unaries(nx, ny, L)
    t_opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    ft.reset_launch_counts()
    with first_calls(ft.TightChunk) as seen:
        res, backend, dt = run_model(
            recording("pdhg", t_opts), tight_model(nx, ny, L, f),
            nx * ny * (L + 2 * k), 300, num_cback_calls=2)
    launches = single_launches(ft)
    counted = ft.launch_counts["tight_chunk_tiled"]
    if "TightChunk" in seen:
        n, T = nx * ny, len(seen["TightChunk"][0].taps)
        banded_row(22, f"tight_chunk {nx}x{ny}x{L} (tiled path)", seen,
                   "TightChunk",
                   ((10 * L + 12 * k + 3) * n + 4 * T + 2 * L + 2 * k + 2)
                   * 4, tight_chunk_ops(n, L, k, T, ri))
    check(backend.made.tight is not None
          and all(v > 0 for v in launches.values()),
          f"the tight kernel was not launched at {nx}x{ny}x{L}: {launches}")
    route = backend.made.tight["call"].route
    check(route[0] == "tiled" and counted == launches["tight_chunk"] > 0,
          f"the {nx}x{ny}x{L} tight chunks did not run tiled: {route}, "
          f"{counted} tiled of {launches}")
    tiled["tight_chunk_tiled"] = counted
    e_tiled = tight_measures(res.x, f, TIGHT_LMB, L, nx, ny)
    print(f"fused tight solve {nx}x{ny}x{L} (tiled path, tile {route[1]}; "
          f"tiled launches {counted}): {rates(res, backend, dt)}; energy "
          f"{e_tiled[0]:.6f}, launches {launches} [{card}]")
    its = []
    for p in ("tiled", "streaming", "streaming", "tiled"):
        res, backend, dt = run_model(
            recording("pdhg", t_opts, tight_path=p),
            tight_model(nx, ny, L, f), nx * ny * (L + 2 * k), 300,
            num_cback_calls=2)
        check(backend.made.tight["call"].route[0] == p,
              f"the {nx}x{ny}x{L} tight solve did not take the {p} path")
        check(tight_measures(res.x, f, TIGHT_LMB, L, nx, ny) == e_tiled,
              f"the {p} {nx}x{ny}x{L} tight solve's energy is not the "
              "tiled one's")
        its.append(res.iterations / backend.loop_s)
    print(f"fused tight solve {nx}x{ny}x{L} in turns, iterating it/s: tiled "
          f"{its[0]:.1f}, streaming {its[1]:.1f}, streaming {its[2]:.1f}, "
          f"tiled {its[3]:.1f}; the four energies (and the constraint "
          f"measures) equal [{card}]")

    tiled.update(vol_large(card))
    print("banded rows at their banded shapes (rows 7, 19, 16, 14, 22, 28 "
          "and 27, all tiled): " + json.dumps(BANDED))
    return tiled


# ---------------------------------------------------------------------------
# the wire format, checkpoints, examples, util and entry points
# ---------------------------------------------------------------------------

# The resumed runs against their straight runs, every field and the
# energies (absolute): a split run calls the route's canonicalization and
# epilogue once more, which leave what the chunks read as it was where the
# split falls on a multichunk's start.
RESUME_ATOL = 1e-6
# Where the checkpointed runs are cut, and how far they run.  A PDHG
# route's chunks start at iterations 1 + 10 k (iteration 0 is a generic
# step), so 801 = 1 + 10 (8 ri) starts a multichunk; the ADMM route's
# chunks start at 10 k, so 800 does.
CKPT_SPLIT_PDHG, CKPT_SPLIT_ADMM, CKPT_ITERS = 801, 800, 2000
# config 1's wire round trip against phase_solve's energy (relative)
WIRE_RTOL = 1e-6


def wire_problems(n=ROF_SIZE, n_ml=ML_SIZE, n_db=DB_SIZE, n_t=TIGHT_SIZE,
                  n_v=VOL_SIZE):
    """The finalized problems of the configurations this script solves,
    with the backend class and the route each takes: {name: (problem,
    backend class, route)}."""
    from prost_tpu_torch.ops import FusedROFADMM, FusedROFPDHG

    f = test_image(n, n).reshape(-1)
    rof = rof_model(n, n, f, ROF_LMB).finalize()
    L, Lt = ML_LABELS, TIGHT_LABELS
    ml_f = ml_unaries(cow_gray(n_ml, n_ml), L)
    return {
        "config 1": (rof, FusedROFPDHG, "rof"),
        "config 4": (rof, FusedROFADMM, "rof"),
        "config 3": (ml_model(n_ml, n_ml, L, ml_f, ML_LMB).finalize(),
                     FusedROFPDHG, "ml"),
        "config 2": (deblur_model(n_db, n_db,
                                  deblur_data(n_db, n_db)).finalize(),
                     FusedROFPDHG, "deblur"),
        "tight128x4": (tight_model(n_t, n_t, Lt,
                                   tight_unaries(n_t, n_t, Lt)).finalize(),
                       FusedROFPDHG, "tight"),
        "vol256x8": (vol_model(n_v, n_v, VOL_LABELS,
                               vol_data(VOL_LABELS, n_v, n_v)).finalize(),
                     FusedROFPDHG, "vol"),
        "dual ROF on block.sparse": (
            rof_dual_model(n, n, f, ROF_LMB).finalize(), FusedROFPDHG,
            "generic"),
    }


def backend_route(cls, problem, opts):
    """``route_name`` of the backend that ``cls`` makes of ``problem``."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.examples._common import route_name

    return route_name(cls(problem, opts, ptt.SolverOptions(verbose=False)))


def phase_wire(card, e_pdhg, n=ROF_SIZE, sizes=None):
    """Each configuration's problem through ``to_spec``, ``json.dumps``,
    ``json.loads`` and ``from_spec``: the rebuilt problem lies on the
    device with the same preconditioners bit for bit and takes the route
    the original takes; seconds and JSON bytes of each.  Then config 1's
    rebuilt problem and the original, each solved by the fused ROF route
    as phase_solve solves it (2000 iterations): the rebuilt one within
    WIRE_RTOL of phase_solve's energy ``e_pdhg``, and whether it is
    bit-equal to the original's."""
    import torch

    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.modeling import wire

    opts = {"FusedROFPDHG": PDHGOptions(stepsize="boyd", residual_iter=10),
            "FusedROFADMM": ADMMOptions(residual_iter=10)}
    problems = wire_problems(n, **(sizes or {}))
    rebuilt = {}
    for name, (prob, cls, route) in problems.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec = wire.to_spec(prob)
        t1 = time.perf_counter()
        text = json.dumps(spec)
        t2 = time.perf_counter()
        back = wire.from_spec(json.loads(text))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        check(back.scaling_left.device == prob.scaling_left.device,
              f"{name}: the rebuilt problem is not on the device")
        check(torch.equal(back.scaling_left, prob.scaling_left)
              and torch.equal(back.scaling_right, prob.scaling_right),
              f"{name}: the rebuilt preconditioners differ")
        o = opts[cls.__name__]
        want = f"{cls.__name__}:{route}"
        got = (backend_route(cls, prob, o), backend_route(cls, back, o))
        print(f"wire {name} ({prob.ncols} x {prob.nrows}): to_spec "
              f"{t1 - t0:.3f} s, json.dumps {t2 - t1:.3f} s, {len(text)} "
              f"JSON bytes, json.loads + from_spec {t3 - t2:.3f} s; route "
              f"{got[0]} -> {got[1]} [{card}]")
        check(got == (want, want), f"{name}: the original takes {got[0]}, "
              f"the rebuilt problem {got[1]}, expected {want}")
        rebuilt[name] = back
        del spec, text

    f = test_image(n, n).reshape(-1)
    runs = {}
    for label, p in (("original", problems["config 1"][0]),
                     ("rebuilt", rebuilt["config 1"])):
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10))
        runs[label] = run_model(backend, p, n * n, 2000)
        check(backend.made.rof is not None,
              f"the {label} config 1 did not take the fused ROF route")
    res, backend, dt = runs["rebuilt"]
    orig = runs["original"][0]
    e = rof_energy(res.x, f, ROF_LMB, n, n)
    same = (np.array_equal(res.x, orig.x) and np.array_equal(res.y, orig.y)
            and res.iterations == orig.iterations)
    rel = abs(e - e_pdhg) / abs(e_pdhg)
    print(f"wire config 1 rebuilt, fused ROF route: "
          f"{rates(res, backend, dt)}; energy {e:.8f}, phase_solve's "
          f"{e_pdhg:.8f}, rel diff {rel:.3e} (tol {WIRE_RTOL:g}); x, y and "
          f"iterations {'bit-equal to' if same else 'DIFFER from'} the "
          f"original problem's solve [{card}]")
    check(rel <= WIRE_RTOL, "the rebuilt config 1 energy disagrees")


def phase_checkpoint(card, n=ROF_SIZE, n_ml=ML_SIZE, ens_b=SMALL_ENS_B,
                     iters=CKPT_ITERS, splits=(CKPT_SPLIT_PDHG,
                                               CKPT_SPLIT_ADMM)):
    """Three runs cut by ``save_state`` / ``load_state`` beside their
    straight runs: config 1 on the fused ROF route and config 4 on the
    fused Chebyshev ADMM route (phase_solve's options, tolerance 1e-5) and
    ensemble ml8x256x8 (8 instances of config 3, each with its own noise;
    ``BatchedPDHG``, bench.py's options).  The largest difference of
    every field and of the energies, held to RESUME_ATOL; the ms of
    ``save_state`` and ``load_state`` and the file's bytes."""
    import os
    import tempfile

    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.ops import FusedROFADMM, FusedROFPDHG
    from prost_tpu_torch.parallel import BatchedPDHG
    from prost_tpu_torch.util import load_state, save_state

    tol = 1e-5
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=tol,
                              tol_rel_dual=tol, tol_abs_primal=tol,
                              tol_abs_dual=tol)
    f = test_image(n, n).reshape(-1)
    rof = rof_model(n, n, f, ROF_LMB).finalize()
    L = ML_LABELS
    rng = np.random.RandomState(42)
    gray = cow_gray(n_ml, n_ml)
    mls = [ml_unaries(gray + 0.05 * rng.randn(*gray.shape), L)
           for _ in range(ens_b)]
    e_opts, e_sopts = ens_opts()
    split_pdhg, split_admm = splits

    def rof_energies(b, s):
        return [rof_energy(b.current_solution(s)[0].cpu().numpy(), f,
                           ROF_LMB, n, n)]

    def ml_energies(b, s):
        x = s.x.cpu().numpy()
        return [ml_energy(x[i], mls[i], ML_LMB, L, n_ml, n_ml)
                for i in range(ens_b)]

    cases = (
        ("config 1, FusedROFPDHG", lambda: FusedROFPDHG(
            rof, PDHGOptions(stepsize="boyd", residual_iter=10), sopts),
         lambda b: b.rof is not None, split_pdhg, rof_energies),
        ("config 4, FusedROFADMM", lambda: FusedROFADMM(
            rof, ADMMOptions(residual_iter=10), sopts),
         lambda b: b.mode == "cheby", split_admm, rof_energies),
        (f"ml{ens_b}x{n_ml}x{L}, BatchedPDHG", lambda: BatchedPDHG(
            [ml_model(n_ml, n_ml, L, u, ML_LMB).finalize() for u in mls],
            e_opts, e_sopts), lambda b: b.ml is not None, split_pdhg,
         ml_energies),
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        for name, make, matched, split, energies in cases:
            b = make()
            check(matched(b), f"{name}: the fused route was not taken")
            straight = b.run(b.initial_state(), iters, 0)
            state = b.run(b.initial_state(), split, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_state(path, state)
            t1 = time.perf_counter()
            loaded = load_state(path, b.initial_state())
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            it = loaded.iteration.reshape(-1)[0]
            resumed = b.run(loaded, iters, int(it))
            diffs = {k: float(torch.max(torch.abs(
                getattr(resumed, k).double() - getattr(straight, k).double())))
                for k in vars(straight)}
            bit = all(torch.equal(getattr(resumed, k), getattr(straight, k))
                      for k in vars(straight))
            e_res, e_str = energies(b, resumed), energies(b, straight)
            de = max(abs(a - c) for a, c in zip(e_res, e_str))
            worst = max(diffs.values())
            print(f"checkpoint {name}: {split} + {iters - split} iterations "
                  f"against {iters} straight: fields max abs diff "
                  f"{worst:.3e}, energies {e_str[0]:.8f} ... max abs diff "
                  f"{de:.3e} (tol {RESUME_ATOL:g}), "
                  f"{'bit-equal' if bit else 'NOT bit-equal'}; save_state "
                  f"{(t1 - t0) * 1e3:.2f} ms, load_state "
                  f"{(t2 - t1) * 1e3:.2f} ms, {os.path.getsize(path)} bytes "
                  f"[{card}]")
            print(f"  per field: " + ", ".join(
                f"{k} {v:.2e}" for k, v in diffs.items()))
            check(worst <= RESUME_ATOL and de <= RESUME_ATOL,
                  f"{name}: the resumed run differs from the straight run")
            del b, straight, state, loaded, resumed
            torch.cuda.empty_cache()


def _grad_matrix(n):
    from prost_tpu_torch.examples.example_rof_dual import spmat_gradient2d

    return spmat_gradient2d(n, n, 1)


def _tv(G, u, n):
    g = G @ u
    return float(np.sum(np.sqrt(g[:n] ** 2 + g[n:] ** 2)))


def _inv_rof_primaldual(out, kw, seen):
    return out["gap_per_px"] < kw.get("gap_tol", 1e-5), \
        f"gap/px {out['gap_per_px']:.3e}"


def _inv_rof_primal(out, kw, seen):
    f, lmb, u = out["f"], out["lmb"], out["u"]
    G = _grad_matrix(kw["size"])

    def en(v):
        return lmb / 2 * np.sum((v - f) ** 2) + _tv(G, v, f.size)

    return en(u) < en(f), f"energy {en(u):.6f} < {en(f):.6f} at u = f"


def _inv_rof_dual(out, kw, seen):
    """The dual solve's u against the primal solve of the same ROF."""
    import prost_tpu_torch as ptt

    f, lmb, size = out["f"], out["lmb"], kw["size"]
    n = size * size
    u = ptt.Variable(n)
    q = ptt.Variable(2 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, ptt.function.sum_norm2(2, False, "ind_leq0", 1, 1,
                                                1))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(size, size, 1))
    tol = 1e-7
    ptt.solve(prob, ptt.backend_pdhg(), ptt.options(
        max_iters=kw.get("max_iters", 20000), verbose=False,
        tol_rel_primal=tol, tol_rel_dual=tol, tol_abs_primal=tol,
        tol_abs_dual=tol))
    d = float(np.max(np.abs(out["u"] - u.val)))
    return d <= 2e-2, f"|u - primal solve's u| {d:.3e} (tol 2e-2)"


def _inv_energy_below_input(energy_of):
    """The solution's energy below the energy at u = f (the observation),
    with the solution finite and moved off f."""
    def inv(out, kw, seen):
        u, f = out["u"], out["f"]
        e_f = energy_of(out, f, kw)
        ok = (np.all(np.isfinite(u)) and not np.allclose(u, f)
              and out["energy"] < e_f)
        return ok, f"energy {out['energy']:.6f} < {e_f:.6f} at u = f"
    return inv


def _tvl1_energy(out, v, kw):
    n = kw["size"] ** 2
    return out["lmb"] * np.sum(np.abs(v - out["f"])) + _tv(
        _grad_matrix(kw["size"]), v, n)


def _inpaint_energy(out, v, kw):
    n = kw["size"] ** 2
    return out["lmb"] / 2 * np.sum((out["mask"] * (v - out["f"])) ** 2) + \
        _tv(_grad_matrix(kw["size"]), v, n)


def _deblur_energy(out, v, kw):
    from prost_tpu_torch.examples.example_deblurring import convmtx2

    size = kw["size"]
    B = convmtx2(out["kernel"], size, size)[0]
    return out["lmb"] / 2 * np.sum((B @ v - out["f_blurred"]) ** 2) + _tv(
        _grad_matrix(size), v, size * size)


def _inv_labels(out, kw, seen):
    sums = out["labels"].sum(axis=0)
    err, lo = float(np.max(np.abs(sums - 1.0))), float(out["labels"].min())
    return err <= 5e-2 and lo > -1e-2, \
        f"label sums within {err:.3e} of 1 (tol 5e-2), min {lo:.3e}"


def _inv_callback(out, kw, seen):
    L = kw.get("L", 8)
    sums = out["u"].reshape(L, -1).sum(axis=0)
    err = float(np.max(np.abs(sums - 1.0)))
    return err <= 5e-2 and len(out["panels"]) > 0, \
        f"{len(out['panels'])} panels, label sums within {err:.3e} of 1"


def _inv_tight(out, kw, seen):
    err = float(np.max(np.abs(out["labels"].sum(axis=0) - 1.0)))
    return err <= 5e-2, f"partition of unity within {err:.3e} (tol 5e-2)"


def _inv_vol(out, kw, seen):
    return out["noise_out"] < 0.75 * out["noise_in"], \
        f"mean abs error {out['noise_in']:.4f} -> {out['noise_out']:.4f}"


def _inv_admm(out, kw, seen):
    pd = seen["example_rof_primaldual"]["energy"]
    rel = abs(out["energy"] - pd) / pd
    return rel < 2e-3, f"energy rel diff to example_rof_primaldual's " \
        f"{rel:.3e} (tol 2e-3)"


def _inv_nonconvex(out, kw, seen):
    bound = 0.05 * out["f"].size
    return out["energy"] < bound, f"energy {out['energy']:.4f} < {bound:g}"


def _inv_ensemble(out, kw, seen):
    shape = (kw["batch"], kw["size"] ** 2)
    ok = (out["throughput"] > 0 and out["x"].shape == shape
          and np.isfinite(out["x"]).all())
    return ok, f"x {out['x'].shape}, {out['throughput']:.1f} " \
        "instance-it/s"


def _inv_sharded(out, kw, seen):
    return out["diff"] < 1e-5, f"max |auto - halo| {out['diff']:.3e} " \
        "(tol 1e-5)"


def _inv_custom(out, kw, seen):
    return (out["result"].value == "converged" and out["wire_diff"] == 0.0,
            f"result {out['result'].value}, wire round trip K diff "
            f"{out['wire_diff']:.1e}")


# Each example at the JAX example's run() defaults: (module, run's
# keyword arguments, the route it takes, the kernels of PERF.md's table it
# launches (launch-count names, or None for a generic route), its
# invariant).  The invariants are tests/test_examples.py's where they need
# no oracle; where that test holds an energy to an f64 oracle (ROF-TV-L1,
# inpainting, deblurring: run at 16x16 on the CPU in
# tests/test_torch_examples*.py), the energy is held below the energy at
# the observation.
PDHG_ROF = ("FusedROFPDHG:rof", ("rof_chunk", "rof_multichunk"))
EXAMPLES = (
    ("example_rof_primaldual", {"size": 128}, *PDHG_ROF,
     _inv_rof_primaldual),
    ("example_tvl1", {"size": 128}, *PDHG_ROF,
     _inv_energy_below_input(_tvl1_energy)),
    ("example_tv_inpaint", {"size": 128}, *PDHG_ROF,
     _inv_energy_below_input(_inpaint_energy)),
    ("example_multilabel_fast", {"size": 64, "L": 8}, "FusedROFPDHG:ml",
     ("ml_chunk", "ml_multichunk"), _inv_labels),
    ("example_multilabel_callback", {"size": 64, "L": 8}, "FusedROFPDHG:ml",
     ("ml_chunk", "ml_multichunk"), _inv_callback),
    ("example_deblurring", {"size": 128}, "FusedROFPDHG:deblur",
     ("deblur_chunk",), _inv_energy_below_input(_deblur_energy)),
    ("example_multilabel_tight", {"size": 48, "L": 3}, "FusedROFPDHG:tight",
     ("tight_chunk",), _inv_tight),
    ("example_vol_tv", {"size": 64, "L": 8}, "FusedROFPDHG:vol",
     ("vol_chunk", "vol_multichunk"), _inv_vol),
    ("example_rof_admm", {"size": 128}, "FusedROFADMM:generic", None,
     _inv_admm),
    ("example_ensemble", {"size": 64, "batch": 16, "iters": 500},
     "BatchedPDHG:rof", ("rof_chunk_batched",), _inv_ensemble),
    ("example_sharded", {"size": 256}, ["ShardedPDHG:generic",
                                        "ShardedFusedROF:halo"],
     ("rof_chunk_halo",), _inv_sharded),
    ("example_rof_primal", {"size": 128}, "FusedROFPDHG:generic", None,
     _inv_rof_primal),
    ("example_rof_dual", {"size": 128}, "FusedROFPDHG:generic", None,
     _inv_rof_dual),
    ("example_nonconvex_rof", {"size": 128}, "FusedROFPDHG:generic", None,
     _inv_nonconvex),
    ("example_custom_prox", {}, "FusedROFPDHG:generic", None, _inv_custom),
)


def _all_launch_counts():
    from prost_tpu_torch.ops import (fused_admm, fused_deblur,
                                     fused_multilabel, fused_rof,
                                     fused_tight, fused_vol)

    return (fused_admm, fused_deblur, fused_multilabel, fused_rof,
            fused_tight, fused_vol)


def _run_example(module, kw):
    """``run(**kw)`` of one example module on this process's device, or
    for example_sharded on one rank a card (an NCCL group it starts in
    this process with one card, spawned ranks with more)."""
    import importlib

    import torch

    mod = importlib.import_module(f"prost_tpu_torch.examples.{module}")
    world = torch.cuda.device_count()
    if module == "example_sharded" and world > 1:
        from prost_tpu_torch.parallel.launch import run_ranks

        return run_ranks(world, mod.run, {**kw, "n_shards": world})[0]
    return mod.run(**kw)


def phase_examples(card, examples=EXAMPLES):
    """Every example's ``run()`` on the card at its JAX default size, none
    of them capped (the phase takes about 50 s): the route it takes, the
    hand-written kernels it launches, its invariant, iterations, it/s and
    wall seconds."""
    import torch

    seen = {}
    for module, kw, route, kernels, invariant in examples:
        kw = dict(kw, verbose=False)
        mods = _all_launch_counts()
        for m in mods:
            m.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _run_example(module, kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for m in mods for k, v in m.launch_counts.items() if v}
        seen[module] = out
        ok, what = invariant(out, kw, seen)
        its = out.get("iterations", kw.get("iters"))
        if isinstance(its, list):  # example_sharded: each path's own time
            rate = ", " + ", ".join(f"{i / t:.1f}" for i, t in
                                    zip(its, out["seconds"])) + " it/s"
        else:
            rate = f", {its / dt:.1f} it/s over the wall"
        print(f"example {module} {kw}: route {out['route']}, iterations "
              f"{its}{rate}, wall {dt:.2f} s; launches {counts or 'none'}; "
              f"{what} [{card}]")
        check(out["route"] == route,
              f"{module} took route {out['route']}, expected {route}")
        check(ok, f"{module}: its invariant does not hold ({what})")
        if kernels is None:
            check(not counts, f"{module}: a generic route launched {counts}")
        elif module != "example_sharded" or len(counts):
            check(any(counts.get(k, 0) > 0 for k in kernels),
                  f"{module}: none of {kernels} was launched")


def phase_util_entry(card, n=ROF_SIZE):
    """``entry()``'s step against one ``generic_step``; ``timed``,
    ``memory_stats`` and ``compiled_memory_analysis`` on it;
    ``dryrun_multichip`` on one NCCL rank a card; and ``trace`` around one
    multichunk of config 1's fused ROF route, naming its grid-resident
    kernel."""
    import os
    import tempfile

    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.entry import _build_rof, dryrun_multichip, entry
    from prost_tpu_torch.ops import FusedROFPDHG
    from prost_tpu_torch.util import (compiled_memory_analysis,
                                      memory_stats, trace)
    from prost_tpu_torch.util import timed as util_timed

    fn, (state,) = entry()
    backend = _build_rof(128, 128)
    out, ref = fn(state), backend.generic_step(backend.initial_state(), 0)
    same = all(torch.equal(getattr(out, k), getattr(ref, k))
               for k in vars(out))
    _, ms = util_timed(fn, state, warmup=3, repeats=50)
    mem = compiled_memory_analysis(fn, state)
    stats = memory_stats()
    print(f"entry(): one step on {state.x.device} "
          f"{'equal to' if same else 'DIFFERS from'} one generic_step; "
          f"timed {ms:.4f} ms a step (CUDA events, 50 steps); "
          f"compiled_memory_analysis {mem}; memory_stats bytes_in_use "
          f"{stats.get('bytes_in_use')}, peak {stats.get('peak_bytes_in_use')}"
          f", limit {stats.get('bytes_limit')} [{card}]")
    check(same, "entry()'s step differs from generic_step")
    check(ms > 0 and stats.get("bytes_in_use", 0) > 0
          and stats.get("bytes_limit", 0) > 0, "timed or memory_stats "
          "gave no reading")
    check(mem.get("argument_size_in_bytes", 0) > 0
          and mem["output_size_in_bytes"] > 0
          and mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"],
          f"compiled_memory_analysis is not sane: {mem}")

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    steps = dryrun_multichip(world)
    print(f"dryrun_multichip({world}): {time.perf_counter() - t0:.1f} s, "
          f"rank 0 reached {steps[0]} [{card}]")
    check(len(steps) == world and all(s == steps[0] for s in steps),
          "dryrun_multichip's ranks disagree")

    f = test_image(n, n).reshape(-1)
    b = FusedROFPDHG(rof_model(n, n, f, ROF_LMB).finalize(),
                     PDHGOptions(stepsize="boyd", residual_iter=10),
                     ptt.SolverOptions(verbose=False))
    s = b.run(b.initial_state(), 1, 0)
    torch.cuda.synchronize()
    for attempt in range(1, 6):  # the card's tracer has been seen to lose
        # a call's events (``traced_call`` retries the same way); the run
        # works on its own copies, so each attempt starts from ``s``
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                b.run(s, 81, 1)  # one multichunk
                torch.cuda.synchronize()
            with open(os.path.join(tmp, "trace.json")) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        mine = sorted({k for k in kernels if "rof_multichunk_resident" in k})
        if mine:
            break
    print(f"trace of one config 1 multichunk (attempt {attempt}): "
          f"{len(events)} events, {len(kernels)} kernels, of them {mine} "
          f"[{card}]")
    check(mine, "five traces did not name rof_multichunk_resident")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import prost_tpu_torch as ptt

    check("jax" not in sys.modules, "jax was imported")
    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()

    def phase(fn, *args):
        """``fn(*args)``, its wall time printed."""
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    phase(phase_build)
    rows = phase(phase_kernels, dev)
    for fn in (phase_admm_kernels, phase_ml_kernels, phase_deblur_kernels,
               phase_tight_kernels, phase_vol_kernels, phase_batched_kernels,
               phase_halo_kernels, phase_halo_8b_kernels, phase_tiled_rof):
        rows.update(phase(fn, dev))
    resident = phase(phase_resident_kernels, dev)
    resident.update(phase(phase_resident_multi, dev))
    resident.update(phase(phase_resident_batched, dev))
    resident.update(phase(phase_resident_chunk_multi, dev))
    resident.update(phase(phase_resident_rof, dev))
    resident.update(phase(phase_resident_ml_halo, dev))
    rows.update(phase(phase_tiled_admm, dev))
    rows.update(phase(phase_tiled_deblur, dev))
    rows.update(phase(phase_tiled_ml, dev))
    rows.update(phase(phase_tiled_tight, dev))
    rows.update(phase(phase_tiled_vol, dev))
    launches, e_pdhg, d_pdhg = phase(phase_solve, card)
    admm_launches, e_admm = phase(phase_admm_solve, card, e_pdhg, d_pdhg)
    launches.update(admm_launches)
    ml_launches, e_ml = phase(phase_ml_solve, card)
    launches.update(ml_launches)
    phase(phase_dual_rof_solve, card, e_pdhg, d_pdhg)
    phase(phase_simplex_ml_solve, card, e_ml)
    phase(phase_zoo, card)
    deblur_launches, e_deblur = phase(phase_deblur_solve, card)
    launches.update(deblur_launches)
    tight_launches, e_tight = phase(phase_tight_solve, card)
    launches.update(tight_launches)
    vol_launches, e_vol = phase(phase_vol_solve, card)
    launches.update(vol_launches)
    phase(phase_route_turns, card)
    launches.update(phase(
        phase_sharded_solve, card,
        {"rof": e_pdhg, "ml": e_ml, "vol": e_vol, "deblur": e_deblur,
         "tight": e_tight, "admm": e_admm}))
    ens_launches, _, _ = phase(phase_ensemble, card)
    launches.update(ens_launches)
    large_launches, _, _ = phase(phase_large_ensemble, card)
    launches.update(large_launches)
    launches.update(phase(phase_small_ensembles, card))
    launches.update(phase(phase_conv_ensembles, card))
    launches.update(phase(phase_large, card))
    phase(phase_wire, card, e_pdhg)
    phase(phase_checkpoint, card)
    phase(phase_examples, card)
    phase(phase_util_entry, card)
    check("jax" not in sys.modules, "jax was imported")
    print(f"all phases: {time.perf_counter() - t0:.1f} s")

    kernels = {
        "rof_chunk": ("fused_rof", "prost_tpu/ops/fused_rof.py:459"),
        "rof_multichunk": ("fused_rof", "prost_tpu/ops/fused_rof.py:338"),
        "admm_chunk": ("fused_admm", "prost_tpu/ops/fused_admm.py:257"),
        "admm_multichunk": ("fused_admm", "prost_tpu/ops/fused_admm.py:390"),
        "ml_chunk": ("fused_multilabel",
                     "prost_tpu/ops/fused_multilabel.py:236"),
        "ml_multichunk": ("fused_multilabel",
                          "prost_tpu/ops/fused_multilabel.py:322"),
        "deblur_chunk": ("fused_deblur", "prost_tpu/ops/fused_deblur.py:294"),
        "tight_chunk": ("fused_tight", "prost_tpu/ops/fused_tight.py:172"),
        "vol_chunk": ("fused_vol", "prost_tpu/ops/fused_vol.py:213"),
        "vol_multichunk": ("fused_vol", "prost_tpu/ops/fused_vol.py:362"),
        "rof_chunk_batched": ("fused_rof", "prost_tpu/ops/fused_rof.py:485"),
        "rof_chunk_batched_tiled": ("fused_rof",
                                    "prost_tpu/ops/fused_rof.py:722"),
        "ml_chunk_batched": ("fused_multilabel",
                             "prost_tpu/ops/fused_multilabel.py:675"),
        "vol_chunk_batched": ("fused_vol", "prost_tpu/ops/fused_vol.py:300"),
        "deblur_chunk_batched": ("fused_deblur",
                                 "prost_tpu/ops/fused_deblur.py:327"),
        "tight_chunk_batched": ("fused_tight",
                                "prost_tpu/ops/fused_tight.py:253"),
        "rof_chunk_halo": ("fused_rof", "prost_tpu/ops/fused_rof.py:512"),
        "ml_chunk_halo": ("fused_multilabel",
                          "prost_tpu/ops/fused_multilabel.py:236"),
        "vol_chunk_halo": ("fused_vol", "prost_tpu/ops/fused_vol.py:213"),
        "deblur_chunk_halo": ("fused_deblur",
                              "prost_tpu/ops/fused_deblur.py:294"),
        "tight_chunk_halo": ("fused_tight",
                             "prost_tpu/ops/fused_tight.py:172"),
        "admm_iter_halo": ("fused_admm", "prost_tpu/ops/fused_admm.py:518"),
        "rof_chunk_tiled": ("fused_rof", "prost_tpu/ops/fused_rof.py:722"),
        "rof_multichunk_tiled": ("fused_rof",
                                 "prost_tpu/ops/fused_rof.py:988"),
        "admm_chunk_tiled": ("fused_admm", "prost_tpu/ops/fused_admm.py:812"),
        "admm_multichunk_tiled": ("fused_admm",
                                  "prost_tpu/ops/fused_admm.py:812"),
        "deblur_chunk_tiled": ("fused_deblur",
                               "prost_tpu/ops/fused_deblur.py:521"),
        "deblur_chunk_halo_tiled": ("fused_deblur",
                                    "prost_tpu/ops/fused_deblur.py:521"),
        "ml_chunk_tiled": ("fused_multilabel",
                           "prost_tpu/ops/fused_multilabel.py:743"),
        "ml_multichunk_tiled": ("fused_multilabel",
                                "prost_tpu/ops/fused_multilabel.py:441"),
        "ml_chunk_halo_tiled": ("fused_multilabel",
                                "prost_tpu/ops/fused_multilabel.py:743"),
        "tight_chunk_tiled": ("fused_tight",
                              "prost_tpu/ops/fused_tight.py:318"),
        "tight_chunk_halo_tiled": ("fused_tight",
                                   "prost_tpu/ops/fused_tight.py:318"),
        "vol_chunk_tiled": ("fused_vol", "prost_tpu/ops/fused_vol.py:461"),
        "vol_multichunk_tiled": ("fused_vol",
                                 "prost_tpu/ops/fused_vol.py:525"),
        "vol_chunk_halo_tiled": ("fused_vol",
                                 "prost_tpu/ops/fused_vol.py:461"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"prost_tpu_torch/csrc/{src}.cu", "replaces": replaces,
         "launches": launches[name], "max_abs_err": rows[name]["err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0],
         "bound_by": rows[name]["bound"][1], "library_ms": None,
         "device_ms": rows[name]["traced"]["csrc_ms"],
         "torch_device_ms": rows[name]["traced"]["torch_ms"],
         "launches_per_call": (None if rows[name]["traced"].get("lost")
                               else len(rows[name]["traced"]["csrc"])),
         **({"resident": resident[name]} if name in resident else {})}
        for name, (src, replaces) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
