"""The redesigned kernels on the card: ``rof_chunk_batched``'s cluster
launch (each instance held on chip by a thread-block cluster),
``admm_iter_halo_``'s cooperative launch (one launch per iteration, at any
Chebyshev degree), the grid-resident chunks of ``deblur_chunk_`` and
``ml_chunk_`` and their halo forms (one cooperative launch a chunk, each
block holding a band of rows in shared memory), the grid-resident batched
multilabel chunk ``ml_chunk_batched_`` (the instances one after another in
one launch; ``-k ml_batched``), the grid-resident ADMM multichunk
``admm_multichunk_`` (every chunk of the launch with the planes in shared
memory; ``-k admm_multichunk``) and the grid-resident batched volumetric
and deblur chunks ``vol_chunk_batched_`` and ``deblur_chunk_batched_``
(``-k "vol_batched or deblur_batched"``) and the grid-resident tight and
volumetric chunks ``tight_chunk_``, ``vol_chunk_`` and their halo forms
(``-k "tight_resident or vol_resident"``), and the grid-resident Chebyshev
ADMM chunk ``admm_chunk_`` and volumetric multichunk ``vol_multichunk_``
(``-k "admm_chunk or vol_multichunk"``), and the grid-resident ROF chunk
``rof_chunk_`` and multichunk ``rof_multichunk_`` (``-k "rof_resident or
rof_multichunk or rof_light"``), and the grid-resident multilabel
multichunk ``ml_multichunk_`` and ROF halo chunk ``rof_chunk_halo_`` (``-k
"ml_multichunk or rof_halo or rof_chunk_band"``), and the tiled ROF and
Chebyshev ADMM chunks and multichunks and the tiled deblur chunk (``-k
tiled``; ``-k admm_tiled`` for the ADMM ones, ``-k deblur_tiled`` for the
deblur ones), and the tiled multilabel chunk, its halo form and the
multichunk (``-k ml_tiled``), the tiled tight chunk and its halo form
(``-k tight_tiled``), and the tiled volumetric chunk, its halo form and
the multichunk (``-k vol_tiled``), bit for bit against the streaming
launch sequences they replace.

Every test here is marked ``cuda`` and skips without a CUDA card.  Both
redesigns run the per-pixel arithmetic and the norm trees of the launch
sequences they replace, so the checks are bit-equality: each instance of
the cluster path against the single-instance ``rof_chunk``, and the owned
rows of ``admm_iter_halo_`` against ``admm_chunk`` with count 1.  The file
imports torch and the port only; without JAX run it as

    python -m pytest --noconftest tests/test_torch_cuda_redesign.py -q
"""

import numpy as np
import pytest
import torch

import prost_tpu_torch as ptt
from prost_tpu_torch.ops import fused_admm as fa
from prost_tpu_torch.ops import fused_rof as fr
from prost_tpu_torch.ops.pdhg_chunk import (S_CONV, S_LEN, launch,
                                            scalar_buffer)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rof_batch(seed, B, nx, ny, dev, conv=None):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(B, nx, ny), 0.3 * rng.randn(B, 2, nx, ny),
            rng.rand(B, nx, ny), 2.0 * (rng.rand(B, nx, ny) > 0.3))
    planes = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            np.full(B, 16.0), np.ones(B)]
    if conv is not None:
        rows.append(np.asarray(conv, dtype=np.float64))
    scal = torch.tensor(np.array(rows), dtype=torch.float32, device=dev)
    return planes, scal


def _each_instance_is_rof_chunk(planes, scal, count, dataterm):
    """The batched chunk against ``rof_chunk`` on each instance alone, bit
    for bit in the four planes and the norms; the inputs untouched."""
    before = [t.clone() for t in planes]
    out = fr.rof_chunk_batched(*planes, scal, count, dataterm)
    for b in range(planes[0].shape[0]):
        one = fr.rof_chunk(*[p[b] for p in planes], scal[:, b], count,
                           dataterm)
        for a, s in zip(out[:4], one[:4]):
            assert torch.equal(a[b], s)
        assert torch.equal(out[4][:, b], one[4])
    for a, b in zip(planes, before):
        assert torch.equal(a, b)
    return out


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("ri", [1, 10])
def test_cluster_path_is_rof_chunk_per_instance(dev, dataterm, ri):
    planes, scal = _rof_batch(61, 3, 128, 128, dev)
    assert fr.cluster_size(128, 128, dataterm) == 2
    before = fr.launch_counts["rof_chunk_batched"]
    _each_instance_is_rof_chunk(planes, scal, ri, dataterm)
    assert fr.launch_counts["rof_chunk_batched"] == before + 1


def test_cluster_path_converged_instance_returns_its_inputs(dev):
    planes, scal = _rof_batch(62, 3, 128, 128, dev, conv=[0, 1, 0])
    x, q = planes[:2]
    out = fr.rof_chunk_batched(*planes, scal, 10)
    free = fr.rof_chunk_batched(*planes, scal[:5], 10)
    for b in range(3):
        held = b == 1
        for a, s, inp in zip(out[:4], free[:4], (x, q, x, q)):
            assert torch.equal(a[b], inp[b] if held else s[b])
        assert torch.equal(out[4][:, b], torch.zeros_like(out[4][:, b])
                           if held else free[4][:, b])


@pytest.mark.parametrize("B,nx,ny,dataterm,csize", [
    (2, 100, 45, "square", 1),     # ny not a multiple of 32
    (3, 130, 128, "abs", 2),       # bands of 72 and 58 rows
    (2, 250, 190, "wsquare", 8),   # the last band 26 rows
    (2, 600, 96, "square", 8),     # the last band 40 of 80 rows
])
def test_cluster_path_ragged_shapes(dev, B, nx, ny, dataterm, csize):
    assert fr.cluster_size(nx, ny, dataterm) == csize
    planes, scal = _rof_batch(63, B, nx, ny, dev)
    _each_instance_is_rof_chunk(planes, scal, 5, dataterm)


@pytest.mark.parametrize("nx,csize", [(576, 8), (577, None)])
def test_largest_cluster_shape_and_smallest_streaming_shape(dev, nx, csize):
    """At 128 columns, 576 rows is the tallest instance that a cluster of
    8 holds and 577 the shortest that none holds (it takes the batched
    tiled launch); both paths give each instance as ``rof_chunk`` does."""
    assert fr.cluster_size(nx, 128, "square") == csize
    planes, scal = _rof_batch(64, 2, nx, 128, dev)
    _each_instance_is_rof_chunk(planes, scal, 3, "square")


def test_streaming_in_place_matches_the_wrapper(dev):
    planes, scal = _rof_batch(65, 2, 577, 128, dev)
    want = fr.rof_chunk_batched(*planes, scal, 4)
    bufs = [t.clone() for t in (planes[0], planes[1], planes[0], planes[1])]
    norms2 = fr.rof_chunk_batched_streaming_(*bufs, *planes[2:], scal, 4)
    for a, b in zip(bufs + [norms2], want):
        assert torch.equal(a, b)


def test_refused_cluster_launch_raises(dev):
    """A cluster whose bands do not fit in shared memory is refused by the
    C entry point, and the launch raises."""
    planes, scal = _rof_batch(66, 1, 1280, 1280, dev)
    x, q, f, w = planes
    lib = fr._lib()
    outs = [torch.empty_like(t) for t in (x, q, x, q)]
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(4 * lib.prost_rof_num_blocks(1280, 1280))
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_rof_chunk_cluster", "rof_chunk_batched",
               fr.launch_counts, x.device, [x, q, f, w, *outs, sc, partial],
               1280, 1280, 3, 0, 1, 8)
    assert lib.prost_rof_cluster_occupancy(128, 128, 0, 2) > 0
    assert lib.prost_rof_cluster_occupancy(1280, 1280, 0, 8) < 0


def _admm_planes(seed, nx, ny, dev):
    rng = np.random.RandomState(seed)
    shapes = [(nx, ny)] * 3 + [(2, nx, ny)] * 3 + [(nx, ny)]
    state = [0.3 * rng.randn(*s) for s in shapes]
    arrs = state + [rng.rand(nx, ny), 2.0 * (rng.rand(nx, ny) > 0.3)]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("with_norms", [True, False])
@pytest.mark.parametrize("shards", [1, 2])
def test_admm_iter_halo_owned_rows_are_admm_chunk(dev, shards, with_norms):
    from prost_tpu_torch.parallel.spatial_fused import window

    nx, ny, degree = 200, 150, 10
    planes = _admm_planes(67, nx, ny, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    whole = fa.admm_chunk(*planes, scal, None, 1, 0, 1.7, "square", degree)
    H, rows = fa.admm_cheby_halo_rows(degree), nx // shards
    before = fa.launch_counts["admm_iter_halo"]
    total = torch.zeros(4, device=dev)
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        norms2 = fa.admm_iter_halo_(*ext[:7], *ext[7:], scal, degree, 1.7,
                                    nx, lo, H, H + rows, "square",
                                    with_norms)
        for a, b in zip(ext[:7], whole[:7]):
            assert torch.equal(a[..., H:H + rows, :],
                               window(b, rank * rows, (rank + 1) * rows))
        total = total + norms2
    assert fa.launch_counts["admm_iter_halo"] == before + shards
    if with_norms:
        torch.testing.assert_close(total, whole[7], rtol=1e-6, atol=0)
    else:
        assert not total.any()


def test_admm_iter_halo_with_flag_leaves_the_buffers(dev):
    planes = _admm_planes(68, 96, 80, dev)
    before = [t.clone() for t in planes]
    scal = torch.tensor([1.3, 8.0, 1.0, 1.0], device=dev)
    norms2 = fa.admm_iter_halo_(*planes, scal, 10, 1.7, 96, 0, 0, 96)
    torch.cuda.synchronize()
    assert not norms2.any()
    for a, b in zip(planes, before):
        assert torch.equal(a, b)


def test_admm_coop_launch_holds_every_block(dev):
    """The cooperative launch takes as many blocks as the card holds at
    once: at least one per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fa._lib().prost_admm_coop_blocks() >= sms


def test_admm_iter_halo_takes_degree_65(dev):
    """The coefficients come from a device array made per degree: degree 65
    runs, its owned rows bit-equal to ``admm_chunk`` at count 1."""
    planes = _admm_planes(69, 160, 48, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    whole = fa.admm_chunk(*planes, scal, None, 1, 0, 1.7, "square", 65)
    cur = [t.clone() for t in planes[:7]]
    norms2 = fa.admm_iter_halo_(*cur, *planes[7:], scal, 65, 1.7, 160, 0, 0,
                                160)
    for a, b in zip(cur, whole[:7]):
        assert torch.equal(a, b)
    torch.testing.assert_close(norms2, whole[7], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the grid-resident chunks of rows 17 and 12
# ---------------------------------------------------------------------------

def _blur(case):
    """(taps, kx, ky): config 2's 9x9 motion blur (7 taps, row reach 7) or
    an asymmetric 5x5 one."""
    from prost_tpu_torch.ops import fused_deblur as fd

    if case == "motion":
        k = np.zeros((9, 9))
        for i in range(1, 8):
            k[i, i] = 1.0
        k /= k.sum()
    else:
        k = np.eye(5)
        k[0, 4] = 0.5
        k /= k.sum()
    return fd.kernel_taps(torch.as_tensor(k.T, dtype=torch.float32)), 9 if \
        case == "motion" else 5


def _deblur_planes(seed, nx, ny, kx, dev):
    rng = np.random.RandomState(seed)
    nx2, ny2 = nx + kx - 1, ny + kx - 1
    arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2), 0.3 * rng.randn(2, nx, ny),
            rng.rand(nx2, ny2), 0.5 + rng.rand(nx2, ny2))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _both_paths(fn, state, data, *args):
    """``fn`` (an in-place chunk) on copies of ``state`` along each path;
    returns {path: (state, prev, norms2)}."""
    out = {}
    for path in ("streaming", "resident"):
        cur = [t.clone() for t in state]
        prev = [torch.full_like(t, float("nan")) for t in state]
        norms2 = fn(*cur, *prev, *data, *args, path=path).clone()
        out[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    return out


def _bit_equal(out):
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert torch.isfinite(out["resident"][-1]).all()


@pytest.mark.parametrize("nx,ny,blur,ri", [(512, 512, "motion", 10),
                                           (250, 190, "asym", 3),
                                           (20, 17, "motion", 1),
                                           (7, 300, "asym", 2)])
def test_deblur_resident_is_the_streaming_sequence(dev, nx, ny, blur, ri):
    from prost_tpu_torch.ops import fused_deblur as fd

    taps, k = _blur(blur)
    planes = _deblur_planes(70, nx, ny, k, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    before = fd.launch_counts["deblur_chunk"]
    out = _both_paths(fd.deblur_chunk_, planes[:3], planes[3:], scal, ri,
                      taps, 0.5, 0.2)
    _bit_equal(out)
    assert fd.launch_counts["deblur_chunk"] == before + 2


@pytest.mark.parametrize("shards,ri", [(1, 10), (2, 10), (4, 5)])
def test_deblur_halo_resident_is_the_streaming_sequence(dev, shards, ri):
    """Config 2's bands (520 rows of the full-convolution grid): every
    band's resident launch is its streaming sequence, bit for bit."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.parallel.spatial_fused import window

    taps, k = _blur("motion")
    planes = _deblur_planes(71, 512, 512, k, dev)
    H, rows = fd.deblur_halo_rows(ri, taps), 520 // shards
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0, lo, H, H + rows],
                            device=dev)
        _bit_equal(_both_paths(fd.deblur_chunk_halo_, ext[:3], ext[3:],
                               scal, ri, 512, taps, 0.5, 0.2))


def _ml_planes(seed, L, nx, ny, dev):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(2 * L, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("L,nx,ny,ri", [(8, 256, 256, 10), (5, 250, 190, 3),
                                        (1, 9, 40, 2), (3, 300, 33, 1)])
def test_ml_resident_is_the_streaming_sequence(dev, L, nx, ny, ri):
    from prost_tpu_torch.ops import fused_multilabel as fm

    planes = _ml_planes(72, L, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0], device=dev)
    before = fm.launch_counts["ml_chunk"]
    _bit_equal(_both_paths(fm.ml_chunk_, planes[:3], planes[3:], scal, ri))
    assert fm.launch_counts["ml_chunk"] == before + 2


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_ml_halo_resident_is_the_streaming_sequence(dev, shards):
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _ml_planes(73, 8, 256, 256, dev)
    ri, rows = 10, 256 // shards
    H = 2 * ri + 2
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0, lo, H, H + rows],
                            device=dev)
        _bit_equal(_both_paths(fm.ml_chunk_halo_, ext[:3], ext[3:], scal, ri,
                               256))


def test_resident_chunks_with_the_flag_leave_the_buffers(dev):
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm

    taps, k = _blur("motion")
    db = _deblur_planes(74, 64, 48, k, dev)
    ml = _ml_planes(75, 4, 64, 48, dev)
    for fn, planes, head, extra in (
            (fd.deblur_chunk_, db, [0.9, 1.1, 1.0, 100.0, 1.0],
             (taps, 0.5, 0.2)),
            (fm.ml_chunk_, ml, [0.9, 1.1, 1.0, 0.5, 1.0], ())):
        cur = [t.clone() for t in planes[:3]]
        prev = [t + 1.0 for t in cur]
        before = [t.clone() for t in cur + prev]
        scal = torch.tensor(head + [1.0], device=dev)
        norms2 = fn(*cur, *prev, *planes[3:], scal, 4, *extra,
                    path="resident")
        torch.cuda.synchronize()
        assert not norms2.any()
        for a, b in zip(cur + prev, before):
            assert torch.equal(a, b)


def test_shape_rule_on_the_card(dev):
    """The card's limits send config 2 and config 3 (and their one-shard
    bands) to the resident launch and DB_LARGE and ML_LARGE to the
    streaming sequence; asking for a resident chunk that does not fit
    raises, and so does the launch the C side refuses (9 labels)."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops.pdhg_chunk import launch

    taps, _ = _blur("motion")
    sms, smem = fd.card_limits(dev)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    assert fd.resident_ok(520, 512, 520, taps, sms, smem)
    assert fd.resident_ok(828, 512, 520, taps, sms, smem)
    assert not fd.resident_ok(2056, 2048, 2056, taps, sms, smem)
    assert fm.resident_ok(8, 256, 256, *fm.card_limits(dev, 8))
    assert fm.resident_ok(8, 300, 256, *fm.card_limits(dev, 8))
    assert not fm.resident_ok(8, 512, 512, *fm.card_limits(dev, 8))
    big = _deblur_planes(76, 2048, 2048, 9, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fd.deblur_chunk_(*big[:3], *[t.clone() for t in big[:3]], *big[3:],
                         scal, 2, taps, 0.5, 0.2, path="resident")
    u, q, s, f = _ml_planes(77, 9, 16, 16, dev)
    lib = fm._lib()
    sc = scalar_buffer(torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0], device=dev),
                       5, S_CONV, S_LEN)
    partial = u.new_empty(4 * lib.prost_ml_num_blocks(16, 16))
    terms = u.new_empty(4, 16, 16)
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_ml_chunk_resident", "ml_chunk", fm.launch_counts,
               dev, [u, q, s, u.clone(), q.clone(), s.clone(), f, sc,
                     partial, terms], 9, 16, 16, 1 / 9, (1 / 9) ** 0.5, 0, 2)


# ---------------------------------------------------------------------------
# row 15: the batched multilabel chunk, its instances one after another
# ---------------------------------------------------------------------------

def _ml_batch(seed, B, L, nx, ny, dev, flags=None):
    """A route's flat rows: x (B, L n), y (B, 2 L n + n), and f (B, L, nx,
    ny) and the (5, B) (+ flags) scalar rows."""
    rng = np.random.RandomState(seed)
    n = nx * ny
    x = rng.rand(B, L * n)
    y = np.concatenate([0.3 * rng.randn(B, 2 * L * n),
                        0.1 * rng.randn(B, n)], 1)
    f = rng.rand(B, L, nx, ny)
    rows = [0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B), np.ones(B),
            0.3 + 0.4 * rng.rand(B), rng.rand(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, y, f, np.array(rows))]


def _ml_views(x, y, L, nx, ny):
    B, n2 = x.shape[0], 2 * L * nx * ny
    return (x.view(B, L, nx, ny), y[:, :n2].view(B, 2 * L, nx, ny),
            y[:, n2:].view(B, nx, ny))


@pytest.mark.parametrize("B,L,nx,ny,ri,flags", [
    (8, 8, 256, 256, 10, None),                      # the 8-instance config 3
    (8, 8, 256, 256, 10, [0, 1, 0, 0, 1, 1, 0, 0]),  # with flagged instances
    (3, 5, 250, 190, 3, [0, 1, 0]),                  # ragged
    (1, 8, 256, 256, 10, None),                      # B = 1
    (4, 1, 9, 40, 2, [1, 0, 0, 1])])
def test_ml_batched_resident_is_streaming_and_each_instance(dev, B, L, nx,
                                                            ny, ri, flags):
    """``ml_chunk_batched_`` in place on a route's views: the resident
    launch against the streaming sequence from the same inputs, and each
    instance against ``ml_chunk_`` (resident) on that instance alone, bit
    for bit in the state, the previous iterate and the norms; a flagged
    instance's buffers untouched; one launch per call."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    x, y, f, scal = _ml_batch(80 + B + L, B, L, nx, ny, dev, flags)
    got = {}
    for path in ("streaming", "resident"):
        cur = [x.clone(), y.clone()]
        prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
        before = fm.launch_counts["ml_chunk_batched"]
        norms2 = fm.ml_chunk_batched_(*_ml_views(*cur, L, nx, ny),
                                      *_ml_views(*prev, L, nx, ny), f, scal,
                                      ri, path=path).clone()
        assert fm.launch_counts["ml_chunk_batched"] == before + 1
        got[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    for a, b in zip(got["streaming"], got["resident"]):
        assert torch.equal(a, b)
    res = got["resident"]
    views = _ml_views(res[0], res[1], L, nx, ny) + _ml_views(res[2], res[3],
                                                             L, nx, ny)
    ins = _ml_views(x, y, L, nx, ny)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(views[:3], ins):
                assert torch.equal(a[b], i[b])
            for a in views[3:]:
                assert torch.all(a[b] == 7.0)
            assert not res[4][:, b].any()
            continue
        cur = [i[b].contiguous().clone() for i in ins]
        prev = [torch.empty_like(t) for t in cur]
        one = fm.ml_chunk_(*cur, *prev, f[b], scal[:5, b], ri,
                           path="resident")
        for a, c in zip(views, cur + prev):
            assert torch.equal(a[b], c)
        assert torch.equal(res[4][:, b], one)


def test_ml_batched_light_call_on_the_card(dev):
    """``MLBatchedChunk`` at 8 instances of 256x256x8 takes the resident
    path and leaves what ``ml_chunk_batched_`` leaves, twice in a row."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    B, L, n = 8, 8, 256
    x, y, f, scal = _ml_batch(90, B, L, n, n, dev)
    m = {"L": L, "nx": n, "ny": n, "radius": scal[3], "d_s": scal[4]}
    call = fm.MLBatchedChunk(m, B, 10, dev)
    assert call.resident
    cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    want_cur, want_prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    flag = torch.tensor(False, device=dev)
    full = torch.cat([scal, torch.zeros(1, B, device=dev)])
    for _ in range(2):
        norms2 = call(_ml_views(*cur, L, n, n), _ml_views(*prev, L, n, n), f,
                      scal[0], scal[1], scal[2], flag)
        want = fm.ml_chunk_batched_(*_ml_views(*want_cur, L, n, n),
                                    *_ml_views(*want_prev, L, n, n), f, full,
                                    10, path="resident")
        for a, b in zip(cur + prev + [norms2],
                        want_cur + want_prev + [want]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# row 9: the ADMM multichunk grid-resident
# ---------------------------------------------------------------------------

def _both_multichunks(planes, f, w, scal, count, k_chunks, degree, consts,
                      dataterm):
    """``admm_multichunk_`` by the launch sequence and by the resident
    launch from the same inputs: (arrays, norms, sout) of each."""
    from prost_tpu_torch.ops import fused_admm as fa

    out = {}
    for path in ("streaming", "resident"):
        cur = [t.clone() for t in planes]
        before = fa.launch_counts["admm_multichunk"]
        norms, sout = fa.admm_multichunk_(*cur, f, w, scal, count, k_chunks,
                                          1.7, degree, consts, dataterm,
                                          path=path)
        assert fa.launch_counts["admm_multichunk"] == before + 1
        out[path] = cur + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


def _admm_consts(nx, ny):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 0.8, 1.01)


@pytest.mark.parametrize("degree", [1, 10, 65])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny", [(512, 512), (300, 190)])
def test_admm_multichunk_resident_is_the_launch_sequence(dev, nx, ny,
                                                         dataterm, degree):
    """Every chunk runs (tolerance 0): the resident launch's arrays, norms
    and sout bit-equal to the launch sequence's, from arrays with mass on
    the dead z coordinates."""
    planes = _admm_planes(100 + degree, nx, ny, dev)
    scal = torch.tensor([1.3, 8.0, 1.0, 1.05, 0.0, 0.0, 0.0] + [0.0] * 4,
                        device=dev)
    out = _both_multichunks(planes[:7], *planes[7:], scal, 10, 8, degree,
                            _admm_consts(nx, ny), dataterm)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert out["resident"][8][4:].tolist() == [0.0, 8.0]
    assert all(bool(torch.isfinite(t).all()) for t in out["resident"])


def _solve_start(nx, ny, dev):
    """A solve's first state (x_half = f = a smooth test image, the rest
    zero), f and w."""
    i, j = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                       indexing="ij")
    rng = np.random.RandomState(7)
    f = (0.4 * ((i - 0.5) ** 2 + (j - 0.5) ** 2 < 0.09) + 0.3 * (i > 0.7)
         + 0.05 * rng.randn(nx, ny)).astype(np.float32)
    f = torch.from_numpy(f).to(dev)
    zero, z = torch.zeros_like(f), torch.zeros((2, nx, ny), device=dev)
    return [f, zero, zero, z, z, z, zero], f


@pytest.mark.parametrize("nx,ny", [(512, 512), (300, 190)])
def test_admm_multichunk_resident_converging_mid_call(dev, nx, ny):
    """From a solve's start with tolerance 2e-3 rho adapts and the launch
    converges before its last chunk: the resident launch leaves the loop
    with the whole grid at the same chunk, bit-equal to the sequence,
    rescale factor included."""
    planes, f = _solve_start(nx, ny, dev)
    scal = torch.tensor([1.0, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0]
                        + [2e-3] * 4, device=dev)
    out = _both_multichunks(planes, f, f, scal, 10, 8, 10,
                            _admm_consts(nx, ny), "square")
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    sout = out["resident"][8]
    assert float(sout[4]) == 1.0 and float(sout[5]) < 8.0
    assert float(sout[0]) != 1.0  # rho adapted


def test_admm_multichunk_resident_with_the_flag_at_entry(dev):
    from prost_tpu_torch.ops import fused_admm as fa

    planes = _admm_planes(110, 512, 512, dev)
    scal = torch.tensor([1.3, 8.0, 1.0, 1.05, 2.0, 3.0, 11.0] + [1e-3] * 4
                        + [1.0], device=dev)
    out = _both_multichunks(planes[:7], *planes[7:], scal, 10, 8, 10,
                            _admm_consts(512, 512), "square")
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    for a, b in zip(out["resident"][:7], planes[:7]):
        assert torch.equal(a, b)
    assert out["resident"][8].tolist() == pytest.approx(
        [1.3, 1.05, 2.0, 3.0, 1.0, 0.0])
    assert fa.admm_resident_ok(512, 512, "square",
                               *fa.admm_card_limits(dev))


def test_admm_multichunk_light_call_on_the_card(dev):
    """``ADMMMultichunk`` at config 4's 512x512 takes the resident path and
    leaves what ``admm_multichunk_`` leaves, twice in a row from the state
    it left (its scalar buffer reused)."""
    from prost_tpu_torch.ops import fused_admm as fa

    planes, f = _solve_start(512, 512, dev)
    r = {"nx": 512, "ny": 512, "f": f, "w": f, "dataterm": "square",
         "lmb_t": torch.tensor(16.0, device=dev),
         "radius_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(1e-4, device=dev) for _ in range(4)),
         "consts": _admm_consts(512, 512)}
    call = fa.ADMMMultichunk(r, 10, 8, 1.7, 10, dev)
    assert call.resident
    cur = [t.clone() for t in planes]
    want = [t.clone() for t in planes]
    s = [torch.tensor(v, device=dev) for v in (1.0, 1.05, 0.0, 0.0)]
    for it in (0, 80):
        norms, sout = call(cur, *s, torch.tensor(it, device=dev),
                           torch.tensor(False, device=dev))
        scal = torch.tensor([1.0, 16.0, 1.0, 1.05, 0.0, 0.0, float(it)]
                            + [1e-4] * 4 + [0.0], device=dev)
        wn, ws = fa.admm_multichunk_(*want, f, f, scal, 10, 8, 1.7, 10,
                                     r["consts"], "square", path="resident")
        for a, b in zip(cur + [norms, sout], want + [wn, ws]):
            assert torch.equal(a, b)


def test_ml_batched_and_admm_multichunk_rules_on_the_card(dev):
    """The card's limits send 8 instances of config 3 (and any batch of
    them) and config 4 at 512x512 to the resident launches, 512x512x8
    instances to the streaming sequences and the 2048x2048 ADMM plane away
    from them (to the tiled launches, ``-k admm_tiled``);
    asking for a resident launch that does not fit raises, and so does the
    launch the C side refuses (9 labels)."""
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops import fused_multilabel as fm

    limits = fm.card_limits(dev, 8, True)
    assert limits[0] == torch.cuda.get_device_properties(
        dev).multi_processor_count
    assert fm.resident_ok(8, 256, 256, *limits)
    assert not fm.resident_ok(8, 512, 512, *limits)
    for dataterm in ("square", "wsquare", "abs"):
        assert fa.admm_resident_ok(512, 512, dataterm,
                                   *fa.admm_card_limits(dev))
        assert not fa.admm_resident_ok(2048, 2048, dataterm,
                                       *fa.admm_card_limits(dev))
    x, y, f, scal = _ml_batch(120, 2, 8, 512, 512, dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fm.ml_chunk_batched_(*_ml_views(x, y, 8, 512, 512),
                             *_ml_views(x.clone(), y.clone(), 8, 512, 512),
                             f, scal, 2, path="resident")
    big = _admm_planes(121, 2048, 2048, dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fa.admm_multichunk_(*big[:7], *big[7:],
                            torch.tensor([1.3, 8.0, 1.0, 1.05, 0.0, 0.0, 0.0]
                                         + [0.0] * 4, device=dev), 10, 8,
                            1.7, 10, _admm_consts(2048, 2048),
                            path="resident")
    x, y, f, scal = _ml_batch(122, 2, 9, 16, 16, dev)
    lib = fm._lib()
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(8 * lib.prost_ml_num_blocks(16, 16))
    terms = x.new_empty(4, 16, 16)
    n = 16 * 16
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_ml_chunk_batched_resident", "ml_chunk_batched",
               fm.launch_counts, dev,
               [*_ml_views(x, y, 9, 16, 16),
                *_ml_views(x.clone(), y.clone(), 9, 16, 16), f, sc, partial,
                terms], 9, 16, 16, 1 / 9, (1 / 9) ** 0.5, 9 * n,
               19 * n, 19 * n, 2, 2)


# ---------------------------------------------------------------------------
# rows 25 and 18: the batched volumetric and deblur chunks, their instances
# one after another
# ---------------------------------------------------------------------------

def _vol_batch(seed, B, L, nx, ny, dev, flags=None):
    """A route's flat rows: x (B, L n), y (B, 3 L n), f and w (B, L, nx,
    ny) and the (5, B) (+ flags) scalar rows."""
    rng = np.random.RandomState(seed)
    n = L * nx * ny
    arrs = (rng.rand(B, n), 0.3 * rng.randn(B, 3 * n), rng.rand(B, L, nx, ny),
            2.0 * (rng.rand(B, L, nx, ny) > 0.3))
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            6.0 * (0.5 + rng.rand(B)), 0.5 + rng.rand(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (*arrs, np.array(rows))]


def _vol_views(x, y, L, nx, ny):
    B = x.shape[0]
    return x.view(B, L, nx, ny), y.view(B, 3, L, nx, ny)


@pytest.mark.parametrize("B,L,nx,ny,ri,dataterm,flags", [
    (8, 8, 256, 256, 10, "square", None),              # vol256x8's ensemble
    (8, 8, 256, 256, 10, "wsquare", [0, 1, 0, 0, 1, 1, 0, 0]),
    (8, 8, 256, 256, 10, "abs", None),
    (3, 5, 190, 250, 3, "wsquare", [0, 1, 0]),         # ragged
    (3, 3, 77, 33, 2, "abs", [1, 0, 0]),
    (2, 1, 64, 96, 1, "square", None),                 # one slice
    (1, 8, 256, 256, 10, "square", None)])             # B = 1
def test_vol_batched_resident_is_streaming_and_each_instance(
        dev, B, L, nx, ny, ri, dataterm, flags):
    """``vol_chunk_batched_`` in place on a route's views: the resident
    launch against the streaming sequence from the same inputs, and each
    volume against ``vol_chunk`` (the streaming single-instance chunk) on
    it alone, bit for bit in the state, the previous iterate and the norms;
    a flagged volume's buffers untouched; one launch per call."""
    from prost_tpu_torch.ops import fused_vol as fv

    x, y, f, w, scal = _vol_batch(130 + B + L, B, L, nx, ny, dev, flags)
    got = {}
    for path in ("streaming", "resident"):
        cur = [x.clone(), y.clone()]
        prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
        before = fv.launch_counts["vol_chunk_batched"]
        norms2 = fv.vol_chunk_batched_(
            *_vol_views(*cur, L, nx, ny), *_vol_views(*prev, L, nx, ny), f,
            w, scal, ri, dataterm, path=path).clone()
        assert fv.launch_counts["vol_chunk_batched"] == before + 1
        got[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    for a, b in zip(got["streaming"], got["resident"]):
        assert torch.equal(a, b)
    res = got["resident"]
    views = _vol_views(res[0], res[1], L, nx, ny) + _vol_views(
        res[2], res[3], L, nx, ny)
    ins = _vol_views(x, y, L, nx, ny)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(views[:2], ins):
                assert torch.equal(a[b], i[b])
            for a in views[2:]:
                assert torch.all(a[b] == 7.0)
            assert not res[4][:, b].any()
            continue
        one = fv.vol_chunk(ins[0][b], ins[1][b], f[b], w[b], scal[:5, b], ri,
                           dataterm)
        for a, c in zip(views, one[:4]):
            assert torch.equal(a[b], c)
        assert torch.equal(res[4][:, b], one[4])
    assert all(bool(torch.isfinite(t).all()) for t in res)


def test_vol_batched_light_call_on_the_card(dev):
    """``VolBatchedChunk`` at 8 volumes of 256x256x8 takes the resident
    path and leaves what ``vol_chunk_batched_`` leaves, twice in a row."""
    from prost_tpu_torch.ops import fused_vol as fv

    B, L, n = 8, 8, 256
    x, y, f, w, scal = _vol_batch(140, B, L, n, n, dev)
    m = {"L": L, "nx": n, "ny": n, "dataterm": "square", "lmb": scal[3],
         "radius": scal[4]}
    call = fv.VolBatchedChunk(m, B, 10, dev)
    assert call.resident
    cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    want_cur, want_prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    flag = torch.tensor(False, device=dev)
    full = torch.cat([scal, torch.zeros(1, B, device=dev)])
    for _ in range(2):
        norms2 = call(_vol_views(*cur, L, n, n), _vol_views(*prev, L, n, n),
                      f, w, scal[0], scal[1], scal[2], flag)
        want = fv.vol_chunk_batched_(*_vol_views(*want_cur, L, n, n),
                                     *_vol_views(*want_prev, L, n, n), f, w,
                                     full, 10, path="resident")
        for a, b in zip(cur + prev + [norms2],
                        want_cur + want_prev + [want]):
            assert torch.equal(a, b)


def _deblur_batch(seed, B, nx, ny, blur, dev, flags=None):
    """A route's flat rows x (B, n) and y (B, m2 + 2 n), fb and sv (B,
    nx2, ny2), the (5, B) (+ flags) scalar rows, the taps and (nx2,
    ny2)."""
    taps, k = _blur(blur)
    nx2, ny2 = nx + k - 1, ny + k - 1
    n, m2 = nx * ny, nx2 * ny2
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(B, n),
            np.concatenate([rng.randn(B, m2), 0.3 * rng.randn(B, 2 * n)], 1),
            rng.rand(B, nx2, ny2), 0.5 + rng.rand(B, nx2, ny2))
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            100.0 * (0.5 + rng.rand(B)), np.ones(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    out = [torch.from_numpy(a.astype(np.float32)).to(dev)
           for a in (*arrs, np.array(rows))]
    return out, taps, (nx2, ny2)


def _deblur_views(x, y, nx, ny, nx2, ny2):
    B, m2 = x.shape[0], nx2 * ny2
    return (x.view(B, nx, ny), y[:, :m2].view(B, nx2, ny2),
            y[:, m2:].view(B, 2, nx, ny))


@pytest.mark.parametrize("B,nx,ny,blur,ri,flags", [
    (8, 512, 512, "motion", 10, None),                    # deblur8x512
    (8, 512, 512, "motion", 10, [0, 0, 1, 0, 0, 0, 1, 0]),
    (3, 250, 190, "asym", 3, [0, 1, 0]),                  # ragged
    (3, 20, 17, "motion", 1, None),
    (2, 7, 300, "asym", 2, [1, 0]),
    (1, 512, 512, "motion", 10, None)])                   # B = 1
def test_deblur_batched_resident_is_streaming_and_each_frame(
        dev, B, nx, ny, blur, ri, flags):
    """``deblur_chunk_batched_`` in place on a route's views (yv and q
    share a row): the resident launch against the streaming sequence from
    the same inputs, and each frame against ``deblur_chunk_`` (resident) on
    it alone, bit for bit in the state, the previous iterate and the norms;
    a flagged frame's buffers untouched; one launch per call."""
    from prost_tpu_torch.ops import fused_deblur as fd

    (x, y, fb, sv, scal), taps, (nx2, ny2) = _deblur_batch(
        150 + B + nx, B, nx, ny, blur, dev, flags)
    shape = (nx, ny, nx2, ny2)
    got = {}
    for path in ("streaming", "resident"):
        cur = [x.clone(), y.clone()]
        prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
        before = fd.launch_counts["deblur_chunk_batched"]
        norms2 = fd.deblur_chunk_batched_(
            *_deblur_views(*cur, *shape), *_deblur_views(*prev, *shape), fb,
            sv, scal, ri, taps, 0.5, 0.2, path=path).clone()
        assert fd.launch_counts["deblur_chunk_batched"] == before + 1
        got[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    for a, b in zip(got["streaming"], got["resident"]):
        assert torch.equal(a, b)
    res = got["resident"]
    views = _deblur_views(res[0], res[1], *shape) + _deblur_views(
        res[2], res[3], *shape)
    ins = _deblur_views(x, y, *shape)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(views[:3], ins):
                assert torch.equal(a[b], i[b])
            for a in views[3:]:
                assert torch.all(a[b] == 7.0)
            assert not res[4][:, b].any()
            continue
        cur = [i[b].contiguous().clone() for i in ins]
        prev = [torch.empty_like(t) for t in cur]
        one = fd.deblur_chunk_(*cur, *prev, fb[b], sv[b], scal[:5, b], ri,
                               taps, 0.5, 0.2, path="resident")
        for a, c in zip(views, cur + prev):
            assert torch.equal(a[b], c)
        assert torch.equal(res[4][:, b], one)
    assert all(bool(torch.isfinite(t).all()) for t in res)


def test_deblur_batched_light_call_on_the_card(dev):
    """``DeblurBatchedChunk`` at deblur8x512's shape takes the resident
    path and leaves what ``deblur_chunk_batched_`` leaves, twice in a
    row."""
    from prost_tpu_torch.ops import fused_deblur as fd

    B, n = 8, 512
    (x, y, fb, sv, scal), taps, (nx2, ny2) = _deblur_batch(160, B, n, n,
                                                           "motion", dev)
    shape = (n, n, nx2, ny2)
    m = {"nx": n, "ny": n, "nx2": nx2, "ny2": ny2, "taps": taps,
         "sig_q": 0.5, "tau_t": 0.2, "lmb": scal[3], "radius": scal[4]}
    call = fd.DeblurBatchedChunk(m, B, 10, dev)
    assert call.resident
    cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    want_cur, want_prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    flag = torch.tensor(False, device=dev)
    full = torch.cat([scal, torch.zeros(1, B, device=dev)])
    for _ in range(2):
        norms2 = call(_deblur_views(*cur, *shape),
                      _deblur_views(*prev, *shape), fb, sv, scal[0], scal[1],
                      scal[2], flag)
        want = fd.deblur_chunk_batched_(
            *_deblur_views(*want_cur, *shape),
            *_deblur_views(*want_prev, *shape), fb, sv, full, 10, taps, 0.5,
            0.2, path="resident")
        for a, b in zip(cur + prev + [norms2],
                        want_cur + want_prev + [want]):
            assert torch.equal(a, b)


def test_vol_batched_and_deblur_batched_rules_on_the_card(dev):
    """The card's limits send the 8-volume vol256x8 ensemble (every data
    term) and deblur8x512's frames to the resident launches, 512x512x8
    volumes and 2048x2048 frames to the streaming sequences; asking for a
    resident launch that does not fit raises, and so do the launches the C
    side refuses (9 labels, a band beyond the card's shared memory)."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops import fused_vol as fv

    sms, smem = fv.card_limits(dev, 8)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    for dataterm in ("square", "wsquare", "abs"):
        assert fv.resident_ok(8, 256, 256, dataterm, sms, smem)
        assert not fv.resident_ok(8, 512, 512, dataterm, sms, smem)
    taps, _ = _blur("motion")
    limits = fd.card_limits(dev, fd.BATCHED)
    assert fd.resident_ok(520, 512, 520, taps, *limits)
    assert not fd.resident_ok(2056, 2048, 2056, taps, *limits)
    x, y, f, w, scal = _vol_batch(170, 2, 8, 512, 512, dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fv.vol_chunk_batched_(*_vol_views(x, y, 8, 512, 512),
                              *_vol_views(x.clone(), y.clone(), 8, 512, 512),
                              f, w, scal, 2, path="resident")
    (dx, dy, fb, sv, dscal), _, (nx2, ny2) = _deblur_batch(
        171, 2, 2048, 2048, "motion", dev)
    shape = (2048, 2048, nx2, ny2)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fd.deblur_chunk_batched_(*_deblur_views(dx, dy, *shape),
                                 *_deblur_views(dx.clone(), dy.clone(),
                                                *shape), fb, sv, dscal, 2,
                                 taps, 0.5, 0.2, path="resident")
    lib = fv._lib()
    x, y, f, w, scal = _vol_batch(172, 2, 9, 16, 16, dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(8 * lib.prost_vol_num_blocks(16, 16))
    terms = x.new_empty(4, 16, 16)
    n = 9 * 16 * 16
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_vol_chunk_batched_resident", "vol_chunk_batched",
               fv.launch_counts, dev,
               [*_vol_views(x, y, 9, 16, 16),
                *_vol_views(x.clone(), y.clone(), 9, 16, 16), f, w, sc,
                partial, terms], 9, 16, 16, n, 3 * n, 2, 0, 2)
    dlib = fd._lib()
    sc = scalar_buffer(dscal, 5, S_CONV, S_LEN)
    partial = dx.new_empty(8 * dlib.prost_deblur_num_blocks(nx2, ny2))
    terms = dx.new_empty(4, nx2, ny2)
    m2, nn = nx2 * ny2, 2048 * 2048
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(dlib, "prost_deblur_chunk_batched_resident",
               "deblur_chunk_batched", fd.launch_counts, dev,
               [*_deblur_views(dx, dy, *shape),
                *_deblur_views(dx.clone(), dy.clone(), *shape), fb, sv,
                fd.taps_array(taps, dev), sc, partial, terms], *shape,
               len(taps), fd.taps_reach(taps), 0.5, 0.2, 0.5 ** 0.5,
               0.2 ** 0.5, nn, m2 + 2 * nn, m2 + 2 * nn, 0, 2, 2)


@pytest.mark.parametrize("B,nx,ny,blur,ri,flags", [
    (8, 512, 512, "motion", 10, None),                    # deblur8x512
    (5, 250, 190, "asym", 3, [0, 0, 1, 0, 0]),            # an odd frame out
    (3, 20, 17, "motion", 2, [0, 1, 1]),                  # one frame left
    (2, 7, 300, "asym", 2, None)])
def test_deblur_batched_pairs_is_one_frame_a_block(dev, B, nx, ny, blur, ri,
                                                   flags):
    """The resident batched deblur chunk with two frames side by side in a
    block (``deblur_resident_batched<N, 2>``) against one frame a block
    (``deblur_resident_batched``), in place on a route's views from the
    same inputs: bit for bit in the state, the previous iterate and the
    norms, flagged frames untouched, an odd frame out run in both halves."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops.pdhg_chunk import instance_strides

    (x, y, fb, sv, scal), taps, (nx2, ny2) = _deblur_batch(
        180 + B + nx, B, nx, ny, blur, dev, flags)
    shape = (nx, ny, nx2, ny2)
    assert fd.pairs_ok(nx2, ny, ny2, taps, *fd.card_limits(dev, fd.PAIRS))
    taps_t = fd.taps_array(taps, dev)
    got = {}
    for pairs in (False, True):
        cur = [x.clone(), y.clone()]
        prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
        st = _deblur_views(*cur, *shape)
        pv = _deblur_views(*prev, *shape)
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = x.new_empty(4 * B * fd._lib().prost_deblur_num_blocks(
            nx2, ny2))
        fd._launch_batched(st, pv, fb, sv, taps_t, sc, partial,
                           fd._scratch("resident", nx, ny, nx2, ny2, dev, B,
                                       pairs),
                           True, ri, taps, 0.5, 0.2,
                           instance_strides(st, pv, "deblur_chunk_batched_"),
                           pairs)
        got[pairs] = cur + prev + [sc[:, 15:19].clone()]
    torch.cuda.synchronize()
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)
    ins = _deblur_views(x, y, *shape)
    outs = _deblur_views(got[True][0], got[True][1], *shape)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(outs, ins):
                assert torch.equal(a[b], i[b])
        else:
            assert not torch.equal(outs[0][b], ins[0][b])


# ---------------------------------------------------------------------------
# rows 20, 23 and 24: the tight and volumetric chunks grid-resident, whole
# plane and halo band (-k "tight_resident or vol_resident")
# ---------------------------------------------------------------------------

def _tight_case(seed, L, nx, ny, dev):
    """The example's taps and constant preconditioner for L labels, and a
    chunk's u, v, q, p, s and f on the card."""
    k = L * (L - 1) // 2
    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i], P[idx, j] = 1.0, -1.0
            P[idx + k, i + L], P[idx + k, j + L] = 1.0, -1.0
            idx += 1
    taps = tuple((r, m, float(P.T[r, m])) for r in range(2 * L)
                 for m in range(2 * k) if P.T[r, m] != 0.0)
    consts = tuple(float(np.float32(c))
                   for c in (1 / (L + 1), 1.0, 1 / L, 0.2, 1 / 3))
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.2 * rng.randn(2 * L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in arrs], taps, consts


@pytest.mark.parametrize("L,nx,ny,ri", [(4, 128, 128, 10), (3, 128, 128, 10),
                                        (3, 250, 190, 3), (2, 9, 40, 2),
                                        (5, 300, 33, 1)])
def test_tight_resident_is_the_streaming_sequence(dev, L, nx, ny, ri):
    from prost_tpu_torch.ops import fused_tight as ft

    planes, taps, consts = _tight_case(180, L, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 0.7, 1.0], device=dev)
    before = ft.launch_counts["tight_chunk"]
    _bit_equal(_both_paths(ft.tight_chunk_, planes[:5], planes[5:], scal, ri,
                           taps, consts))
    assert ft.launch_counts["tight_chunk"] == before + 2


@pytest.mark.parametrize("L", [3, 4])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_tight_resident_halo_is_the_streaming_sequence(dev, L, shards):
    """tight128x4's bands (ri 10, halo 22; 172 rows for one shard): every
    band's resident launch, edge and middle shards, is its streaming
    sequence, bit for bit."""
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel.spatial_fused import window

    planes, taps, consts = _tight_case(181, L, 128, 128, dev)
    ri, rows = 10, 128 // shards
    H = 2 * ri + 2
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor([0.9, 1.1, 1.0, 0.7, 1.0, lo, H, H + rows],
                            device=dev)
        _bit_equal(_both_paths(ft.tight_chunk_halo_, ext[:5], ext[5:], scal,
                               ri, 128, taps, consts))


def _vol_planes(seed, L, nx, ny, dev):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(3, L, nx, ny),
            rng.rand(L, nx, ny), 2.0 * (rng.rand(L, nx, ny) > 0.3))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("L,nx,ny,ri,dataterm", [
    (8, 256, 256, 10, "square"), (8, 256, 256, 10, "abs"),
    (8, 256, 256, 10, "wsquare"), (5, 190, 250, 3, "wsquare"),
    (1, 9, 40, 2, "square"), (3, 300, 33, 1, "abs")])
def test_vol_resident_is_the_streaming_sequence(dev, L, nx, ny, ri,
                                                dataterm):
    from prost_tpu_torch.ops import fused_vol as fv

    planes = _vol_planes(182, L, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0], device=dev)
    before = fv.launch_counts["vol_chunk"]
    _bit_equal(_both_paths(fv.vol_chunk_, planes[:2], planes[2:], scal, ri,
                           dataterm))
    assert fv.launch_counts["vol_chunk"] == before + 2


@pytest.mark.parametrize("dataterm", ["square", "abs"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_vol_resident_halo_is_the_streaming_sequence(dev, shards, dataterm):
    """vol256x8's bands (ri 10, halo 22; 300 rows for one shard, bands of 3
    rows a block): every band's resident launch, edge and middle shards,
    is its streaming sequence, bit for bit."""
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _vol_planes(183, 8, 256, 256, dev)
    ri, rows = 10, 256 // shards
    H = 2 * ri + 2
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, lo, H, H + rows],
                            device=dev)
        _bit_equal(_both_paths(fv.vol_chunk_halo_, ext[:2], ext[2:], scal,
                               ri, 256, dataterm))


def test_tight_resident_and_vol_resident_with_the_flag_leave_the_buffers(
        dev):
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv

    tplanes, taps, consts = _tight_case(184, 4, 64, 48, dev)
    vplanes = _vol_planes(185, 4, 64, 48, dev)
    for fn, state, data, head, extra in (
            (ft.tight_chunk_, tplanes[:5], tplanes[5:],
             [0.9, 1.1, 1.0, 0.7, 1.0], (taps, consts)),
            (fv.vol_chunk_, vplanes[:2], vplanes[2:],
             [0.9, 1.1, 1.0, 6.0, 1.0], ())):
        cur = [t.clone() for t in state]
        prev = [t + 1.0 for t in cur]
        before = [t.clone() for t in cur + prev]
        scal = torch.tensor(head + [1.0], device=dev)
        norms2 = fn(*cur, *prev, *data, scal, 4, *extra, path="resident")
        torch.cuda.synchronize()
        assert not norms2.any()
        for a, b in zip(cur + prev, before):
            assert torch.equal(a, b)


def test_tight_resident_and_vol_resident_light_calls_on_the_card(dev):
    """``TightChunk`` and ``VolChunk``, whole plane and on a band of two
    shards, on the card: the resident path, twice in a row on the same
    buffers, the in-place forms' buffers and norms bit for bit."""
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel.spatial_fused import window

    steps = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0)]
    flag = torch.tensor(False, device=dev)
    tplanes, taps, consts = _tight_case(186, 4, 128, 128, dev)
    mt = {"L": 4, "k": 6, "nx": 128, "ny": 128, "taps": taps,
          "consts": consts, "radius": 0.7, "d_s": 1.0}
    vplanes = _vol_planes(187, 8, 256, 256, dev)
    mv = {"L": 8, "nx": 256, "ny": 256, "lmb": 6.0, "radius": 1.0,
          "dataterm": "square"}
    ri, H = 10, 22

    def band(m, planes):
        rows = m["nx"] // 2
        lo = rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        return ext, (m["nx"], rows + 2 * H, lo, H, H + rows)

    text, tband = band(mt, tplanes)
    vext, vband = band(mv, vplanes)
    # (light call, in-place form, state, data, family scalars and row
    # context, the form's arguments after scal and count)
    cases = [(ft.TightChunk(mt, ri, dev), ft.tight_chunk_, tplanes[:5],
              tplanes[5:], [0.7, 1.0], (taps, consts)),
             (fv.VolChunk(mv, ri, dev), fv.vol_chunk_, vplanes[:2],
              vplanes[2:], [6.0, 1.0], ("square",)),
             (ft.TightChunk(mt, ri, dev, tband), ft.tight_chunk_halo_,
              text[:5], text[5:], [0.7, 1.0, *tband[2:]],
              (128, taps, consts)),
             (fv.VolChunk(mv, ri, dev, vband), fv.vol_chunk_halo_, vext[:2],
              vext[2:], [6.0, 1.0, *vband[2:]], (256, "square"))]
    for call, fn, state, data, consts_, tail in cases:
        assert call.resident
        scal = torch.tensor([0.9, 1.1, 1.0] + consts_, device=dev)
        cur = [t.clone() for t in state]
        prev = [t.clone() for t in state]
        want_cur = [t.clone() for t in state]
        want_prev = [t.clone() for t in state]
        for _ in range(2):
            norms2 = call(cur, prev, *data, *steps, flag)
            want = fn(*want_cur, *want_prev, *data, scal, ri, *tail,
                      path="resident")
            for a, b in zip(cur + prev + [norms2],
                            want_cur + want_prev + [want]):
                assert torch.equal(a, b)


def test_tight_resident_and_vol_resident_rules_on_the_card(dev):
    """The card's limits send tight128x4, its 172-row band and 250x190x3,
    and vol256x8 and its 300-row band (square and abs) to the resident
    launches, and 512x512x4, 512x512x8 and the 300-row band with wsquare's
    weights to the streaming sequences; asking for a resident launch that
    does not fit raises, and so does the launch the C side refuses (9
    labels)."""
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops import fused_vol as fv

    sms, smem = ft.card_limits(dev)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    assert ft.resident_ok(4, 6, 24, 128, 128, sms, smem)
    assert ft.resident_ok(4, 6, 24, 172, 128, sms, smem)
    assert ft.resident_ok(3, 3, 12, 250, 190, sms, smem)
    assert not ft.resident_ok(4, 6, 24, 512, 512, sms, smem)
    limits = fv.card_limits(dev, 8)
    for dataterm in ("square", "abs"):
        assert fv.resident_ok(8, 256, 256, dataterm, *limits)
        assert fv.resident_ok(8, 300, 256, dataterm, *limits)
    assert not fv.resident_ok(8, 300, 256, "wsquare", *limits)
    assert not fv.resident_ok(8, 512, 512, "square", *limits)
    planes, taps, consts = _tight_case(188, 4, 512, 512, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 0.7, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        ft.tight_chunk_(*planes[:5], *[t.clone() for t in planes[:5]],
                        planes[5], scal, 2, taps, consts, path="resident")
    u, q, f, w = _vol_planes(189, 8, 300, 256, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, -22, 22, 278], device=dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fv.vol_chunk_halo_(u, q, u.clone(), q.clone(), f, w, scal, 2, 256,
                           "wsquare", path="resident")
    # the 300-row band with wsquare streams by the shape rule
    before = fv.launch_counts["vol_chunk_halo"]
    fv.vol_chunk_halo_(u, q, u.clone(), q.clone(), f, w, scal, 2, 256,
                       "wsquare")
    assert fv.launch_counts["vol_chunk_halo"] == before + 1
    lib = fv._lib()
    u, q, f, w = _vol_planes(190, 9, 16, 16, dev)
    sc = scalar_buffer(torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0], device=dev),
                       5, S_CONV, S_LEN)
    partial = u.new_empty(4 * lib.prost_vol_num_blocks(16, 16))
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_vol_chunk_resident", "vol_chunk", fv.launch_counts,
               dev, [u, q, u.clone(), q.clone(), f, w, sc, partial,
                     u.new_empty(4, 16, 16)], 9, 16, 16, 2, 0)


# ---------------------------------------------------------------------------
# row 8: the Chebyshev ADMM chunk grid-resident; row 26: the volumetric
# multichunk grid-resident
# ---------------------------------------------------------------------------

def _both_admm_chunks(planes, f, w, scal, count, degree, dataterm):
    """``admm_chunk_`` by the launch sequence and by the resident launch
    from the same inputs: the 7 arrays and the squared norms of each, one
    launch each."""
    out = {}
    for path in ("streaming", "resident"):
        cur = [t.clone() for t in planes]
        before = fa.launch_counts["admm_chunk"]
        norms2 = fa.admm_chunk_(*cur, f, w, scal, None, count, 0, 1.7,
                                dataterm, degree, path=path).clone()
        assert fa.launch_counts["admm_chunk"] == before + 1
        out[path] = cur + [norms2]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("count", [1, 10])
@pytest.mark.parametrize("degree", [1, 10, 65])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny", [(512, 512), (300, 190), (13, 40)])
def test_admm_chunk_resident_is_the_launch_sequence(dev, nx, ny, dataterm,
                                                    degree, count):
    """From arrays with mass on the dead z coordinates: the resident
    chunk's arrays and squared norms bit-equal to the launch sequence's
    (13 rows: most of the 132 bands empty)."""
    planes = _admm_planes(200 + degree + count, nx, ny, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    out = _both_admm_chunks(planes[:7], *planes[7:], scal, count, degree,
                            dataterm)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in out["resident"])
    assert bool((out["resident"][7] > 0).all())


def test_admm_chunk_resident_with_the_flag_leaves_the_buffers(dev):
    planes = _admm_planes(210, 512, 512, dev)
    cur = [t.clone() for t in planes[:7]]
    norms2 = fa.admm_chunk_(*cur, *planes[7:],
                            torch.tensor([1.3, 8.0, 1.0, 1.0], device=dev),
                            None, 10, 0, 1.7, "square", 10, path="resident")
    torch.cuda.synchronize()
    assert not norms2.any()
    for a, b in zip(cur, planes[:7]):
        assert torch.equal(a, b)


def test_admm_chunk_light_call_on_the_card(dev):
    """``ADMMChunk`` at config 4's 512x512 takes the resident path and
    leaves what ``admm_chunk_`` leaves, twice in a row from the state it
    left (its scalar buffer reused), and then with the flag set nothing;
    the CGLS chunk asked to run resident raises."""
    planes, f = _solve_start(512, 512, dev)
    r = {"nx": 512, "ny": 512, "f": f, "w": f, "dataterm": "square",
         "lmb_t": torch.tensor(16.0, device=dev),
         "radius_t": torch.tensor(1.0, device=dev)}
    call = fa.ADMMChunk(r, 10, 1.7, 10, dev)
    assert call.resident
    cur = [t.clone() for t in planes]
    want = [t.clone() for t in planes]
    for rho, conv in ((1.0, 0.0), (1.05, 0.0), (1.05, 1.0)):
        norms2 = call(cur, torch.tensor(rho, device=dev),
                      torch.tensor(conv > 0, device=dev))
        scal = torch.tensor([rho, 16.0, 1.0, conv], device=dev)
        wn = fa.admm_chunk_(*want, f, f, scal, None, 10, 0, 1.7, "square",
                            10, path="resident")
        for a, b in zip(cur + [norms2], want + [wn]):
            assert torch.equal(a, b)
    with pytest.raises(ptt.ProstError, match="CGLS projection runs"):
        fa.admm_chunk_(*want, f, f, scal, torch.ones(10, device=dev), 10, 10,
                       1.7, "square", None, path="resident")


def _vol_mc_scal(tol, dev, tau=0.9, sigma=1.1, conv=None):
    return torch.tensor([tau, sigma, 1.0, 6.0, 1.0, 0.5, 0.0, 0.0, 1.0]
                        + [tol] * 4 + ([conv] if conv is not None else []),
                        device=dev)


def _vol_mc_consts(L, nx, ny):
    n = L * nx * ny
    return (float(np.sqrt(3 * n)), float(np.sqrt(n)), 1.5, 0.95, 1.05, 0.8)


def _both_vol_multichunks(u, q, f, w, scal, count, k_chunks, dataterm,
                          stepsize):
    """``vol_multichunk_`` by the launch sequence and by the resident
    launch from the same inputs: volumes, previous iterates, norms and sout
    of each, one launch each."""
    from prost_tpu_torch.ops import fused_vol as fv

    L, nx, ny = u.shape
    out = {}
    for path in ("streaming", "resident"):
        cur, prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
        before = fv.launch_counts["vol_multichunk"]
        norms, sout = fv.vol_multichunk_(*cur, *prev, f, w, scal, count,
                                         k_chunks, dataterm, stepsize,
                                         _vol_mc_consts(L, nx, ny),
                                         path=path)
        assert fv.launch_counts["vol_multichunk"] == before + 1
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
@pytest.mark.parametrize("L,nx,ny,ri,dataterm", [
    (8, 256, 256, 10, "square"), (8, 256, 256, 10, "abs"),
    (8, 256, 256, 10, "wsquare"), (5, 190, 250, 3, "wsquare"),
    (1, 9, 40, 2, "square"), (3, 300, 33, 1, "abs")])
def test_vol_multichunk_resident_is_the_launch_sequence(dev, L, nx, ny, ri,
                                                        dataterm, stepsize):
    """Every chunk runs (tolerance 0), from volumes with mass on the dead
    dual coordinates: the resident launch's volumes, previous iterates,
    norms and sout bit-equal to the launch sequence's."""
    u, q, f, w = _vol_planes(220 + L + ri, L, nx, ny, dev)
    out = _both_vol_multichunks(u, q, f, w, _vol_mc_scal(0.0, dev), ri, 8,
                                dataterm, stepsize)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert out["resident"][5][5:].tolist() == [0.0, 8.0]
    assert all(bool(torch.isfinite(t).all()) for t in out["resident"])


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_vol_multichunk_resident_converging_mid_launch(dev, stepsize):
    """From a solve's start (u = f, q = 0) at tolerance 1e-2 the launch
    adapts and converges before its last chunk: the whole grid leaves at
    the same chunk, bit-equal to the sequence in the volumes, the previous
    iterates, the norms and sout."""
    L, nx, ny = 3, 16, 20
    f = _vol_planes(7, L, nx, ny, dev)[2]
    out = _both_vol_multichunks(f, torch.zeros((3, L, nx, ny), device=dev),
                                f, f, _vol_mc_scal(1e-2, dev, 1.0, 1.0), 5,
                                8, "square", stepsize)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    sout = out["resident"][5]
    assert float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8


def test_vol_multichunk_resident_with_the_flag_leaves_the_buffers(dev):
    from prost_tpu_torch.ops import fused_vol as fv

    u, q, f, w = _vol_planes(230, 8, 256, 256, dev)
    cur = [u.clone(), q.clone()]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms, sout = fv.vol_multichunk_(*cur, *prev, f, w,
                                     _vol_mc_scal(1e-3, dev, conv=1.0), 10,
                                     8, "square", "boyd",
                                     _vol_mc_consts(8, 256, 256),
                                     path="resident")
    torch.cuda.synchronize()
    assert not norms.any() and sout[5:].tolist() == [1.0, 0.0]
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def test_vol_multichunk_light_call_on_the_card(dev):
    """``VolMultichunk`` at vol256x8 takes the resident path and leaves
    what ``vol_multichunk_`` leaves, twice in a row from the state it left
    (its scalar buffer reused)."""
    from prost_tpu_torch.ops import fused_vol as fv

    u, q, f, w = _vol_planes(231, 8, 256, 256, dev)
    consts = _vol_mc_consts(8, 256, 256)
    m = {"L": 8, "nx": 256, "ny": 256, "f": f, "w": w, "dataterm": "square",
         "lmb_t": torch.tensor(6.0, device=dev),
         "radius_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(1e-4, device=dev) for _ in range(4)),
         "adapt_consts": consts}
    call = fv.VolMultichunk(m, 10, 8, "boyd", dev)
    assert call.resident
    cur, prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
    want_cur, want_prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
    steps = (0.9, 1.1, 1.0, 0.5, 0.0, 0.0)
    for it in (1, 81):
        got = call(cur, prev, *(torch.tensor(v, device=dev) for v in steps),
                   torch.tensor(it, device=dev),
                   torch.tensor(False, device=dev))
        scal = torch.tensor(list(steps[:3]) + [6.0, 1.0] + list(steps[3:])
                            + [float(it)] + [1e-4] * 4 + [0.0], device=dev)
        want = fv.vol_multichunk_(*want_cur, *want_prev, f, w, scal, 10, 8,
                                  "square", "boyd", consts, path="resident")
        for a, b in zip(cur + prev + list(got),
                        want_cur + want_prev + list(want)):
            assert torch.equal(a, b)


def test_admm_chunk_and_vol_multichunk_rules_on_the_card(dev):
    """The card's limits send config 4's 512x512 chunk (every data term)
    and vol256x8's multichunk (square, abs and wsquare) to the resident
    launches, the 2048x2048 chunk and 512x512x8's multichunk to the launch
    sequences; asking for a resident launch that does not fit raises, and
    so does the launch the C side refuses (9 labels)."""
    from prost_tpu_torch.ops import fused_vol as fv

    for dataterm in ("square", "wsquare", "abs"):
        assert fa.admm_resident_ok(512, 512, dataterm,
                                   *fa.admm_card_limits(dev))
        assert fv.resident_ok(8, 256, 256, dataterm,
                              *fv.card_limits(dev, 8, multi=True),
                              multi=True)
    limits = fv.card_limits(dev, 8, multi=True)
    assert limits[0] == torch.cuda.get_device_properties(
        dev).multi_processor_count
    assert not fv.resident_ok(8, 512, 512, "square", *limits, multi=True)
    big = _admm_planes(240, 2048, 2048, dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fa.admm_chunk_(*big[:7], *big[7:],
                       torch.tensor([1.3, 8.0, 1.0], device=dev), None, 2, 0,
                       1.7, "square", 10, path="resident")
    before = fa.launch_counts["admm_chunk"]
    fa.admm_chunk_(*big[:7], *big[7:],
                   torch.tensor([1.3, 8.0, 1.0], device=dev), None, 2, 0,
                   1.7, "square", 10)
    assert fa.launch_counts["admm_chunk"] == before + 1
    u, q, f, w = _vol_planes(241, 8, 512, 512, dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fv.vol_multichunk_(u, q, u.clone(), q.clone(), f, w,
                           _vol_mc_scal(0.0, dev), 2, 2, "square", "boyd",
                           _vol_mc_consts(8, 512, 512), path="resident")
    lib = fv._lib()
    u, q, f, w = _vol_planes(242, 9, 16, 16, dev)
    sc = scalar_buffer(_vol_mc_scal(0.0, dev), 13, S_CONV, S_LEN)
    partial = u.new_empty(4 * lib.prost_vol_num_blocks(16, 16))
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_vol_multichunk_resident", "vol_multichunk",
               fv.launch_counts, dev, [u, q, u.clone(), q.clone(), f, w, sc,
                                       partial, u.new_empty(4, 16, 16)],
               9, 16, 16, 2, 2, 0, 2, *_vol_mc_consts(9, 16, 16))


# ---------------------------------------------------------------------------
# rows 2 and 1: the ROF chunk and multichunk grid-resident
# ---------------------------------------------------------------------------

def _rof_planes(seed, nx, ny, dev):
    """x, q (with mass on the dead dual coordinates), f and wsquare's w."""
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(nx, ny), 0.3 * rng.randn(2, nx, ny), rng.rand(nx, ny),
            2.0 * (rng.rand(nx, ny) > 0.3))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("count", [1, 10])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny", [(512, 512), (250, 190), (13, 40),
                                   (7, 300)])
def test_rof_resident_is_the_launch_sequence(dev, nx, ny, dataterm, count):
    """The resident chunk's planes, previous iterates and squared norms
    bit-equal to the launch sequence's, one launch each (13 and 7 rows:
    most of the bands empty)."""
    planes = _rof_planes(300 + nx + count, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    before = fr.launch_counts["rof_chunk"]
    _bit_equal(_both_paths(fr.rof_chunk_, planes[:2], planes[2:], scal,
                           count, dataterm))
    assert fr.launch_counts["rof_chunk"] == before + 2


def _rof_mc_scal(tol, dev, tau=0.9, sigma=1.1, conv=None):
    return torch.tensor([tau, sigma, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0]
                        + [tol] * 4 + ([conv] if conv is not None else []),
                        device=dev)


def _rof_mc_consts(nx, ny):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 1.5, 0.95,
            1.05, 0.8)


def _both_rof_multichunks(x, q, f, w, scal, count, k_chunks, dataterm,
                          stepsize):
    """``rof_multichunk_`` by the launch sequence and by the resident
    launch from the same inputs: planes, previous iterates, norms and sout
    of each, one launch each."""
    nx, ny = x.shape
    out = {}
    for path in ("streaming", "resident"):
        cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
        before = fr.launch_counts["rof_multichunk"]
        norms, sout = fr.rof_multichunk_(*cur, *prev, f, w, scal, count,
                                         k_chunks, dataterm, stepsize,
                                         _rof_mc_consts(nx, ny), path=path)
        assert fr.launch_counts["rof_multichunk"] == before + 1
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["alg1", "boyd", "goldstein"])
@pytest.mark.parametrize("nx,ny,ri,dataterm", [
    (512, 512, 10, "square"), (512, 512, 10, "abs"),
    (512, 512, 10, "wsquare"), (250, 190, 3, "wsquare"), (9, 40, 2, "abs")])
def test_rof_multichunk_resident_is_the_launch_sequence(dev, nx, ny, ri,
                                                        dataterm, stepsize):
    """Every chunk runs (tolerance 0), from planes with mass on the dead
    dual coordinates: the resident launch's planes, previous iterates,
    norms and sout bit-equal to the launch sequence's."""
    x, q, f, w = _rof_planes(320 + ri, nx, ny, dev)
    out = _both_rof_multichunks(x, q, f, w, _rof_mc_scal(0.0, dev), ri, 8,
                                dataterm, stepsize)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert out["resident"][5][5:].tolist() == [0.0, 8.0]
    assert all(bool(torch.isfinite(t).all()) for t in out["resident"])


@pytest.mark.parametrize("nx,ny", [(512, 512), (24, 40)])
def test_rof_multichunk_resident_converging_mid_launch(dev, nx, ny):
    """From a solve's start (x = f, q = 0) boyd adapts and, at the first
    tolerance of a list at which it does, the launch converges before its
    last chunk: the whole grid leaves at the same chunk, bit-equal to the
    sequence in the planes, the previous iterates, the norms and sout."""
    f = _rof_planes(330, nx, ny, dev)[2]
    for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4):
        out = _both_rof_multichunks(f, torch.zeros((2, nx, ny), device=dev),
                                    f, f, _rof_mc_scal(tol, dev, 1.0, 1.0),
                                    10, 8, "square", "boyd")
        for a, b in zip(out["streaming"], out["resident"]):
            assert torch.equal(a, b)
        sout = out["resident"][5]
        if float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8:
            return
    pytest.fail("no tolerance converged mid-launch")


def test_rof_resident_with_the_flag_leaves_the_buffers(dev):
    x, q, f, w = _rof_planes(331, 512, 512, dev)
    cur = [x.clone(), q.clone()]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms2 = fr.rof_chunk_(*cur, *prev, f, w,
                           torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, 1.0],
                                        device=dev), 10, path="resident")
    norms, sout = fr.rof_multichunk_(*cur, *prev, f, w,
                                     _rof_mc_scal(1e-3, dev, conv=1.0), 10,
                                     8, "square", "boyd",
                                     _rof_mc_consts(512, 512),
                                     path="resident")
    torch.cuda.synchronize()
    assert not norms2.any() and not norms.any()
    assert sout[5:].tolist() == [1.0, 0.0]
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def _rof_route_match(dev, f, w, dataterm, tol):
    return {"nx": f.shape[0], "ny": f.shape[1], "f": f, "w": w,
            "dataterm": dataterm, "lmb": 16.0, "radius": 1.0,
            "lmb_t": torch.tensor(16.0, device=dev),
            "radius_t": torch.tensor(1.0, device=dev),
            "tols_t": tuple(torch.tensor(tol, device=dev) for _ in range(4)),
            "adapt_consts": _rof_mc_consts(*f.shape)}


@pytest.mark.parametrize("dataterm", ["square", "wsquare"])
def test_rof_light_calls_on_the_card(dev, dataterm):
    """``ROFChunk`` and ``ROFMultichunk`` at config 1's 512x512 take the
    resident path and leave what ``rof_chunk_`` and ``rof_multichunk_``
    leave, twice in a row from the state they left (their scalar buffers
    reused), and with the flag set nothing."""
    x, q, f, w = _rof_planes(332, 512, 512, dev)
    m = _rof_route_match(dev, f, w, dataterm, 1e-4)
    chunk = fr.ROFChunk(m, 10, dev)
    multi = fr.ROFMultichunk(m, 10, 8, "boyd", dev)
    assert chunk.resident and multi.resident
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want_cur, want_prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    for tau, conv in ((0.9, 0.0), (1.1, 0.0), (1.1, 1.0)):
        got = chunk(cur, prev, f, w, torch.tensor(tau, device=dev),
                    torch.tensor(1.1, device=dev),
                    torch.tensor(1.0, device=dev),
                    torch.tensor(conv > 0, device=dev))
        scal = torch.tensor([tau, 1.1, 1.0, 16.0, 1.0, conv], device=dev)
        want = fr.rof_chunk_(*want_cur, *want_prev, f, w, scal, 10, dataterm,
                             path="resident")
        for a, b in zip(cur + prev + [got], want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    steps = (0.9, 1.1, 1.0, 0.5, 0.0, 0.0)
    for it in (1, 81):
        got = multi(cur, prev, *(torch.tensor(v, device=dev) for v in steps),
                    torch.tensor(it, device=dev),
                    torch.tensor(False, device=dev))
        scal = torch.tensor(list(steps[:3]) + [16.0, 1.0] + list(steps[3:])
                            + [float(it)] + [1e-4] * 4 + [0.0], device=dev)
        want = fr.rof_multichunk_(*want_cur, *want_prev, f, w, scal, 10, 8,
                                  dataterm, "boyd", m["adapt_consts"],
                                  path="resident")
        for a, b in zip(cur + prev + list(got),
                        want_cur + want_prev + list(want)):
            assert torch.equal(a, b)


def test_rof_resident_rules_on_the_card(dev):
    """The card's limits send config 1's 512x512 chunk and multichunk
    (every data term) to the resident launches and the 2048x1536 and
    2048x2048 planes to the launch sequences; asking for a resident launch
    that does not fit raises, and so does the launch the C side refuses."""
    for multi in (False, True):
        limits = fr.card_limits(dev, multi)
        assert limits[0] == torch.cuda.get_device_properties(
            dev).multi_processor_count
        for dataterm in ("square", "wsquare", "abs"):
            assert fr.resident_ok(512, 512, dataterm, *limits, multi)
        for nx, ny in ((2048, 1536), (2048, 2048)):
            assert not fr.resident_ok(nx, ny, "square", *limits, multi)
    x, q, f, w = _rof_planes(333, 2048, 2048, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal, 2,
                      path="resident")
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fr.rof_multichunk_(x, q, x.clone(), q.clone(), f, w,
                           _rof_mc_scal(0.0, dev), 2, 2, "square", "boyd",
                           _rof_mc_consts(2048, 2048), path="resident")
    before = fr.launch_counts["rof_chunk"]
    fr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal, 2)
    assert fr.launch_counts["rof_chunk"] == before + 1
    lib = fr._lib()
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(4 * lib.prost_rof_num_blocks(2048, 2048))
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_rof_chunk_resident", "rof_chunk", fr.launch_counts,
               dev, [x, q, x.clone(), q.clone(), f, w, sc, partial,
                     x.new_empty(4, 2048, 2048)], 2048, 2048, 2, 0)


# ---------------------------------------------------------------------------
# rows 13 and 3: the multilabel multichunk grid-resident, and the ROF halo
# chunk on the grid-resident ROF body
# ---------------------------------------------------------------------------

def _ml_mc_scal(tol, dev, tau=0.9, sigma=1.1, conv=None):
    return torch.tensor([tau, sigma, 1.0, 0.5, 1.0, 0.5, 0.0, 0.0, 1.0]
                        + [tol] * 4 + ([conv] if conv is not None else []),
                        device=dev)


def _ml_mc_consts(L, nx, ny):
    n = nx * ny
    return (float(np.sqrt(2 * n * L + n)), float(np.sqrt(n * L)), 1.5, 0.95,
            1.05, 0.8)


def _both_ml_multichunks(u, q, s, f, scal, count, k_chunks, stepsize):
    """``ml_multichunk_`` by the launch sequence and by the resident launch
    from the same inputs: planes, previous iterates, norms and sout of
    each, one launch each."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    L, nx, ny = u.shape
    out = {}
    for path in ("streaming", "resident"):
        cur = [u.clone(), q.clone(), s.clone()]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        before = fm.launch_counts["ml_multichunk"]
        norms, sout = fm.ml_multichunk_(*cur, *prev, f, scal, count,
                                        k_chunks, stepsize,
                                        _ml_mc_consts(L, nx, ny), path=path)
        assert fm.launch_counts["ml_multichunk"] == before + 1
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
@pytest.mark.parametrize("L,nx,ny,ri", [(8, 256, 256, 10), (5, 250, 190, 3),
                                        (1, 9, 40, 2), (3, 300, 33, 1)])
def test_ml_multichunk_resident_is_the_launch_sequence(dev, L, nx, ny, ri,
                                                       stepsize):
    """Every chunk runs (tolerance 0), from planes with mass on the dead
    dual coordinates: the resident launch's planes, previous iterates,
    norms and sout bit-equal to the launch sequence's."""
    u, q, s, f = _ml_planes(340 + L + ri, L, nx, ny, dev)
    out = _both_ml_multichunks(u, q, s, f, _ml_mc_scal(0.0, dev), ri, 8,
                               stepsize)
    for a, b in zip(out["streaming"], out["resident"]):
        assert torch.equal(a, b)
    assert out["resident"][7][5:].tolist() == [0.0, 8.0]
    assert all(bool(torch.isfinite(t).all()) for t in out["resident"])


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
@pytest.mark.parametrize("nx,ny", [(256, 256), (24, 40)])
def test_ml_multichunk_resident_converging_mid_launch(dev, nx, ny, stepsize):
    """From a solve's start (u = q = s = 0) the rule adapts and, at the
    first tolerance of a list at which it does, the launch converges before
    its last chunk: the whole grid leaves at the same chunk, bit-equal to
    the sequence in the planes, the previous iterates, the norms and
    sout."""
    f = _ml_planes(350, 8, nx, ny, dev)[3]
    zeros = [torch.zeros((8, nx, ny), device=dev),
             torch.zeros((16, nx, ny), device=dev),
             torch.zeros((nx, ny), device=dev)]
    for tol in (5e-2, 2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4):
        out = _both_ml_multichunks(*zeros, f,
                                   _ml_mc_scal(tol, dev, 1.0, 1.0), 10, 8,
                                   stepsize)
        for a, b in zip(out["streaming"], out["resident"]):
            assert torch.equal(a, b)
        sout = out["resident"][7]
        if float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8:
            return
    pytest.fail("no tolerance converged mid-launch")


def test_ml_multichunk_resident_with_the_flag_leaves_the_buffers(dev):
    from prost_tpu_torch.ops import fused_multilabel as fm

    u, q, s, f = _ml_planes(351, 8, 256, 256, dev)
    cur = [u.clone(), q.clone(), s.clone()]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms, sout = fm.ml_multichunk_(*cur, *prev, f,
                                    _ml_mc_scal(1e-3, dev, conv=1.0), 10, 8,
                                    "boyd", _ml_mc_consts(8, 256, 256),
                                    path="resident")
    torch.cuda.synchronize()
    assert not norms.any() and sout[5:].tolist() == [1.0, 0.0]
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def test_ml_multichunk_light_call_on_the_card(dev):
    """``MLMultichunk`` at config 3's 256x256x8 takes the resident path and
    leaves what ``ml_multichunk_`` leaves, twice in a row from the state it
    left (its scalar buffer reused)."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    u, q, s, f = _ml_planes(352, 8, 256, 256, dev)
    consts = _ml_mc_consts(8, 256, 256)
    m = {"L": 8, "nx": 256, "ny": 256, "f": f,
         "radius_t": torch.tensor(0.5, device=dev),
         "d_s_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(1e-4, device=dev) for _ in range(4)),
         "adapt_consts": consts}
    call = fm.MLMultichunk(m, 10, 8, "boyd", dev)
    assert call.resident
    cur = [u.clone(), q.clone(), s.clone()]
    prev = [t.clone() for t in cur]
    want_cur, want_prev = [t.clone() for t in cur], [t.clone() for t in cur]
    steps = (0.9, 1.1, 1.0, 0.5, 0.0, 0.0)
    for it in (1, 81):
        got = call(cur, prev, *(torch.tensor(v, device=dev) for v in steps),
                   torch.tensor(it, device=dev),
                   torch.tensor(False, device=dev))
        scal = torch.tensor(list(steps[:3]) + [0.5, 1.0] + list(steps[3:])
                            + [float(it)] + [1e-4] * 4 + [0.0], device=dev)
        want = fm.ml_multichunk_(*want_cur, *want_prev, f, scal, 10, 8,
                                 "boyd", consts, path="resident")
        for a, b in zip(cur + prev + list(got),
                        want_cur + want_prev + list(want)):
            assert torch.equal(a, b)


def test_ml_multichunk_rules_on_the_card(dev):
    """The card's limits send config 3's 256x256x8 multichunk and the
    ragged 250x190x5 to the resident launch and 512x512x8 to the launch
    sequence; asking for a resident launch that does not fit raises, and
    so does the launch the C side refuses (9 labels)."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    limits = fm.card_limits(dev, 8, multi=True)
    assert limits[0] == torch.cuda.get_device_properties(
        dev).multi_processor_count
    assert fm.resident_ok(8, 256, 256, *limits, multi=True)
    assert fm.resident_ok(5, 250, 190, *fm.card_limits(dev, 5, multi=True),
                          multi=True)
    assert not fm.resident_ok(8, 512, 512, *limits, multi=True)
    u, q, s, f = _ml_planes(353, 8, 512, 512, dev)
    args = (f, _ml_mc_scal(0.0, dev), 2, 2, "boyd",
            _ml_mc_consts(8, 512, 512))
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fm.ml_multichunk_(u, q, s, u.clone(), q.clone(), s.clone(), *args,
                          path="resident")
    before = fm.launch_counts["ml_multichunk"]
    fm.ml_multichunk_(u, q, s, u.clone(), q.clone(), s.clone(), *args)
    assert fm.launch_counts["ml_multichunk"] == before + 1
    lib = fm._lib()
    u, q, s, f = _ml_planes(354, 9, 16, 16, dev)
    sc = scalar_buffer(_ml_mc_scal(0.0, dev), 13, S_CONV, S_LEN)
    partial = u.new_empty(4 * lib.prost_ml_num_blocks(16, 16))
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_ml_multichunk_resident", "ml_multichunk",
               fm.launch_counts, dev, [u, q, s, u.clone(), q.clone(),
                                       s.clone(), f, sc, partial,
                                       u.new_empty(4, 16, 16)],
               9, 16, 16, 1.0 / 9, (1.0 / 9) ** 0.5, 2, 2, 2,
               *_ml_mc_consts(9, 16, 16))


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_rof_halo_resident_is_the_launch_sequence(dev, shards, dataterm):
    """Config 1's 512x512 cut into bands (ri 10, halo 22): every band's
    resident launch is its streaming sequence, bit for bit in the planes,
    the previous iterates and the owned-row norms; its owned rows are the
    whole-plane resident chunk's, bit for bit."""
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _rof_planes(360, 512, 512, dev)
    ri, rows = 10, 512 // shards
    H = 2 * ri + 2
    head = [0.9, 1.1, 1.0, 8.0, 1.0]
    whole = [t.clone() for t in planes[:2]]
    wprev = [torch.empty_like(t) for t in whole]
    fr.rof_chunk_(*whole, *wprev, *planes[2:], torch.tensor(head, device=dev),
                  ri, dataterm, path="resident")
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor(head + [lo, H, H + rows], device=dev)
        before = fr.launch_counts["rof_chunk_halo"]
        out = _both_paths(fr.rof_chunk_halo_, ext[:2], ext[2:], scal, ri,
                          512, dataterm)
        assert fr.launch_counts["rof_chunk_halo"] == before + 2
        _bit_equal(out)
        for a, b in zip(out["resident"][:4], whole + wprev):
            assert torch.equal(a[..., H:H + rows, :],
                               b[..., rank * rows:(rank + 1) * rows, :])


def test_rof_chunk_band_light_call_on_the_card(dev):
    """``ROFChunk`` on config 1's one-shard band (556 rows) takes the
    resident path and leaves what ``rof_chunk_halo_`` leaves, twice in a
    row from the state it left, and with the flag set nothing."""
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _rof_planes(361, 512, 512, dev)
    H = 22
    ext = [window(a, -H, 512 + H) for a in planes]
    m = {"nx": 512, "ny": 512, "dataterm": "square", "lmb": 8.0,
         "radius": 1.0}
    call = fr.ROFChunk(m, 10, dev, (512, 512 + 2 * H, -H, H, H + 512))
    assert call.resident
    cur, prev = [t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]]
    want_cur, want_prev = ([t.clone() for t in ext[:2]] for _ in range(2))
    for tau, conv in ((0.9, 0.0), (1.1, 0.0), (1.1, 1.0)):
        got = call(cur, prev, *ext[2:], torch.tensor(tau, device=dev),
                   torch.tensor(1.1, device=dev),
                   torch.tensor(1.0, device=dev),
                   torch.tensor(conv > 0, device=dev))
        scal = torch.tensor([tau, 1.1, 1.0, 8.0, 1.0, -H, H, H + 512, conv],
                            device=dev)
        want = fr.rof_chunk_halo_(*want_cur, *want_prev, *ext[2:], scal, 10,
                                  512, path="resident")
        for a, b in zip(cur + prev + [got], want_cur + want_prev + [want]):
            assert torch.equal(a, b)


def test_rof_halo_rules_on_the_card(dev):
    """The card's limits send config 1's bands of 1, 2 and 4 shards (556,
    300 and 172 rows) to the resident launch and the one-shard band of a
    2048-wide plane (2092 rows) to the launch sequence, where asking for
    the resident launch raises."""
    from prost_tpu_torch.parallel.spatial_fused import window

    limits = fr.card_limits(dev)
    for rows in (556, 300, 172):
        for dataterm in ("square", "wsquare", "abs"):
            assert fr.resident_ok(rows, 512, dataterm, *limits)
    assert not fr.resident_ok(2092, 2048, "square", *limits)
    planes = _rof_planes(362, 2048, 2048, dev)
    ext = [window(a, -22, 2048 + 22) for a in planes]
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, -22, 22, 2070],
                        device=dev)
    with pytest.raises(ptt.ProstError, match="do not fit"):
        fr.rof_chunk_halo_(*ext[:2], ext[0].clone(), ext[1].clone(),
                           *ext[2:], scal, 2, 2048, path="resident")
    before = fr.launch_counts["rof_chunk_halo"]
    fr.rof_chunk_halo_(*ext[:2], ext[0].clone(), ext[1].clone(), *ext[2:],
                       scal, 2, 2048)
    assert fr.launch_counts["rof_chunk_halo"] == before + 1


# ---------------------------------------------------------------------------
# row 21: the batched tight chunk grid-resident, its instances side by side
# (-k tight_batched)
# ---------------------------------------------------------------------------

def _tight_batch(seed, B, L, nx, ny, dev, flags=None):
    """A route's flat rows x (B, (L + 2k) n) and y (B, (2L + 2k + 1) n),
    f (B, L, nx, ny) and the (5, B) (+ flags) scalar rows on the card, the
    example's taps and constants, and k."""
    _, taps, consts = _tight_case(seed, L, 2, 2, dev)
    k = L * (L - 1) // 2
    n = nx * ny
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.rand(B, L * n), 0.1 * rng.randn(B, 2 * k * n)],
                       1)
    y = np.concatenate([0.2 * rng.randn(B, 2 * L * n),
                        0.1 * rng.randn(B, 2 * k * n),
                        0.1 * rng.randn(B, n)], 1)
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            0.7 * (0.5 + rng.rand(B)), np.ones(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    arrs = [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, y, rng.rand(B, L, nx, ny), np.array(rows))]
    return (*arrs, taps, consts, k)


def _tight_views(x, y, L, k, nx, ny):
    """(u, v, q, p, s) views of the flat rows."""
    B, n = x.shape[0], nx * ny
    nL, nk2 = L * n, 2 * k * n
    return (x[:, :nL].view(B, L, nx, ny), x[:, nL:].view(B, 2 * k, nx, ny),
            y[:, :2 * nL].view(B, 2 * L, nx, ny),
            y[:, 2 * nL:2 * nL + nk2].view(B, 2 * k, nx, ny),
            y[:, 2 * nL + nk2:].view(B, nx, ny))


def _finishes(seconds):
    """Fail unless the work queued on the current stream finishes within
    ``seconds`` (a grid barrier that some block never reaches would hang
    the launch)."""
    import time

    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > seconds:
            pytest.fail(f"the launch did not finish within {seconds} s")
        time.sleep(0.001)


@pytest.mark.parametrize("B,L,nx,ny,ri,flags", [
    (8, 4, 128, 128, 10, None),                  # tight8x128x4
    (8, 4, 128, 128, 10, [0, 1, 0, 0, 1, 1, 0, 0]),
    (3, 3, 250, 190, 3, None),                   # ragged
    (3, 3, 250, 190, 10, [0, 1, 0]),
    (2, 4, 128, 128, 10, None),                  # B = 2
    (2, 2, 9, 40, 2, [1, 0]),                    # empty bands
    (1, 4, 128, 128, 1, None)])                  # B = 1, count 1
def test_tight_batched_resident_is_streaming_and_each_instance(
        dev, B, L, nx, ny, ri, flags):
    """``tight_chunk_batched_`` in place on a route's views: the resident
    launch against the streaming sequence from the same inputs, and each
    instance against ``tight_chunk_`` on it alone, bit for bit in the
    state, the previous iterate and the norms; a flagged instance's buffers
    untouched and its norms zero; one launch per call."""
    from prost_tpu_torch.ops import fused_tight as ft

    x, y, f, scal, taps, consts, k = _tight_batch(200 + B + L, B, L, nx, ny,
                                                  dev, flags)
    got = {}
    for path in ("streaming", "resident"):
        cur = [x.clone(), y.clone()]
        prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
        before = ft.launch_counts["tight_chunk_batched"]
        norms2 = ft.tight_chunk_batched_(
            *_tight_views(*cur, L, k, nx, ny),
            *_tight_views(*prev, L, k, nx, ny), f, scal, ri, taps, consts,
            path=path).clone()
        assert ft.launch_counts["tight_chunk_batched"] == before + 1
        got[path] = cur + prev + [norms2]
    torch.cuda.synchronize()
    for a, b in zip(got["streaming"], got["resident"]):
        assert torch.equal(a, b)
    res = got["resident"]
    views = _tight_views(res[0], res[1], L, k, nx, ny) + _tight_views(
        res[2], res[3], L, k, nx, ny)
    ins = _tight_views(x, y, L, k, nx, ny)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(views[:5], ins):
                assert torch.equal(a[b], i[b])
            for a in views[5:]:
                assert torch.all(a[b] == 7.0)
            assert not res[4][:, b].any()
            continue
        cur = [t[b].clone() for t in ins]
        prev = [torch.empty_like(t) for t in cur]
        norms = ft.tight_chunk_(*cur, *prev, f[b], scal[:5, b], ri, taps,
                                consts)
        for a, c in zip(views, cur + prev):
            assert torch.equal(a[b], c)
        assert torch.equal(res[4][:, b], norms)
    assert all(bool(torch.isfinite(t).all()) for t in res)


@pytest.mark.parametrize("flags", [[1, 0, 1, 1, 0, 1, 1, 1],
                                   [1, 1, 1, 1, 1, 1, 1, 0],
                                   [1] * 8])
def test_tight_batched_resident_mixed_flags_finish(dev, flags):
    """The resident launch at 8 instances of 128x128x4 with flags set on
    some or all of them finishes within 20 s (a flagged instance's blocks
    pass every grid barrier; all flagged, the grid leaves at once), and
    leaves the flagged instances' buffers as they were."""
    from prost_tpu_torch.ops import fused_tight as ft

    B, L, n = 8, 4, 128
    x, y, f, scal, taps, consts, k = _tight_batch(210, B, L, n, n, dev,
                                                  flags)
    cur = [x.clone(), y.clone()]
    prev = [torch.full_like(x, 7.0), torch.full_like(y, 7.0)]
    norms2 = ft.tight_chunk_batched_(*_tight_views(*cur, L, k, n, n),
                                     *_tight_views(*prev, L, k, n, n), f,
                                     scal, 10, taps, consts, path="resident")
    _finishes(20.0)
    for b in range(B):
        flagged = bool(flags[b])
        assert torch.equal(cur[0][b], x[b]) is flagged
        assert torch.equal(cur[1][b], y[b]) is flagged
        assert bool(torch.all(prev[0][b] == 7.0)) is flagged
        assert bool(norms2[:, b].any()) is not flagged


def test_tight_batched_light_call_on_the_card(dev):
    """``TightBatchedChunk`` at 8 instances of 128x128x4 takes the resident
    path and leaves what ``tight_chunk_batched_`` leaves, twice in a row;
    with the flag set it changes nothing."""
    from prost_tpu_torch.ops import fused_tight as ft

    B, L, n = 8, 4, 128
    x, y, f, scal, taps, consts, k = _tight_batch(211, B, L, n, n, dev)
    m = {"L": L, "k": k, "nx": n, "ny": n, "taps": taps, "consts": consts,
         "radius": scal[3], "d_s": scal[4]}
    call = ft.TightBatchedChunk(m, B, 10, dev)
    assert call.resident
    cur, prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    want_cur, want_prev = [x.clone(), y.clone()], [x.clone(), y.clone()]
    full = torch.cat([scal, torch.zeros(1, B, device=dev)])
    for _ in range(2):
        norms2 = call(_tight_views(*cur, L, k, n, n),
                      _tight_views(*prev, L, k, n, n), f, scal[0], scal[1],
                      scal[2], torch.tensor(False, device=dev))
        want = ft.tight_chunk_batched_(*_tight_views(*want_cur, L, k, n, n),
                                       *_tight_views(*want_prev, L, k, n, n),
                                       f, full, 10, taps, consts,
                                       path="resident")
        for a, b in zip(cur + prev + [norms2],
                        want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    held = [t.clone() for t in cur + prev]
    norms2 = call(_tight_views(*cur, L, k, n, n),
                  _tight_views(*prev, L, k, n, n), f, scal[0], scal[1],
                  scal[2], torch.tensor(True, device=dev))
    _finishes(20.0)
    assert not norms2.any()
    for a, b in zip(cur + prev, held):
        assert torch.equal(a, b)


def test_tight_batched_rules_on_the_card(dev):
    """The card's limits send 8 instances of 128x128x4, 3 of 250x190x3 and
    2 of 128x128x4 to the resident launch and 16 of 128x128x4 and more
    instances than SMs to the streaming sequence, where asking for the
    resident launch raises; the launch the C side refuses (more instances
    than SMs) raises."""
    from prost_tpu_torch.ops import fused_tight as ft

    sms, smem = ft.card_limits(dev, True)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    assert ft.resident_ok(4, 6, 24, 128, 128, sms, smem, batch=8)
    assert ft.resident_ok(4, 6, 24, 128, 128, sms, smem, batch=2)
    assert ft.resident_ok(3, 3, 12, 250, 190, sms, smem, batch=3)
    assert not ft.resident_ok(4, 6, 24, 128, 128, sms, smem, batch=16)
    assert not ft.resident_ok(2, 1, 2, 4, 4, sms, smem, batch=sms + 1)
    for B, L, nx in ((16, 4, 128), (sms + 1, 2, 4)):
        x, y, f, scal, taps, consts, k = _tight_batch(212, B, L, nx, nx, dev)
        views = _tight_views(x, y, L, k, nx, nx)
        prev = _tight_views(x.clone(), y.clone(), L, k, nx, nx)
        with pytest.raises(ptt.ProstError, match="do not fit"):
            ft.tight_chunk_batched_(*views, *prev, f, scal, 2, taps, consts,
                                    path="resident")
        before = ft.launch_counts["tight_chunk_batched"]
        ft.tight_chunk_batched_(*views, *prev, f, scal, 2, taps, consts)
        assert ft.launch_counts["tight_chunk_batched"] == before + 1
    # the C side refuses more instances than SMs
    lib = ft._lib()
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(4 * B * lib.prost_tight_num_blocks(nx, nx))
    carried = ft._scratch(True, L, nx, nx, dev, B)
    kron = ft.kron_array(tuple(taps), L, k, dev)
    n = nx * nx
    X, Y = (L + 2 * k) * n, (2 * L + 2 * k + 1) * n
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_tight_chunk_batched_resident",
               "tight_chunk_batched", ft.launch_counts, dev,
               [*views, *prev, *carried[:4], f, kron, sc, partial,
                carried[4]], L, k, nx, nx, len(taps),
               *ft._consts10(consts), X, X, Y, Y, Y, 2, B)


# ---------------------------------------------------------------------------
# rows 6 and 5: the ROF chunk and multichunk tiled, for the planes no
# grid-resident band holds (-k tiled)
# ---------------------------------------------------------------------------

def _tiled_paths(fn, state, data, *args, **kw):
    """``fn`` (an in-place ROF chunk) on copies of ``state`` by the
    streaming sequence and by the tiled launch: {path: (state, prev,
    norms2)}, one launch each."""
    out = {}
    for path in ("streaming", "tiled"):
        cur = [t.clone() for t in state]
        prev = [torch.full_like(t, float("nan")) for t in state]
        out[path] = cur + prev + [fn(*cur, *prev, *data, *args, path=path,
                                     **kw).clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("count", [1, 10])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny", [(2048, 2048), (2048, 1536), (1000, 777),
                                   (70, 53), (9, 300)])
def test_rof_tiled_is_the_launch_sequence(dev, nx, ny, dataterm, count):
    """The tiled chunk's planes, previous iterates and squared norms
    bit-equal to the launch sequence's, from planes with mass on the dead
    dual coordinates (1000x777, 70x53, 9x300: tiles that do not divide
    the plane)."""
    planes = _rof_planes(400 + nx + count, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    before = fr.launch_counts["rof_chunk"]
    out = _tiled_paths(fr.rof_chunk_, planes[:2], planes[2:], scal, count,
                       dataterm)
    assert fr.launch_counts["rof_chunk"] == before + 2
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert bool((out["tiled"][-1] > 0).all())


@pytest.mark.parametrize("dataterm", ["square", "wsquare"])
@pytest.mark.parametrize("rank,shards", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_rof_tiled_halo_is_the_launch_sequence(dev, rank, shards, dataterm):
    """2048x2048 cut into bands (ri 10, halo 22; one shard's band is 2092
    rows): every band's tiled launch is its streaming sequence, bit for bit
    in the planes, the previous iterates and the owned-row norms."""
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _rof_planes(410 + rank, 2048, 2048, dev)
    ri, rows, H = 10, 2048 // shards, 22
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, lo, H, H + rows],
                        device=dev)
    out = _tiled_paths(fr.rof_chunk_halo_, ext[:2], ext[2:], scal, ri, 2048,
                       dataterm)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [(8, 32), (64, 64), (160, 32), (16, 160)])
def test_rof_tiled_any_tile_is_the_launch_sequence(dev, tile):
    """The launch with tiles other than the rule's (thin, square, tall,
    wide) gives the same bits: the halo, not the tile, keeps a window
    exact."""
    planes = _rof_planes(420, 700, 500, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    lib = fr._lib()
    out = {}
    for path in ("streaming", "tiled"):
        cur = [t.clone() for t in planes[:2]]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
        partial = cur[0].new_empty(4 * lib.prost_rof_num_blocks(700, 500))
        route = (path, tile if path == "tiled" else None)
        fr._launch_chunk("rof_chunk", cur, prev, *planes[2:], sc, partial,
                         fr._scratch(path, 700, 500, dev), route, 10,
                         "square")
        out[path] = cur + prev + [sc[15:19].clone()]
    torch.cuda.synchronize()
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("which", ["rule", "other"])
def test_rof_tiled_edge_and_inner_windows_are_the_launch_sequence(
        dev, which, dataterm):
    """At 1000x777 (counts 1, 3 and 10) windows touch the plane's first and
    last rows and columns, and most touch none (their stencils test
    nothing): the rule's tile and a wide one (48x128) give the streaming
    sequence's bits; so does the deepest chunk that tiles (47 iterations,
    40 with wsquare: an 8x32 tile's window of 103x127 or 89x113 pixels)."""
    planes = _rof_planes(445, 1000, 777, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    lib = fr._lib()
    sms, tsmem = fr.card_sms(dev), fr.tiled_limit(dev)
    deep = 40 if dataterm == "wsquare" else 47
    for count in (1, 3, 10, deep):
        tile = fr.tiled_tile(1000, 777, count, dataterm, sms, tsmem)
        if which == "other" and count != deep:
            tile = (48, 128)
        assert tile is not None
        out = {}
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes[:2]]
            prev = [torch.full_like(t, float("nan")) for t in cur]
            sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
            partial = cur[0].new_empty(
                4 * lib.prost_rof_num_blocks(1000, 777))
            fr._launch_chunk("rof_chunk", cur, prev, *planes[2:], sc,
                             partial, fr._scratch(path, 1000, 777, dev),
                             (path, tile if path == "tiled" else None),
                             count, dataterm)
            out[path] = cur + prev + [sc[15:19].clone()]
        torch.cuda.synchronize()
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)


def _tiled_multichunks(x, q, f, w, scal, count, k_chunks, dataterm,
                       stepsize):
    nx, ny = x.shape
    out = {}
    for path in ("streaming", "tiled"):
        cur = [x.clone(), q.clone()]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        norms, sout = fr.rof_multichunk_(*cur, *prev, f, w, scal, count,
                                         k_chunks, dataterm, stepsize,
                                         _rof_mc_consts(nx, ny), path=path)
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["alg1", "boyd", "goldstein"])
@pytest.mark.parametrize("nx,ny,ri,k,dataterm", [
    (2048, 2048, 10, 8, "square"), (2048, 1536, 10, 3, "wsquare"),
    (1000, 777, 3, 5, "abs"), (70, 53, 2, 3, "square")])
def test_rof_multichunk_tiled_is_the_launch_sequence(dev, nx, ny, ri, k,
                                                     dataterm, stepsize):
    """Every chunk runs (tolerance 0), an even and an odd number of them:
    the tiled launches' planes, previous iterates, norms and sout bit-equal
    to the launch sequence's."""
    x, q, f, w = _rof_planes(430 + ri, nx, ny, dev)
    out = _tiled_multichunks(x, q, f, w, _rof_mc_scal(0.0, dev), ri, k,
                             dataterm, stepsize)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert out["tiled"][5][5:].tolist() == [0.0, float(k)]


@pytest.mark.parametrize("nx,ny", [(2048, 2048), (300, 257)])
def test_rof_multichunk_tiled_converging_mid_launch(dev, nx, ny):
    """From a solve's start (x = f, q = 0) boyd converges partway through
    the launch, after an odd and after an even number of chunks at two
    tolerances of a list: bit-equal to the sequence each time, the result
    copied back where the scratch holds it."""
    f = _rof_planes(440, nx, ny, dev)[2]
    parity = set()
    for tol in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4):
        out = _tiled_multichunks(f, torch.zeros((2, nx, ny), device=dev), f,
                                 f, _rof_mc_scal(tol, dev, 1.0, 1.0), 10, 8,
                                 "square", "boyd")
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        sout = out["tiled"][5]
        if float(sout[5]) == 1.0 and 1 <= float(sout[6]) < 8:
            parity.add(int(sout[6]) % 2)
    assert parity, "no tolerance converged mid-launch"


def test_rof_tiled_with_the_flag_leaves_the_buffers(dev):
    x, q, f, w = _rof_planes(441, 2048, 1536, dev)
    cur = [x.clone(), q.clone()]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms2 = fr.rof_chunk_(*cur, *prev, f, w,
                           torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, 1.0],
                                        device=dev), 10, path="tiled")
    norms, sout = fr.rof_multichunk_(*cur, *prev, f, w,
                                     _rof_mc_scal(1e-3, dev, conv=1.0), 10,
                                     8, "square", "boyd",
                                     _rof_mc_consts(2048, 1536),
                                     path="tiled")
    torch.cuda.synchronize()
    assert not norms2.any() and not norms.any()
    assert sout[5:].tolist() == [1.0, 0.0]
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dataterm", ["square", "wsquare"])
def test_rof_tiled_light_calls_on_the_card(dev, dataterm):
    """``ROFChunk`` and ``ROFMultichunk`` at 2048x2048 take the tiled path
    and leave in the run's own planes what ``rof_chunk_`` and
    ``rof_multichunk_`` leave, twice in a row from the state they left,
    and with the flag set nothing."""
    x, q, f, w = _rof_planes(442, 2048, 2048, dev)
    m = _rof_route_match(dev, f, w, dataterm, 1e-4)
    chunk = fr.ROFChunk(m, 10, dev)
    multi = fr.ROFMultichunk(m, 10, 8, "boyd", dev)
    assert chunk.route[0] == multi.route[0] == "tiled"
    assert not chunk.resident and not multi.resident
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want_cur, want_prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    for tau, conv in ((0.9, 0.0), (1.1, 0.0), (1.1, 1.0)):
        got = chunk(cur, prev, f, w, torch.tensor(tau, device=dev),
                    torch.tensor(1.1, device=dev),
                    torch.tensor(1.0, device=dev),
                    torch.tensor(conv > 0, device=dev))
        scal = torch.tensor([tau, 1.1, 1.0, 16.0, 1.0, conv], device=dev)
        want = fr.rof_chunk_(*want_cur, *want_prev, f, w, scal, 10, dataterm,
                             path="streaming")
        for a, b in zip(cur + prev + [got], want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    steps = (0.9, 1.1, 1.0, 0.5, 0.0, 0.0)
    for it in (1, 81):
        got = multi(cur, prev, *(torch.tensor(v, device=dev) for v in steps),
                    torch.tensor(it, device=dev),
                    torch.tensor(False, device=dev))
        scal = torch.tensor(list(steps[:3]) + [16.0, 1.0] + list(steps[3:])
                            + [float(it)] + [1e-4] * 4 + [0.0], device=dev)
        want = fr.rof_multichunk_(*want_cur, *want_prev, f, w, scal, 10, 8,
                                  dataterm, "boyd", m["adapt_consts"],
                                  path="streaming")
        for a, b in zip(cur + prev + list(got),
                        want_cur + want_prev + list(want)):
            assert torch.equal(a, b)


def test_rof_tiled_rules_on_the_card(dev):
    """The card's limits send the 2048x2048 and 2048x1536 chunks and
    multichunks and the 2092-row band to the tiled launch; a chunk of 41
    iterations with wsquare, whose halo no window holds, streams; asking
    for the tiled launch there raises, and so does a tile the C side
    refuses (not whole 32x8 norm tiles; a window beyond the shared memory;
    a window whose thread map needs more warps than a block has)."""
    sms, tsmem = fr.card_sms(dev), fr.tiled_limit(dev)
    assert tsmem >= 227 * 1024
    for multi in (False, True):
        limits = fr.card_limits(dev, multi)
        for nx, ny in ((2048, 1536), (2048, 2048), (2092, 2048)):
            assert fr.route_of(nx, ny, "wsquare", 10, *limits, tsmem,
                               multi) == "tiled"
    assert fr.route_of(2048, 2048, "wsquare", 41, *fr.card_limits(dev),
                       tsmem) == "streaming"
    x, q, f, w = _rof_planes(443, 2048, 2048, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="no tile"):
        fr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal, 41,
                      dataterm="wsquare", path="tiled")
    lib = fr._lib()
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(4 * lib.prost_rof_num_blocks(2048, 2048))
    # not 8x32 tiles; too big; a map of 3 x 11 warps; a window wider than
    # the map's 6 blocks of 32 columns
    for tile in ((12, 32), (8, 48), (256, 256), (112, 64), (16, 224)):
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            launch(lib, "prost_rof_chunk_tiled", "rof_chunk",
                   fr.launch_counts, dev,
                   [x, q, x.clone(), q.clone(), f, w, sc, partial,
                    x.new_empty(3, 2048, 2048)], 2048, 2048, 0, 10, 0,
                   *tile)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# row 11: the Chebyshev ADMM chunk and multichunk tiled, for the planes no
# grid-resident band holds (-k admm_tiled)
# ---------------------------------------------------------------------------

def _admm_tiled_paths(fn, planes, data, *args):
    """``fn`` (an in-place ADMM chunk or multichunk) on copies of
    ``planes`` by the streaming sequence and by the tiled launches:
    {path: the arrays and the outputs}."""
    out = {}
    for path in ("streaming", "tiled"):
        cur = [t.clone() for t in planes]
        res = fn(*cur, *data, *args, path=path)
        res = list(res) if isinstance(res, tuple) else [res]
        out[path] = cur + [t.clone() for t in res]
    torch.cuda.synchronize()
    return out


def _admm_mscal(tol, dev, rho=1.0, conv=None):
    flag = [] if conv is None else [conv]
    return torch.tensor([rho, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0] + [tol] * 4
                        + flag, device=dev)


@pytest.mark.parametrize("count", [1, 3, 10])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny", [(2048, 2048), (1000, 777), (70, 53),
                                   (9, 300)])
def test_admm_tiled_chunk_is_the_launch_sequence(dev, nx, ny, dataterm,
                                                 count):
    """The tiled chunk's arrays and squared norms bit-equal to the launch
    sequence's, from arrays with mass on the dead z coordinates, odd counts
    (the copy back) and tiles that do not divide the plane included."""
    planes = _admm_planes(700 + count, nx, ny, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    before = fa.launch_counts["admm_chunk_tiled"]
    out = _admm_tiled_paths(fa.admm_chunk_, planes[:7], planes[7:], scal,
                            None, count, 0, 1.7, dataterm, 10)
    assert fa.launch_counts["admm_chunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in out["tiled"])


@pytest.mark.parametrize("degree", [1, 3, 25])
def test_admm_tiled_chunk_any_degree_is_the_launch_sequence(dev, degree):
    """Degrees whose halo is 2, 4 and 26 pixels, at a shape the tiles do
    not divide."""
    planes = _admm_planes(710 + degree, 300, 190, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    out = _admm_tiled_paths(fa.admm_chunk_, planes[:7], planes[7:], scal,
                            None, 3, 0, 1.7, "square", degree)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nx,ny,count,k,dataterm", [
    (2048, 2048, 10, 8, "square"), (2048, 2048, 3, 3, "wsquare"),
    (300, 190, 3, 4, "abs"), (9, 300, 10, 2, "square")])
def test_admm_tiled_multichunk_is_the_launch_sequence(dev, nx, ny, count, k,
                                                      dataterm):
    """Every chunk runs (tolerance 0): the tiled multichunk's arrays,
    norms and sout bit-equal to the launch sequence's."""
    planes = _admm_planes(720 + k, nx, ny, dev)
    before = fa.launch_counts["admm_multichunk_tiled"]
    out = _admm_tiled_paths(fa.admm_multichunk_, planes[:7], planes[7:],
                            _admm_mscal(0.0, dev, rho=1.3), count, k, 1.7,
                            10, _admm_consts(nx, ny), dataterm)
    assert fa.launch_counts["admm_multichunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert out["tiled"][8][5].item() == k


@pytest.mark.parametrize("count", [3, 10])
@pytest.mark.parametrize("nx,ny", [(2048, 2048), (300, 190)])
def test_admm_tiled_multichunk_converging_mid_launch(dev, nx, ny, count):
    """From a solve's start, at tolerances under which rho adapts chunk
    after chunk (each rescale folded into the next chunk's loads) and the
    launch converges partway: bit-equal to the launch sequence, and some
    tolerance converges partway after rho adapted twice or more."""
    planes, f = _solve_start(nx, ny, dev)
    partway = []
    for tol in (2e-2, 1e-2, 5e-3, 2e-3):
        out = _admm_tiled_paths(fa.admm_multichunk_, planes, [f, f],
                                _admm_mscal(tol, dev), count, 8, 1.7, 10,
                                _admm_consts(nx, ny), "square")
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        sout = out["tiled"][8].tolist()
        if (sout[4] == 1.0 and sout[5] < 8
                and abs(np.log(sout[0])) > 1.5 * np.log(1.05)):
            partway.append(tol)
    assert partway


def test_admm_tiled_with_the_flag_leaves_the_buffers(dev):
    """With the converged flag set at entry the tiled chunk (of a count of
    1, whose copy back then stays off, and of 3) and multichunk change
    nothing."""
    planes = _admm_planes(730, 2048, 2048, dev)
    want = [t.clone() for t in planes[:7]]
    scal = torch.tensor([1.3, 8.0, 1.0, 1.0], device=dev)
    for count in (1, 3):
        fa.admm_chunk_(*planes, scal, None, count, 0, 1.7, "square", 10,
                       path="tiled")
    norms, sout = fa.admm_multichunk_(*planes, _admm_mscal(0.0, dev,
                                                            conv=1.0),
                                      3, 4, 1.7, 10,
                                      _admm_consts(2048, 2048), "square",
                                      path="tiled")
    torch.cuda.synchronize()
    for a, b in zip(planes[:7], want):
        assert torch.equal(a, b)
    assert sout[5].item() == 0.0


def test_admm_tiled_light_calls_on_the_card(dev):
    """``ADMMChunk`` and ``ADMMMultichunk`` at 2048x2048 take the tiled
    path and leave what ``admm_chunk_`` / ``admm_multichunk_`` leave, twice
    in a row from the state they left (their buffers reused)."""
    planes, f = _solve_start(2048, 2048, dev)
    r = {"nx": 2048, "ny": 2048, "f": f, "w": f, "dataterm": "square",
         "lmb_t": torch.tensor(16.0, device=dev),
         "radius_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(1e-4, device=dev) for _ in range(4)),
         "consts": _admm_consts(2048, 2048)}
    chunk = fa.ADMMChunk(r, 3, 1.7, 10, dev)
    multi = fa.ADMMMultichunk(r, 10, 8, 1.7, 10, dev)
    assert chunk.route[0] == multi.route[0] == "tiled"
    assert not chunk.resident and not multi.resident
    cur = [t.clone() for t in planes]
    want = [t.clone() for t in planes]
    s = [torch.tensor(v, device=dev) for v in (1.0, 1.05, 0.0, 0.0)]
    for it in (0, 80):
        norms, sout = multi(cur, *s, torch.tensor(it, device=dev),
                            torch.tensor(False, device=dev))
        wn, ws = fa.admm_multichunk_(
            *want, f, f, torch.tensor([1.0, 16.0, 1.0, 1.05, 0.0, 0.0,
                                       float(it)] + [1e-4] * 4 + [0.0],
                                      device=dev),
            10, 8, 1.7, 10, r["consts"], "square", path="tiled")
        for a, b in zip(cur + [norms, sout], want + [wn, ws]):
            assert torch.equal(a, b)
        norms2 = chunk(cur, s[0], torch.tensor(False, device=dev))
        wn = fa.admm_chunk_(*want, f, f, torch.tensor([1.0, 16.0, 1.0, 0.0],
                                                      device=dev),
                            None, 3, 0, 1.7, "square", 10, path="tiled")
        for a, b in zip(cur + [norms2], want + [wn]):
            assert torch.equal(a, b)


def test_admm_tiled_rules_on_the_card(dev):
    """The card's limits send config 4's 512x512 to the grid-resident
    launches and the 2048x2048 plane (square, wsquare) to the tiled ones;
    degree 200, whose halo no window holds, streams and asking for the
    tiled launch there raises; so does a tile the C side refuses."""
    sms, smem = fa.admm_card_limits(dev)
    tsmem = fa.admm_tiled_limit(dev)
    assert tsmem >= 227 * 1024
    assert fa.admm_route_of(512, 512, "square", 10, sms, smem,
                            tsmem) == "resident"
    for dataterm in ("square", "wsquare"):
        assert fa.admm_route_of(2048, 2048, dataterm, 10, sms, smem,
                                tsmem) == "tiled"
    assert fa.admm_route_of(2048, 2048, "square", 200, sms, smem,
                            tsmem) == "streaming"
    planes = _admm_planes(740, 2048, 2048, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="no tile"):
        fa.admm_chunk_(*planes, scal, None, 10, 0, 1.7, "square", 200,
                       path="tiled")
    lib = fa._lib()
    sc = scalar_buffer(scal, 3, fa._S_CONV, fa._S_LEN)
    partial = planes[0].new_empty(4 * lib.prost_admm_num_blocks(2048, 2048))
    scratch = planes[0].new_empty(8 * 2048 * 2048)
    for tile in ((12, 32), (8, 48), (256, 256)):  # not 8x32 tiles; too big
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            launch(lib, "prost_admm_chunk_tiled", "admm_chunk",
                   fa.launch_counts, dev, [*planes, scratch, sc, partial],
                   2048, 2048, 10, 0, 10,
                   fa.ptr(fa._coeff_tensor(10, dev)), 1.7, -0.7, *tile)


def _admm_tiled_windows(nx, ny, degree, sms, smem):
    """(tile, interior windows, edge windows) of the tiled launch on
    (nx, ny) planes at ``degree`` by the rule: a window (the tile and
    degree + 1 pixels each way) is interior where it lies in the plane's
    rows [1, nx - 2] and columns [1, ny - 2] (csrc/fused_admm.cu
    admm_tiled), the others test their neighbours."""
    tx, ty = fa.admm_tiled_tile(nx, ny, degree, sms, smem)
    h = fa.admm_tiled_halo(degree)
    inner = edge = 0
    for r in range(0, nx, tx):
        for c in range(0, ny, ty):
            if (r - h >= 1 and c - h >= 1 and min(r + tx, nx) + h <= nx - 1
                    and min(c + ty, ny) + h <= ny - 1):
                inner += 1
            else:
                edge += 1
    return (tx, ty), inner, edge


@pytest.mark.parametrize("degree", [1, 3, 10, 25, 43])
@pytest.mark.parametrize("nx,ny,mix", [(2048, 2048, "both"),
                                       (1000, 777, "both"),
                                       (70, 53, "edge"), (9, 300, "edge"),
                                       (130, 1100, "both")])
def test_admm_tiled_windows_are_the_launch_sequence(dev, nx, ny, mix,
                                                    degree):
    """Interior windows (no neighbour test) and edge windows (tested by
    the pixel's place in the plane), both or edge windows only, at
    degrees whose halo is 2 to 44 pixels: the tiled chunk's arrays and
    squared norms bit-equal to the launch sequence's at an odd count."""
    sms, _ = fa.admm_card_limits(dev)
    tile, inner, edge = _admm_tiled_windows(nx, ny, degree, sms,
                                            fa.admm_tiled_limit(dev))
    assert edge > 0 and (inner > 0) == (mix == "both")
    planes = _admm_planes(750 + degree, nx, ny, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    out = _admm_tiled_paths(fa.admm_chunk_, planes[:7], planes[7:], scal,
                            None, 3, 0, 1.7, "square", degree)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in out["tiled"])


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("degree", [1, 10, 43])
@pytest.mark.parametrize("nx,ny,dataterm", [(2048, 2048, "square"),
                                            (1000, 777, "wsquare"),
                                            (70, 53, "abs")])
def test_admm_tiled_multichunk_pending_factor(dev, nx, ny, dataterm,
                                              degree, count):
    """A dual tolerance every chunk meets and delta 1.25: rho grows by
    delta after each chunk, so each later chunk's loads apply a pending
    factor of about 0.8 (1 / 1.25, then 1 / (1.25 1.01), ...) and the
    settle the last one (with a count of 1 the chunks alternate between
    the slots, and the settle copies slot B back); arrays, norms and sout
    bit-equal to the launch sequence's, and every chunk ran."""
    planes = _admm_planes(760 + degree, nx, ny, dev)
    mscal = torch.tensor([1.3, 16.0, 1.0, 1.25, 0.0, 0.0, 0.0, 0.0, 0.0,
                          0.0, 1e9], device=dev)
    out = _admm_tiled_paths(fa.admm_multichunk_, planes[:7], planes[7:],
                            mscal, count, 3, 1.7, degree,
                            _admm_consts(nx, ny), dataterm)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    sout = out["tiled"][8].tolist()
    assert sout[5] == 3 and sout[4] == 0.0
    assert abs(sout[0] - 1.3 * 1.25 * 1.25 * 1.01 * 1.25 * 1.01 ** 2) < 1e-4


def test_admm_tiled_bytes_are_what_the_launch_takes(dev):
    """The rule's mirror of the launch's shared memory (``admm_tiled_bytes``)
    equals what the C side asks for, tile by tile and degree by degree;
    the C side refuses the maps (beyond a block's warps or 6 column
    blocks) that the rule's ``admm_tiled_fits`` refuses; and the rule's
    tile at every degree it takes launches within the card's limit, up to
    degree 43."""
    lib = fa._lib()
    sms, _ = fa.admm_card_limits(dev)
    tsmem = fa.admm_tiled_limit(dev)
    for degree in (1, 3, 10, 25, 43, 44):
        for tx in range(8, 257, 24):
            for ty in range(32, 257, 32):
                got = lib.prost_admm_tiled_bytes(tx, ty, degree)
                if not fa.admm_tiled_fits(tx, ty, degree, 10 ** 9):
                    assert got == -1
                else:
                    assert got == fa.admm_tiled_bytes(tx, ty, degree)
        tile = fa.admm_tiled_tile(2048, 2048, degree, sms, tsmem)
        assert (tile is None) == (degree >= 44)
        if tile is not None:
            assert fa.admm_tiled_bytes(*tile, degree) <= tsmem
    planes = _admm_planes(770, 300, 190, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    out = _admm_tiled_paths(fa.admm_chunk_, planes[:7], planes[7:], scal,
                            None, 2, 0, 1.7, "square", 43)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# row 19: the deblur chunk tiled, for the planes no grid-resident band
# holds (-k deblur_tiled)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 3, 10])
@pytest.mark.parametrize("nx,ny,blur", [(2048, 2048, "motion"),
                                        (2048, 1536, "motion"),
                                        (1000, 777, "asym"),
                                        (70, 53, "asym"),
                                        (9, 300, "motion")])
def test_deblur_tiled_is_the_launch_sequence(dev, nx, ny, blur, count):
    """The tiled chunk's planes, previous iterates and squared norms
    bit-equal to the launch sequence's (1000x777, 70x53, 9x300: tiles that
    do not divide the yv grid; an odd count: slot B copied back)."""
    from prost_tpu_torch.ops import fused_deblur as fd

    taps, k = _blur(blur)
    planes = _deblur_planes(430 + nx + count, nx, ny, k, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    before = fd.launch_counts["deblur_chunk_tiled"]
    out = _tiled_paths(fd.deblur_chunk_, planes[:3], planes[3:], scal, count,
                       taps, 0.5, 0.2)
    assert fd.launch_counts["deblur_chunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert bool((out["tiled"][-1][:3] > 0).all())


@pytest.mark.parametrize("rank,shards", [(0, 1), (0, 4), (1, 4), (3, 4)])
def test_deblur_tiled_halo_is_the_launch_sequence(dev, rank, shards):
    """Config 2 at 2048x2048 cut into bands of its 2056-row yv grid (ri
    10, halo 154): every band's tiled launch is its streaming sequence, bit
    for bit in the planes, the previous iterates and the owned-row
    norms."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.parallel.spatial_fused import window

    taps, k = _blur("motion")
    planes = _deblur_planes(440 + rank, 2048, 2048, k, dev)
    ri, rows = 10, 2056 // shards
    H = fd.deblur_halo_rows(ri, taps)
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0, lo, H, H + rows],
                        device=dev)
    out = _tiled_paths(fd.deblur_chunk_halo_, ext[:3], ext[3:], scal, ri,
                       2048, taps, 0.5, 0.2)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [(8, 32), (64, 64), (160, 32), (16, 224)])
def test_deblur_tiled_any_tile_is_the_launch_sequence(dev, tile):
    """The launch with tiles other than the rule's gives the same bits,
    and with the flag set it leaves every buffer as it was."""
    from prost_tpu_torch.ops import fused_deblur as fd

    taps, k = _blur("motion")
    planes = _deblur_planes(450, 700, 500, k, dev)
    nx2, ny2 = planes[1].shape
    taps_t = fd.taps_array(taps, dev)
    out = {}
    for flag in (0.0, 1.0):
        scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0, flag], device=dev)
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes[:3]]
            prev = [t + 1.0 for t in cur]
            sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
            partial = cur[0].new_empty(
                4 * fd._lib().prost_deblur_num_blocks(nx2, ny2))
            route = (path, tile if path == "tiled" else None)
            fd._launch_chunk("deblur_chunk", cur, prev, *planes[3:], taps_t,
                             sc, partial,
                             fd._scratch(path, 700, 500, nx2, ny2, dev),
                             route, 10, taps, 0.5, 0.2)
            out[path] = cur + prev + [sc[15:19].clone()]
        torch.cuda.synchronize()
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        if flag:
            for a, b in zip(out["tiled"][:6], planes[:3]
                            + [t + 1.0 for t in planes[:3]]):
                assert torch.equal(a, b)


def test_deblur_tiled_rules_on_the_card(dev):
    """The card's limits send config 2's 512x512 to the grid-resident
    launch and 2048x2048 to the tiled one; a blur whose halo no window
    holds streams, and asking for the tiled launch there raises; so does a
    tile the C side refuses."""
    from prost_tpu_torch.ops import fused_deblur as fd

    taps, k = _blur("motion")
    sms, smem = fd.card_limits(dev)
    tsmem = fd.deblur_tiled_limit(dev)
    assert tsmem >= 225 * 1024
    assert fd.deblur_route_of(520, 512, 520, taps, sms, smem,
                              tsmem) == "resident"
    assert fd.deblur_route_of(2056, 2048, 2056, taps, sms, smem,
                              tsmem) == "tiled"
    wide = ((0, 0, 0.5), (50, 50, 0.5))
    assert fd.deblur_route_of(2098, 2048, 2098, wide, sms, smem,
                              tsmem) == "streaming"
    planes = _deblur_planes(460, 128, 96, 51, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="no tile"):
        fd.deblur_chunk_(*planes[:3], *[t.clone() for t in planes[:3]],
                         *planes[3:], scal, 2, wide, 0.5, 0.2, path="tiled")
    planes = _deblur_planes(461, 256, 256, k, dev)
    nx2, ny2 = planes[1].shape
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = planes[0].new_empty(
        4 * fd._lib().prost_deblur_num_blocks(nx2, ny2))
    scratch = fd._scratch("tiled", 256, 256, nx2, ny2, dev)
    for tile in ((12, 32), (8, 48), (256, 256)):  # not 8x32 tiles; too big
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            launch(fd._lib(), "prost_deblur_chunk_tiled", "deblur_chunk",
                   fd.launch_counts, dev,
                   [*planes[:3], *[t.clone() for t in planes[:3]],
                    *planes[3:], fd.taps_array(taps, dev), sc, partial,
                    *scratch], 256, 256, nx2, ny2, len(taps), 8, 0.5, 0.2,
                   0.5 ** 0.5, 0.2 ** 0.5, 0, 10, *tile, fd.host_taps(taps))


@pytest.mark.parametrize("count", [1, 2, 10])
@pytest.mark.parametrize("nx,ny,blur,inner", [(2048, 2048, "motion", True),
                                              (1000, 777, "asym", True),
                                              (9, 300, "motion", False)])
def test_deblur_tiled_windows_are_the_launch_sequence(dev, nx, ny, blur,
                                                      inner, count):
    """Interior windows (untested stencils) beside edge windows (2048x2048,
    1000x777), and edge windows only (the 9x300 strip), at counts 1, 2 and
    10: planes, previous iterates and squared norms bit-equal to the
    launch sequence's."""
    from prost_tpu_torch.ops import fused_deblur as fd

    taps, k = _blur(blur)
    planes = _deblur_planes(490 + nx + count, nx, ny, k, dev)
    nx2, ny2 = planes[1].shape
    tile = fd.deblur_tiled_tile(nx2, ny2, taps, fd.card_limits(dev)[0],
                                fd.deblur_tiled_limit(dev))
    wins = fd.deblur_tiled_windows(nx, ny, nx2, ny2, tile,
                                   fd.deblur_tiled_halo(taps))
    assert bool(wins[0]) == inner and wins[1]
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    out = _tiled_paths(fd.deblur_chunk_, planes[:3], planes[3:], scal, count,
                       taps, 0.5, 0.2)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("count", [1, 2])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_deblur_tiled_band_counts_are_the_launch_sequence(dev, rank, count):
    """Bands of config 2 at 2048x2048 cut in 4 (halo 154), the edge
    shards' with rows beyond the image, at counts 1 and 2: the tiled launch
    is the streaming sequence bit for bit."""
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.parallel.spatial_fused import window

    taps, k = _blur("motion")
    planes = _deblur_planes(500 + rank, 2048, 2048, k, dev)
    rows, H = 2056 // 4, fd.deblur_halo_rows(10, taps)
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0, lo, H, H + rows],
                        device=dev)
    out = _tiled_paths(fd.deblur_chunk_halo_, ext[:3], ext[3:], scal, count,
                       2048, taps, 0.5, 0.2)
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [5, 9])
def test_deblur_tiled_dense_blurs_take_the_rules_path(dev, k):
    """A full k x k blur (25 and 81 taps) at 1024x1024: the chunk takes the
    path ``deblur_route_of`` picks (counted as such) and leaves the
    streaming sequence's planes, previous iterates and norms bit for bit;
    the tiled launch, forced, does too."""
    from prost_tpu_torch.ops import fused_deblur as fd

    ker = np.arange(1.0, k * k + 1.0).reshape(k, k)
    taps = fd.kernel_taps(torch.as_tensor(ker / ker.sum(),
                                          dtype=torch.float32))
    assert len(taps) == k * k
    planes = _deblur_planes(510 + k, 1024, 1024, k, dev)
    nx2, ny2 = planes[1].shape
    sms, smem = fd.card_limits(dev)
    path = fd.deblur_route_of(nx2, 1024, ny2, taps, sms, smem,
                              fd.deblur_tiled_limit(dev))
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    out = {}
    for p in ("streaming", None, "tiled"):
        cur = [t.clone() for t in planes[:3]]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        before = fd.launch_counts["deblur_chunk_tiled"]
        norms2 = fd.deblur_chunk_(*cur, *prev, *planes[3:], scal, 3, taps,
                                  0.5, 0.2, path=p)
        tiled = fd.launch_counts["deblur_chunk_tiled"] - before
        assert tiled == (p == "tiled" or (p is None and path == "tiled"))
        out[p] = cur + prev + [norms2.clone()]
    torch.cuda.synchronize()
    for p in (None, "tiled"):
        for a, b in zip(out["streaming"], out[p]):
            assert torch.equal(a, b)


def test_deblur_tiled_bytes_mirror_the_launch(dev):
    """``deblur_tiled_bytes`` is the dynamic shared memory the C side asks
    for each tile and halo on the card (``prost_deblur_tiled_bytes``: two
    sets of the window's planes where they fit, else one), and the launch
    takes the largest tile whose one set fits and refuses the next row of
    tiles."""
    from prost_tpu_torch.ops import fused_deblur as fd

    lib = fd._lib()
    limit = fd.deblur_tiled_limit(dev)
    for taps in (_blur("motion")[0], _blur("asym")[0], ((0, 0, 0.5),
                                                       (20, 3, 0.5))):
        h = fd.deblur_tiled_halo(taps)
        for tile in ((8, 32), (48, 64), (104, 64), (48, 128), (136, 32),
                     (40, 160)):
            assert lib.prost_deblur_tiled_bytes(*tile, h) == \
                fd.deblur_tiled_bytes(*tile, taps, limit)
    taps, k = _blur("motion")
    tx = max(t for t in range(8, 400, 8)
             if fd.deblur_tiled_bytes(t, 64, taps, limit) <= limit)
    planes = _deblur_planes(520, 700, 500, k, dev)
    nx2, ny2 = planes[1].shape
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = planes[0].new_empty(
        4 * fd._lib().prost_deblur_num_blocks(nx2, ny2))
    scratch = fd._scratch("tiled", 700, 500, nx2, ny2, dev)
    cur = [t.clone() for t in planes[:3]]
    prev = [t.clone() for t in cur]
    args = ([*cur, *prev, *planes[3:], fd.taps_array(taps, dev), sc, partial,
             *scratch], 700, 500, nx2, ny2, len(taps), 8, 0.5, 0.2,
            0.5 ** 0.5, 0.2 ** 0.5, 0, 2)
    launch(lib, "prost_deblur_chunk_tiled", "deblur_chunk", fd.launch_counts,
           dev, *args, tx, 64, fd.host_taps(taps))
    torch.cuda.synchronize()
    with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
        launch(lib, "prost_deblur_chunk_tiled", "deblur_chunk",
               fd.launch_counts, dev, *args, tx + 8, 64, fd.host_taps(taps))


# ---------------------------------------------------------------------------
# rows 16 and 14: the multilabel chunk, its halo form and the multichunk
# tiled, for the planes no grid-resident band holds (-k ml_tiled)
# ---------------------------------------------------------------------------

ML_TILED_ARGS = [0.9, 1.1, 1.0, 0.5, 1.0]  # tau, sigma, theta, radius, d_s


@pytest.mark.parametrize("count", [1, 3, 10])
@pytest.mark.parametrize("L,nx,ny", [(8, 512, 512), (8, 512, 384),
                                     (5, 300, 211), (3, 70, 53),
                                     (8, 9, 300)])
def test_ml_tiled_is_the_launch_sequence(dev, L, nx, ny, count):
    """The tiled chunk's planes, previous iterates and squared norms
    bit-equal to the launch sequence's (300x211, 70x53, 9x300: tiles that
    do not divide the plane; an odd count: slot B copied back)."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    u, q, s, f = _ml_planes(470 + nx + count, L, nx, ny, dev)
    scal = torch.tensor(ML_TILED_ARGS, device=dev)
    before = fm.launch_counts["ml_chunk_tiled"]
    out = _tiled_paths(fm.ml_chunk_, [u, q, s], [f], scal, count)
    assert fm.launch_counts["ml_chunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert bool((out["tiled"][-1] > 0).all())


@pytest.mark.parametrize("rank,shards", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_ml_tiled_halo_is_the_launch_sequence(dev, rank, shards):
    """512x512x8 cut into bands (ri 10, halo 22 rows): every band's tiled
    launch is its streaming sequence, bit for bit in the planes, the
    previous iterates and the owned-row norms."""
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _ml_planes(480 + rank, 8, 512, 512, dev)
    ri, rows = 10, 512 // shards
    H = 2 * ri + 2
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(ML_TILED_ARGS + [lo, H, H + rows], device=dev)
    before = fm.launch_counts["ml_chunk_halo_tiled"]
    out = _tiled_paths(fm.ml_chunk_halo_, ext[:3], ext[3:], scal, ri, 512)
    assert fm.launch_counts["ml_chunk_halo_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [(8, 32), (16, 64), (40, 32), (8, 128)])
def test_ml_tiled_any_tile_is_the_launch_sequence(dev, tile):
    """The launch with tiles other than the rule's gives the same bits,
    and with the flag set it leaves every buffer as it was."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    planes = _ml_planes(490, 8, 300, 211, dev)
    out = {}
    for flag in (0.0, 1.0):
        scal = torch.tensor(ML_TILED_ARGS + [flag], device=dev)
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes[:3]]
            prev = [t + 1.0 for t in cur]
            sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
            partial = cur[0].new_empty(
                4 * fm._lib().prost_ml_num_blocks(300, 211))
            route = (path, tile if path == "tiled" else None)
            fm._launch_chunk("ml_chunk", cur, prev, planes[3], sc, partial,
                             fm._scratch(path, 8, 300, 211, dev), route, 3)
            out[path] = cur + prev + [sc[15:19].clone()]
        torch.cuda.synchronize()
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        if flag:
            for a, b in zip(out["tiled"][:6], planes[:3]
                            + [t + 1.0 for t in planes[:3]]):
                assert torch.equal(a, b)


def _ml_tiled_multichunks(planes, scal, count, k_chunks, stepsize):
    from prost_tpu_torch.ops import fused_multilabel as fm

    L, nx, ny = planes[0].shape
    out = {}
    for path in ("streaming", "tiled"):
        cur = [t.clone() for t in planes[:3]]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        norms, sout = fm.ml_multichunk_(*cur, *prev, planes[3], scal, count,
                                        k_chunks, stepsize,
                                        _ml_mc_consts(L, nx, ny), path=path)
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["alg1", "boyd", "goldstein"])
@pytest.mark.parametrize("L,nx,ny,ri,k", [(8, 512, 512, 10, 8),
                                          (5, 300, 211, 3, 5),
                                          (3, 70, 53, 3, 4)])
def test_ml_tiled_multichunk_is_the_launch_sequence(dev, L, nx, ny, ri, k,
                                                    stepsize):
    """Every chunk runs (tolerance 0), an even and an odd count: the tiled
    launches' planes, previous iterates, norms and sout bit-equal to the
    launch sequence's."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    planes = _ml_planes(500 + ri, L, nx, ny, dev)
    before = fm.launch_counts["ml_multichunk_tiled"]
    out = _ml_tiled_multichunks(planes, _ml_mc_scal(0.0, dev), ri, k,
                                stepsize)
    assert fm.launch_counts["ml_multichunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert out["tiled"][7][5:].tolist() == [0.0, float(k)]


@pytest.mark.parametrize("count", [3, 10])
def test_ml_tiled_multichunk_converging_mid_launch(dev, count):
    """From a solve's start (u = q = s = 0) boyd converges partway through
    the launch at some tolerance of a list: bit-equal to the sequence each
    time, the result copied back where the scratch holds it (an odd count,
    an odd number of chunks)."""
    planes = _ml_planes(510, 8, 512, 512, dev)
    for t in planes[:3]:
        t.zero_()
    stopped = set()
    for tol in (5e-2, 2e-2, 1e-2, 5e-3, 2e-3, 1e-3):
        out = _ml_tiled_multichunks(planes, _ml_mc_scal(tol, dev, 1.0, 1.0),
                                    count, 8, "boyd")
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        sout = out["tiled"][7]
        if float(sout[5]) == 1.0 and 1 <= float(sout[6]) < 8:
            stopped.add(int(sout[6]) % 2)
    assert stopped, "no tolerance converged mid-launch"


def test_ml_tiled_light_calls_on_the_card(dev):
    """``MLChunk`` and ``MLMultichunk`` at 512x512x8 take the tiled path by
    the shape rule, and their calls are the streaming ones' bit for bit,
    twice in a row on the same buffers."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    L, n = 8, 512
    planes = _ml_planes(520, L, n, n, dev)
    m = {"L": L, "nx": n, "ny": n, "f": planes[3], "radius": 0.5,
         "d_s": 1.0, "radius_t": torch.tensor(0.5, device=dev),
         "d_s_t": torch.tensor(1.0, device=dev),
         "tols_t": tuple(torch.tensor(1e-3, device=dev) for _ in range(4)),
         "adapt_consts": _ml_mc_consts(L, n, n)}
    assert fm.MLChunk(m, 10, dev).route[0] == "tiled"
    assert fm.MLMultichunk(m, 10, 8, "boyd", dev).route[0] == "tiled"
    s3 = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0)]
    flag = torch.tensor(False, device=dev)
    out = {}
    for path in ("streaming", "tiled"):
        call = fm.MLChunk(m, 10, dev, path=path)
        multi = fm.MLMultichunk(m, 10, 3, "boyd", dev, path=path)
        assert call.route[0] == multi.route[0] == path
        cur = [t.clone() for t in planes[:3]]
        prev = [t.clone() for t in cur]
        got = []
        for _ in range(2):
            got.append(call(cur, prev, planes[3], *s3, flag).clone())
            got += [t.clone() for t in multi(
                cur, prev, *s3, torch.tensor(0.5, device=dev),
                torch.tensor(0.0, device=dev), torch.tensor(0.0, device=dev),
                torch.tensor(1, device=dev), flag)]
        out[path] = cur + prev + got
    torch.cuda.synchronize()
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


def test_ml_tiled_rules_on_the_card(dev):
    """The card's limits send 256x256x8 to the grid-resident launch,
    512x512x8 to the tiled one and 9 labels to the streaming sequence,
    where asking for the tiled launch raises; so does a tile the C side
    refuses."""
    from prost_tpu_torch.ops import fused_multilabel as fm

    sms, smem = fm.card_limits(dev, 8)
    tsmem = fm.ml_tiled_limit(dev)
    assert tsmem >= 225 * 1024
    assert fm.ml_route_of(8, 256, 256, sms, smem, tsmem) == "resident"
    assert fm.ml_route_of(8, 512, 512, sms, smem, tsmem) == "tiled"
    assert fm.ml_route_of(9, 512, 512, sms, 0, tsmem) == "streaming"
    u, q, s, f = _ml_planes(530, 9, 64, 64, dev)
    scal = torch.tensor(ML_TILED_ARGS, device=dev)
    with pytest.raises(ptt.ProstError, match="tiled launch takes"):
        fm.ml_chunk_(u, q, s, u.clone(), q.clone(), s.clone(), f, scal, 2,
                     path="tiled")
    u, q, s, f = _ml_planes(531, 8, 256, 256, dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = u.new_empty(4 * fm._lib().prost_ml_num_blocks(256, 256))
    scratch = fm._scratch("tiled", 8, 256, 256, dev)
    for tile in ((12, 32), (8, 48), (64, 64)):  # not 8x32 tiles; too big
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            launch(fm._lib(), "prost_ml_chunk_tiled", "ml_chunk",
                   fm.launch_counts, dev,
                   [u, q, s, u.clone(), q.clone(), s.clone(), f, sc, partial,
                    *scratch], 8, 256, 256, 1.0 / 8, (1.0 / 8) ** 0.5, 10,
                   *tile)


# ---------------------------------------------------------------------------
# row 22: the tight chunk and its halo form tiled, for the planes no
# grid-resident band holds (-k tight_tiled)
# ---------------------------------------------------------------------------

TIGHT_TILED_ARGS = [0.9, 1.1, 1.0, 0.7, 1.0]  # tau, sigma, theta, radius, d_s


@pytest.mark.parametrize("count", [1, 3, 10])
@pytest.mark.parametrize("L,nx,ny", [(4, 512, 512), (4, 512, 384),
                                     (3, 250, 190), (5, 300, 211),
                                     (2, 9, 300)])
def test_tight_tiled_is_the_launch_sequence(dev, L, nx, ny, count):
    """The tiled chunk's planes, previous iterates and squared norms
    bit-equal to the launch sequence's (250x190, 300x211, 9x300: tiles
    that do not divide the plane; an odd count: slot B copied back)."""
    from prost_tpu_torch.ops import fused_tight as ft

    planes, taps, consts = _tight_case(560 + nx + count, L, nx, ny, dev)
    scal = torch.tensor(TIGHT_TILED_ARGS, device=dev)
    before = ft.launch_counts["tight_chunk_tiled"]
    out = _tiled_paths(ft.tight_chunk_, planes[:5], planes[5:], scal, count,
                       taps, consts)
    assert ft.launch_counts["tight_chunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert bool((out["tiled"][-1] > 0).all())


@pytest.mark.parametrize("rank,shards", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_tight_tiled_halo_is_the_launch_sequence(dev, rank, shards):
    """512x512x4 cut into bands (ri 10, halo 22 rows): every band's tiled
    launch is its streaming sequence, bit for bit in the planes, the
    previous iterates and the owned-row norms."""
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel.spatial_fused import window

    planes, taps, consts = _tight_case(570 + rank, 4, 512, 512, dev)
    ri, rows = 10, 512 // shards
    H = 2 * ri + 2
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(TIGHT_TILED_ARGS + [lo, H, H + rows], device=dev)
    before = ft.launch_counts["tight_chunk_halo_tiled"]
    out = _tiled_paths(ft.tight_chunk_halo_, ext[:5], ext[5:], scal, ri, 512,
                       taps, consts)
    assert ft.launch_counts["tight_chunk_halo_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [(8, 32), (16, 64), (40, 32), (8, 128)])
def test_tight_tiled_any_tile_is_the_launch_sequence(dev, tile):
    """The launch with tiles other than the rule's gives the same bits,
    and with the flag set it leaves every buffer as it was."""
    from prost_tpu_torch.ops import fused_tight as ft

    L, nx, ny = 4, 300, 211
    k = L * (L - 1) // 2
    planes, taps, consts = _tight_case(580, L, nx, ny, dev)
    kron = ft.kron_array(taps, L, k, dev)
    out = {}
    for flag in (0.0, 1.0):
        scal = torch.tensor(TIGHT_TILED_ARGS + [flag], device=dev)
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes[:5]]
            prev = [t + 1.0 for t in cur]
            sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
            partial = cur[0].new_empty(
                4 * ft._lib().prost_tight_num_blocks(nx, ny))
            route = (path, tile if path == "tiled" else None)
            ft._launch_chunk("tight_chunk", cur, prev, planes[5], kron, sc,
                             partial, ft._route_scratch(path, L, nx, ny, dev),
                             route, 3, len(taps), ft._consts10(consts))
            out[path] = cur + prev + [sc[15:19].clone()]
        torch.cuda.synchronize()
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        if flag:
            for a, b in zip(out["tiled"][:10], planes[:5]
                            + [t + 1.0 for t in planes[:5]]):
                assert torch.equal(a, b)


def test_tight_tiled_light_calls_on_the_card(dev):
    """``TightChunk`` at 512x512x4 and on its one-shard band of 556 rows
    takes the tiled path by the shape rule, and its calls are the
    streaming ones' bit for bit, twice in a row on the same buffers."""
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.parallel.spatial_fused import window

    L, n, ri, H = 4, 512, 10, 22
    planes, taps, consts = _tight_case(590, L, n, n, dev)
    m = {"L": L, "k": 6, "nx": n, "ny": n, "taps": taps, "consts": consts,
         "radius": 0.7, "d_s": 1.0}
    band = (n, n + 2 * H, -H, H, H + n)
    ext = [window(a, -H, n + H) for a in planes]
    assert ft.TightChunk(m, ri, dev).route[0] == "tiled"
    assert ft.TightChunk(m, ri, dev, band).route[0] == "tiled"
    s3 = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0)]
    flag = torch.tensor(False, device=dev)
    for state, b in ((planes, None), (ext, band)):
        out = {}
        for path in ("streaming", "tiled"):
            call = ft.TightChunk(m, ri, dev, b, path=path)
            assert call.route[0] == path
            cur = [t.clone() for t in state[:5]]
            prev = [t.clone() for t in cur]
            got = [call(cur, prev, state[5], *s3, flag).clone()
                   for _ in range(2)]
            out[path] = cur + prev + got
        torch.cuda.synchronize()
        for a, c in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, c)


def test_tight_tiled_rules_on_the_card(dev):
    """The card's limits send tight128x4 to the grid-resident launch,
    512x512x4 and its 556-row band to the tiled one and 6 labels to the
    streaming sequence, where asking for the tiled launch raises; so does
    a tile the C side refuses."""
    from prost_tpu_torch.ops import fused_tight as ft

    sms, smem = ft.card_limits(dev)
    tsmem = ft.tight_tiled_limit(dev)
    assert tsmem >= 225 * 1024
    assert ft.tight_route_of(4, 6, 24, 128, 128, sms, smem,
                             tsmem) == "resident"
    assert ft.tight_route_of(4, 6, 24, 512, 512, sms, smem, tsmem) == "tiled"
    assert ft.tight_route_of(4, 6, 24, 556, 512, sms, smem, tsmem) == "tiled"
    assert ft.tight_route_of(6, 15, 60, 512, 512, sms, smem,
                             tsmem) == "streaming"
    planes, taps, consts = _tight_case(600, 6, 64, 64, dev)
    scal = torch.tensor(TIGHT_TILED_ARGS, device=dev)
    with pytest.raises(ptt.ProstError, match="tiled launch takes"):
        ft.tight_chunk_(*planes[:5], *[t.clone() for t in planes[:5]],
                        planes[5], scal, 2, taps, consts, path="tiled")
    L, k, nx = 4, 6, 256
    planes, taps, consts = _tight_case(601, L, nx, nx, dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = planes[0].new_empty(4 * ft._lib().prost_tight_num_blocks(nx,
                                                                       nx))
    scratch = ft._route_scratch("tiled", L, nx, nx, dev)
    for tile in ((12, 32), (8, 48), (128, 128)):  # not 8x32 tiles; too big
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            ft._launch_chunk("tight_chunk", planes[:5],
                             [t.clone() for t in planes[:5]], planes[5],
                             ft.kron_array(taps, L, k, dev), sc, partial,
                             scratch, ("tiled", tile), 10, len(taps),
                             ft._consts10(consts))


# ---------------------------------------------------------------------------
# rows 28 and 27: the volumetric chunk, its halo form and the multichunk
# tiled, for the volumes no grid-resident band holds (-k vol_tiled)
# ---------------------------------------------------------------------------

VOL_TILED_ARGS = [0.9, 1.1, 1.0, 6.0, 0.5]  # tau, sigma, theta, lmb, radius


@pytest.mark.parametrize("count", [1, 3, 10])
@pytest.mark.parametrize("L,nx,ny,dataterm", [
    (8, 512, 512, "square"), (8, 512, 384, "wsquare"), (5, 300, 211, "abs"),
    (3, 70, 53, "wsquare"), (8, 9, 300, "square")])
def test_vol_tiled_is_the_launch_sequence(dev, L, nx, ny, dataterm, count):
    """The tiled chunk's volumes, previous iterates and squared norms
    bit-equal to the launch sequence's, with the three data terms
    (300x211, 70x53, 9x300: tiles that do not divide the volume; an odd
    count: slot B copied back)."""
    from prost_tpu_torch.ops import fused_vol as fv

    u, q, f, w = _vol_planes(610 + nx + count, L, nx, ny, dev)
    scal = torch.tensor(VOL_TILED_ARGS, device=dev)
    before = fv.launch_counts["vol_chunk_tiled"]
    out = _tiled_paths(fv.vol_chunk_, [u, q], [f, w], scal, count, dataterm)
    assert fv.launch_counts["vol_chunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert bool((out["tiled"][-1] > 0).all())


@pytest.mark.parametrize("rank,shards,dataterm", [
    (0, 1, "square"), (0, 2, "wsquare"), (1, 2, "square"), (2, 4, "abs")])
def test_vol_tiled_halo_is_the_launch_sequence(dev, rank, shards, dataterm):
    """512x512x8 cut into bands (ri 10, halo 22 rows): every band's tiled
    launch is its streaming sequence, bit for bit in the volumes, the
    previous iterates and the owned-row norms."""
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.parallel.spatial_fused import window

    planes = _vol_planes(620 + rank, 8, 512, 512, dev)
    ri, rows = 10, 512 // shards
    H = 2 * ri + 2
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(VOL_TILED_ARGS + [lo, H, H + rows], device=dev)
    before = fv.launch_counts["vol_chunk_halo_tiled"]
    out = _tiled_paths(fv.vol_chunk_halo_, ext[:2], ext[2:], scal, ri, 512,
                       dataterm)
    assert fv.launch_counts["vol_chunk_halo_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [(8, 32), (16, 64), (40, 32), (8, 128)])
def test_vol_tiled_any_tile_is_the_launch_sequence(dev, tile):
    """The launch with tiles other than the rule's gives the same bits,
    and with the flag set it leaves every buffer as it was."""
    from prost_tpu_torch.ops import fused_vol as fv

    L, nx, ny = 5, 300, 211
    planes = _vol_planes(630, L, nx, ny, dev)
    out = {}
    for flag in (0.0, 1.0):
        scal = torch.tensor(VOL_TILED_ARGS + [flag], device=dev)
        for path in ("streaming", "tiled"):
            cur = [t.clone() for t in planes[:2]]
            prev = [t + 1.0 for t in cur]
            sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
            partial = cur[0].new_empty(
                4 * fv._lib().prost_vol_num_blocks(nx, ny))
            route = (path, tile if path == "tiled" else None)
            fv._launch_chunk("vol_chunk", cur, prev, planes[2], planes[3],
                             sc, partial, fv._scratch(path, 0, L, nx, ny, dev),
                             route, 3, "wsquare")
            out[path] = cur + prev + [sc[15:19].clone()]
        torch.cuda.synchronize()
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        if flag:
            for a, b in zip(out["tiled"][:4], planes[:2]
                            + [t + 1.0 for t in planes[:2]]):
                assert torch.equal(a, b)


def _vol_tiled_multichunks(u, q, f, w, scal, count, k_chunks, dataterm,
                           stepsize):
    from prost_tpu_torch.ops import fused_vol as fv

    L, nx, ny = u.shape
    out = {}
    for path in ("streaming", "tiled"):
        cur = [u.clone(), q.clone()]
        prev = [torch.full_like(t, float("nan")) for t in cur]
        norms, sout = fv.vol_multichunk_(*cur, *prev, f, w, scal, count,
                                         k_chunks, dataterm, stepsize,
                                         _vol_mc_consts(L, nx, ny), path=path)
        out[path] = cur + prev + [norms.clone(), sout.clone()]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("stepsize", ["alg1", "boyd", "goldstein"])
@pytest.mark.parametrize("L,nx,ny,ri,k,dataterm", [
    (8, 512, 512, 10, 8, "square"), (5, 300, 211, 3, 5, "wsquare"),
    (3, 70, 53, 3, 4, "abs")])
def test_vol_tiled_multichunk_is_the_launch_sequence(dev, L, nx, ny, ri, k,
                                                     dataterm, stepsize):
    """Every chunk runs (tolerance 0), an even and an odd count: the tiled
    launches' volumes, previous iterates, norms and sout bit-equal to the
    launch sequence's."""
    from prost_tpu_torch.ops import fused_vol as fv

    u, q, f, w = _vol_planes(640 + ri, L, nx, ny, dev)
    before = fv.launch_counts["vol_multichunk_tiled"]
    out = _vol_tiled_multichunks(u, q, f, w, _vol_mc_scal(0.0, dev), ri, k,
                                 dataterm, stepsize)
    assert fv.launch_counts["vol_multichunk_tiled"] == before + 1
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)
    assert out["tiled"][5][5:].tolist() == [0.0, float(k)]


@pytest.mark.parametrize("count", [3, 10])
def test_vol_tiled_multichunk_converging_mid_launch(dev, count):
    """From a solve's start (u = f, q = 0) boyd converges partway through
    the launch at some tolerance of a list: bit-equal to the sequence each
    time, the result copied back where the scratch holds it (an odd count,
    an odd number of chunks)."""
    u, q, f, w = _vol_planes(650, 8, 512, 512, dev)
    q.zero_()
    stopped = set()
    for tol in (5e-2, 2e-2, 1e-2, 5e-3, 2e-3, 1e-3):
        out = _vol_tiled_multichunks(f, q, f, w,
                                     _vol_mc_scal(tol, dev, 1.0, 1.0), count,
                                     8, "square", "boyd")
        for a, b in zip(out["streaming"], out["tiled"]):
            assert torch.equal(a, b)
        sout = out["tiled"][5]
        if float(sout[5]) == 1.0 and 1 <= float(sout[6]) < 8:
            stopped.add(int(sout[6]) % 2)
    assert stopped, "no tolerance converged mid-launch"


def test_vol_tiled_light_calls_on_the_card(dev):
    """``VolChunk`` and ``VolMultichunk`` at 512x512x8 take the tiled path
    by the shape rule (so does ``VolChunk`` on the 556-row one-shard band),
    and their calls are the streaming ones' bit for bit, twice in a row on
    the same buffers."""
    from prost_tpu_torch.ops import fused_vol as fv

    L, n = 8, 512
    u, q, f, w = _vol_planes(660, L, n, n, dev)
    m = {"L": L, "nx": n, "ny": n, "f": f, "w": w, "lmb": 6.0,
         "radius": 0.5, "dataterm": "square",
         "lmb_t": torch.tensor(6.0, device=dev),
         "radius_t": torch.tensor(0.5, device=dev),
         "tols_t": tuple(torch.tensor(1e-3, device=dev) for _ in range(4)),
         "adapt_consts": _vol_mc_consts(L, n, n)}
    assert fv.VolChunk(m, 10, dev).route[0] == "tiled"
    assert fv.VolChunk(m, 10, dev, (n, n + 44, -22, 22, 22 + n)).route == (
        "tiled", (24, 32))
    assert fv.VolMultichunk(m, 10, 8, "boyd", dev).route[0] == "tiled"
    s3 = [torch.tensor(v, device=dev) for v in (0.9, 1.1, 1.0)]
    flag = torch.tensor(False, device=dev)
    out = {}
    for path in ("streaming", "tiled"):
        call = fv.VolChunk(m, 10, dev, path=path)
        multi = fv.VolMultichunk(m, 10, 3, "boyd", dev, path=path)
        assert call.route[0] == multi.route[0] == path
        cur, prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
        got = []
        for _ in range(2):
            got.append(call(cur, prev, f, w, *s3, flag).clone())
            got += [t.clone() for t in multi(
                cur, prev, *s3, torch.tensor(0.5, device=dev),
                torch.tensor(0.0, device=dev), torch.tensor(0.0, device=dev),
                torch.tensor(1, device=dev), flag)]
        out[path] = cur + prev + got
    torch.cuda.synchronize()
    for a, b in zip(out["streaming"], out["tiled"]):
        assert torch.equal(a, b)


def test_vol_tiled_rules_on_the_card(dev):
    """The card's limits send 256x256x8 to the grid-resident launch,
    512x512x8 (chunk and multichunk) to the tiled one and 9 labels to the
    streaming sequence, where asking for the tiled launch raises; so does
    a tile the C side refuses."""
    from prost_tpu_torch.ops import fused_vol as fv

    sms, smem = fv.card_limits(dev, 8)
    tsmem = fv.vol_tiled_limit(dev)
    assert tsmem >= 225 * 1024
    assert fv.vol_route_of(8, 256, 256, "square", sms, smem,
                           tsmem) == "resident"
    assert fv.vol_route_of(8, 512, 512, "square", sms, smem,
                           tsmem) == "tiled"
    assert fv.vol_route_of(8, 512, 512, "wsquare",
                           *fv.card_limits(dev, 8, multi=True), tsmem,
                           True) == "tiled"
    assert fv.vol_route_of(9, 512, 512, "square", sms, 0,
                           tsmem) == "streaming"
    u, q, f, w = _vol_planes(670, 9, 64, 64, dev)
    scal = torch.tensor(VOL_TILED_ARGS, device=dev)
    with pytest.raises(ptt.ProstError, match="tiled launch takes"):
        fv.vol_chunk_(u, q, u.clone(), q.clone(), f, w, scal, 2,
                      path="tiled")
    L, nx = 8, 256
    u, q, f, w = _vol_planes(671, L, nx, nx, dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = u.new_empty(4 * fv._lib().prost_vol_num_blocks(nx, nx))
    scratch = fv._scratch("tiled", 0, L, nx, nx, dev)
    for tile in ((12, 32), (8, 48), (40, 32)):  # not 8x32 tiles; too big
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            fv._launch_chunk("vol_chunk", [u, q], [u.clone(), q.clone()], f,
                             w, sc, partial, scratch, ("tiled", tile), 10,
                             "square")


# ---------------------------------------------------------------------------
# row 7: the batched ROF chunk tiled, the instances on the grid's z axis,
# for the instances that no cluster of 8 holds (-k rof_batched_tiled)
# ---------------------------------------------------------------------------

def _batched_paths(planes, scal, count, dataterm, path):
    """``rof_chunk_batched_`` with ``path`` on copies of the state: the
    state, the previous iterates (made x + 1 and q + 1, so that a flagged
    instance's shows) and norms2."""
    x, q, f, w = planes
    cur, prev = [x.clone(), q.clone()], [x + 1.0, q + 1.0]
    norms2 = fr.rof_chunk_batched_(*cur, *prev, f, w, scal, count, dataterm,
                                   path)
    torch.cuda.synchronize()
    return cur + prev + [norms2.clone()]


@pytest.mark.parametrize("B,nx,ny,dataterm,count,flags", [
    (2, 1280, 1280, "square", 10, None), (8, 512, 512, "wsquare", 10, None),
    (3, 70, 53, "abs", 3, [0, 1, 0]), (3, 300, 211, "square", 1, [1, 0, 0]),
    (4, 9, 300, "wsquare", 10, [0, 0, 0, 1])])
def test_rof_batched_tiled_is_each_instance_alone(dev, B, nx, ny, dataterm,
                                                  count, flags):
    """The batched tiled chunk: each instance bit-equal to ``rof_chunk_``'s
    tiled launch on it alone and to the batched streaming sequence, in the
    planes, the previous iterates and the norms; a flagged instance keeps
    all four and zero norms; one launch counted."""
    planes, scal = _rof_batch(690 + B, B, nx, ny, dev, conv=flags)
    before = dict(fr.launch_counts)
    tiled = _batched_paths(planes, scal, count, dataterm, "tiled")
    assert fr.launch_counts["rof_chunk_batched_tiled"] == (
        before["rof_chunk_batched_tiled"] + 1)
    assert fr.launch_counts["rof_chunk_batched"] == (
        before["rof_chunk_batched"] + 1)
    streaming = _batched_paths(planes, scal, count, dataterm, "streaming")
    for a, b in zip(tiled, streaming):
        assert torch.equal(a, b)
    x, q, f, w = planes
    for b in range(B):
        cur, prev = [x[b].clone(), q[b].clone()], [x[b] + 1.0, q[b] + 1.0]
        one = fr.rof_chunk_(*cur, *prev, f[b], w[b], scal[:, b], count,
                            dataterm, path="tiled")
        for a, s in zip([t[b] for t in tiled[:4]] + [tiled[4][:, b]],
                        cur + prev + [one]):
            assert torch.equal(a, s)
        if flags is not None and flags[b]:
            for a, s in zip([t[b] for t in tiled[:4]],
                            [x[b], q[b], x[b] + 1.0, q[b] + 1.0]):
                assert torch.equal(a, s)
            assert not tiled[4][:, b].any()
        else:
            assert bool((tiled[4][:, b] > 0).all())


def test_rof_batched_tiled_matches_its_twin(dev):
    """The kernel against its plain twin (``rof_chunk_batched_tiled_plain``
    on the card, the rule's tile) at three ragged instances with mass on
    the dead duals: planes within 2e-5, norms within 1e-4 relative."""
    B, nx, ny = 3, 300, 211
    planes, scal = _rof_batch(695, B, nx, ny, dev)
    tile = fr.tiled_tile(nx, ny, 10, "wsquare", fr.card_sms(dev),
                         fr.tiled_limit(dev), B)
    out = _batched_paths(planes, scal, 10, "wsquare", "tiled")
    ref = fr.rof_chunk_batched_tiled_plain(*planes, scal, 10, "wsquare",
                                           tile=tile)
    for a, b in zip(out[:2] + out[2:4], ref[:4]):
        assert float(torch.max(torch.abs(a - b))) <= 2e-5
    torch.testing.assert_close(out[4], ref[4], rtol=1e-4, atol=0.0)


def test_rof_batched_tiled_wrapper_takes_the_rule(dev):
    """``rof_chunk_batched`` takes the tiled launch at 2 of 1280x1280 and
    272x272 (no cluster of 8 holds them) and the cluster launch at 256x256;
    the tiled wrapper's outputs are the streaming sequence's, bit for bit,
    and the inputs are left as they were."""
    for n, want in ((1280, "tiled"), (272, "tiled"), (256, "cluster")):
        assert fr.batched_route_of(2, n, n, "square", 10, fr.card_sms(dev),
                                   fr.tiled_limit(dev)) == want
    planes, scal = _rof_batch(696, 2, 1280, 1280, dev)
    before = [t.clone() for t in planes]
    tiled0 = fr.launch_counts["rof_chunk_batched_tiled"]
    out = fr.rof_chunk_batched(*planes, scal, 10)
    assert fr.launch_counts["rof_chunk_batched_tiled"] == tiled0 + 1
    want = fr.rof_chunk_batched(*planes, scal, 10, path="streaming")
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    for a, b in zip(planes, before):
        assert torch.equal(a, b)


def test_rof_batched_tiled_refuses_what_it_does_not_take(dev):
    """A tile that is not whole 32x8 norm tiles or whose window does not
    fit, and a batch of 0 or beyond 65535, are refused by the C entry
    point; the cluster path where no cluster holds an instance, the tiled
    path where no window holds the halo, and the cluster path in place
    raise before a launch."""
    planes, scal = _rof_batch(697, 2, 96, 128, dev)
    x, q, f, w = planes
    lib = fr._lib()
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = x.new_empty(2 * 4 * lib.prost_rof_num_blocks(96, 128))
    scratch = x.new_empty(6, 96, 128)
    bufs = [x, q, x.clone(), q.clone(), f, w, sc, partial, scratch]
    for batch, tile in ((2, (12, 32)), (2, (8, 48)), (2, (256, 256)),
                        (0, (8, 32)), (65536, (8, 32))):
        with pytest.raises(ptt.ProstError, match="CUDA launch failed"):
            launch(lib, "prost_rof_chunk_batched_tiled", "rof_chunk_batched",
                   fr.launch_counts, dev, bufs, 96, 128, 10, 0, batch, *tile)
    with pytest.raises(ptt.ProstError, match="path must be"):
        fr.rof_chunk_batched_(x, q, x.clone(), q.clone(), f, w, scal, 10,
                              path="cluster")
    big, bscal = _rof_batch(698, 1, 2048, 2048, dev)
    with pytest.raises(ptt.ProstError, match="no cluster"):
        fr.rof_chunk_batched(*big, bscal, 10, path="cluster")
    with pytest.raises(ptt.ProstError, match="no tile"):
        fr.rof_chunk_batched(*big, bscal, 41, "wsquare", path="tiled")


def test_rof_batched_light_call_on_the_card(dev):
    """``ROFBatchedChunk`` at 2 of 1280x1280 takes the tiled path and leaves
    in the run's own planes what ``rof_chunk_batched_`` leaves on the
    streaming path, twice in a row from the state it left, and with the
    flags set nothing."""
    planes, scal = _rof_batch(699, 2, 1280, 1280, dev)
    x, q, f, w = planes
    m = {"nx": 1280, "ny": 1280, "f": f, "w": w, "dataterm": "square",
         "lmb": scal[3], "radius": scal[4]}
    call = fr.ROFBatchedChunk(m, 2, 10, dev)
    assert call.inplace and call.route[0] == "tiled"
    assert fr.ROFBatchedChunk(dict(m, nx=128, ny=128), 2, 10,
                              dev).route == ("cluster", None)
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want_cur, want_prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    for tau, done in ((0.9, False), (1.1, False), (1.1, True)):
        taus = torch.full((2,), tau, device=dev)
        got = call(cur, prev, f, w, taus, scal[1], scal[2],
                   torch.tensor(done, device=dev))
        s6 = torch.stack([taus, scal[1], scal[2], scal[3], scal[4],
                          torch.full((2,), float(done), device=dev)])
        want = fr.rof_chunk_batched_(*want_cur, *want_prev, f, w, s6, 10,
                                     "square", "streaming")
        for a, b in zip(cur + prev + [got], want_cur + want_prev + [want]):
            assert torch.equal(a, b)


def test_rof_batched_tiled_ensemble_route(dev):
    """``BatchedPDHG`` on 3 ROF instances of 280x280 (no cluster holds
    them): the route's light call takes the tiled launch, one a chunk by
    the phase plan, and the run equals the same route on the streaming
    path bit for bit; the caller's state is left as it was."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import BatchedPDHG

    rng = np.random.RandomState(700)
    probs = []
    for lmb in (6.0, 12.0, 24.0):
        n = 280 * 280
        grad = ptt.linop.BlockGradient2D(row=0, col=0, nx=280, ny=280, L=1)
        prox_g = [ptt.prox.ProxElem1D(
            index=0, size=n, fun="square",
            coeffs=(1.0, rng.rand(n), lmb, 0.0, 0.0, 0.0, 0.0))]
        pn = ptt.prox.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                                    interleaved=False, fun="abs",
                                    coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0,
                                            0.0))
        probs.append(ptt.Problem.create(
            ptt.linop.LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ptt.prox.ProxMoreau(index=0, size=2 * n, child=pn)],
            device=dev))
    opts = PDHGOptions(stepsize="boyd", residual_iter=10,
                       scale_steps_operator=False)
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=0.0,
                              tol_rel_dual=0.0, tol_abs_primal=0.0,
                              tol_abs_dual=0.0)
    states = {}
    for path in ("tiled", "streaming"):
        b = BatchedPDHG(probs, opts, sopts)
        if path == "streaming":
            b.rof["call"] = fr.ROFBatchedChunk(b.rof, 3, 10, dev,
                                               path="streaming")
        s0 = b.initial_state()
        before = {k: v.clone() for k, v in vars(s0).items()}
        tiled0 = fr.launch_counts["rof_chunk_batched_tiled"]
        s = b.run(s0, 37, 0)
        states[path] = b.run(s, 81, 37)
        assert b.rof["call"].route[0] == path
        # chunks from iteration 1 to 31 and from 41 to 81
        assert fr.launch_counts["rof_chunk_batched_tiled"] - tiled0 == (
            7 if path == "tiled" else 0)
        for k, v in before.items():
            assert torch.equal(v, getattr(s0, k)), k
    for k, v in vars(states["tiled"]).items():
        assert torch.equal(v, getattr(states["streaming"], k)), k
