"""The two redesigned kernels on the card: ``rof_chunk_batched``'s cluster
launch (each instance held on chip by a thread-block cluster) and
``admm_iter_halo_``'s cooperative launch (one launch per iteration).

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
    """At 128 columns, 576 rows is the tallest square instance that a
    cluster of 8 holds and 577 the shortest that streams; both paths give
    each instance as ``rof_chunk`` does."""
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
