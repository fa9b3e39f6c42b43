"""The rules and contracts of the two redesigned kernels that the CPU can
check: the cluster size of ``rof_chunk_batched`` from the shared-memory
budget, the row bands of ``admm_iter_halo_``'s cooperative launch, and the
batched wrapper's contract on the plain path (its inputs untouched, a
converged instance's outputs its inputs).  The kernels themselves are held
against their launch sequences on the card (``test_torch_cuda_redesign.py``).
"""

import numpy as np
import pytest
import torch

import prost_tpu_torch as ptt
from prost_tpu_torch.ops import fused_admm as fa
from prost_tpu_torch.ops import fused_rof as fr


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# (nx, ny, data term, cluster size): ensemble1024x128 (config 5) and the
# ragged and large shapes that chip_smoke.py's phase 11 runs; 576 and 577
# rows bracket the largest square instance of 128 columns that a cluster
# of 8 holds
CLUSTER_CASES = [(128, 128, "square", 2), (128, 128, "abs", 2),
                 (128, 128, "wsquare", 2), (250, 190, "square", 8),
                 (250, 190, "wsquare", 8), (250, 190, "abs", 8),
                 (40, 36, "square", 1), (100, 45, "square", 1),
                 (130, 128, "abs", 2), (576, 128, "square", 8),
                 (577, 128, "square", None), (1280, 1280, "square", None),
                 (8, 1100, "square", 1), (8, 1100, "wsquare", None)]


@pytest.mark.parametrize("nx,ny,dataterm,want", CLUSTER_CASES)
def test_cluster_size_is_the_smallest_that_fits(nx, ny, dataterm, want):
    got = fr.cluster_size(nx, ny, dataterm)
    assert got == want

    def smem(c):
        rows = fr.cluster_planes(dataterm) * fr.cluster_band_rows(nx, c) + 2
        return rows * ny * 4

    smaller = [c for c in fr.CLUSTER_SIZES if got is None or c < got]
    assert all(smem(c) > fr.SMEM_BYTES for c in smaller)
    if got is not None:
        assert smem(got) <= fr.SMEM_BYTES


@pytest.mark.parametrize("csize", [1, 2, 4, 8])
def test_cluster_bands_cover_every_row_once(csize):
    """The bands of a cluster (rank r owns rows [r R, min((r + 1) R, nx)))
    are whole 32x8 tile rows, cover every row once, and only the last
    non-empty one may be short."""
    for nx in range(2, 700):
        R = fr.cluster_band_rows(nx, csize)
        assert R % 8 == 0 and R * csize >= nx and R - 8 < -(-nx // csize)
        owned = [i for r in range(csize)
                 for i in range(r * R, min((r + 1) * R, nx))]
        assert owned == list(range(nx))


@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 132, 264, 396, 1000])
def test_admm_bands_cover_every_row_once(blocks):
    halo = fa.admm_cheby_halo_rows(10)
    for nx in range(halo, 1200, 7):
        bands = fa.admm_bands(nx, blocks)
        assert len(bands) == blocks
        assert [i for lo, hi in bands for i in range(lo, hi)] == \
            list(range(nx))
        sizes = {hi - lo for lo, hi in bands}
        assert max(sizes) - min(sizes) <= 1


def _batch(seed, B, nx, ny, conv):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(B, nx, ny), 0.3 * rng.randn(B, 2, nx, ny),
            rng.rand(B, nx, ny), 2.0 * (rng.rand(B, nx, ny) > 0.3))
    planes = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    rows = [0.8 + 0.4 * rng.rand(B), 0.8 + 0.4 * rng.rand(B), np.ones(B),
            np.full(B, 16.0), np.ones(B), np.asarray(conv, np.float64)]
    return planes, torch.tensor(np.array(rows), dtype=torch.float32)


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_batched_wrapper_contract_on_the_plain_path(dataterm):
    """A converged instance's outputs are its inputs and its norms zero;
    the others advance as without the flag; the caller's planes are left
    as they were."""
    planes, scal = _batch(71, 3, 24, 20, [0, 1, 0])
    x, q = planes[:2]
    before = [t.clone() for t in planes]
    out = fr.rof_chunk_batched(*planes, scal, 5, dataterm)
    free = fr.rof_chunk_batched(*planes, scal[:5], 5, dataterm)
    for a, b in zip(planes, before):
        assert torch.equal(a, b)
    for a, s, inp in zip(out[:4], free[:4], (x, q, x, q)):
        assert torch.equal(a[1], inp[1])
        for b in (0, 2):
            assert torch.equal(a[b], s[b])
            assert not torch.equal(a[b], inp[b])
    assert not out[4][:, 1].any() and out[4][:, 0].all()


def test_streaming_in_place_chunk_takes_card_tensors_only():
    planes, scal = _batch(72, 2, 16, 16, [0, 0])
    x, q, f, w = planes
    with pytest.raises(ptt.ProstError, match="card"):
        fr.rof_chunk_batched_streaming_(x, q, x.clone(), q.clone(), f, w,
                                        scal[:5], 3)


def test_admm_iter_halo_refuses_degrees_beyond_its_launch():
    """The halo iteration's launch takes its Chebyshev coefficients from a
    device array made per degree, so it refuses only degrees below 1: a
    degree above the 64 that a fixed launch argument once held runs, and
    its owned rows are one whole-plane iteration of that degree
    (``admm_chunk_plain`` with count 1), bit for bit."""
    rng = np.random.RandomState(73)
    shapes = [(32, 16)] * 3 + [(2, 32, 16)] * 3 + [(32, 16)] * 3
    planes = [torch.from_numpy(rng.rand(*s).astype(np.float32))
              for s in shapes]
    scal = torch.tensor([1.3, 8.0, 1.0])
    with pytest.raises(ptt.ProstError, match="degree >= 1"):
        fa.admm_iter_halo_(*planes, scal, 0, 1.7, 32, 0, 0, 32)
    whole = fa.admm_chunk_plain(*planes, scal, None, 1, 0, 1.7, "square", 65)
    cur = [t.clone() for t in planes[:7]]
    norms2 = fa.admm_iter_halo_(*cur, *planes[7:], scal, 65, 1.7, 32, 0, 0,
                                32)
    for a, b in zip(cur + [norms2], whole):
        assert torch.equal(a, b)
    assert not torch.equal(cur[0], planes[0])
