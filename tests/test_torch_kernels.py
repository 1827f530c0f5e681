"""Port parity: the fused snapshot kernels' plain torch versions against the
JAX package's Pallas kernels in interpret mode (exact).  The CUDA kernels
are held to these plain versions on the card in ``test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro.kernels import FusedScatter as RefFusedScatter
from repro.kernels import fused_publish as ref_fused_publish
from repro.kernels import fused_restore as ref_fused_restore
from repro.kernels.page_checksum.ref import poly_weights as ref_poly_weights
from repro.kernels.snapshot_fuse.ops import ChecksumMismatchError as RefMismatch
from repro_torch.kernels import (
    ChecksumMismatchError,
    FusedScatter,
    fused_publish,
    fused_restore,
)
from repro_torch.kernels.page_checksum.ref import page_checksum_ref, poly_weights
from repro_torch.kernels.snapshot_fuse.ops import (
    PUBLISH_MAX_PAGES,
    PUBLISH_TILE_PAGES,
    publish_rows,
)

PAGE = 4096
INTERP = {"use_pallas": True, "interpret": True}
T = PUBLISH_TILE_PAGES


def _pages(n, seed=0, zero_every=3):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, size=(n, PAGE), dtype=np.uint8)
    if zero_every:
        pages[::zero_every] = 0
    ws = np.zeros(n, dtype=bool)
    if n:
        ws[rng.choice(n, size=max(1, n // 2), replace=False)] = True
    return pages, ws


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _assert_publish_equal(pages, ws):
    want = ref_fused_publish(pages, ws, block_pages=8, **INTERP)
    got = fused_publish(torch.from_numpy(pages), torch.from_numpy(ws))
    np.testing.assert_array_equal(got.zero_bitmap.numpy(), want.zero_bitmap)
    np.testing.assert_array_equal(_u32(got.checksums), want.checksums)
    np.testing.assert_array_equal(got.hot.numpy(), want.hot.reshape(-1, PAGE))
    np.testing.assert_array_equal(got.cold.numpy(), want.cold.reshape(-1, PAGE))
    return got


class TestPublishParity:
    # with the CUDA kernel's tile edges: a partial tile, one, one and a page,
    # and a partial fourth tile
    @pytest.mark.parametrize("n", sorted({0, 1, 7, 8, 37, 64, T - 1, T, T + 1, 3 * T + 5}))
    def test_matches_pallas_interpret(self, n):
        pages, ws = _pages(n, seed=n)
        _assert_publish_equal(pages, ws)

    def test_all_zero(self):
        got = _assert_publish_equal(np.zeros((16, PAGE), np.uint8), np.ones(16, bool))
        assert got.zero_bitmap.all() and got.hot.shape[0] == got.cold.shape[0] == 0

    def test_all_hot(self):
        pages, _ = _pages(24, seed=3, zero_every=0)
        got = _assert_publish_equal(pages, np.ones(24, bool))
        assert got.cold.shape[0] == 0 and got.hot.shape[0] == 24

    def test_all_ones_lanes_wrap(self):
        """Every lane 0xFFFFFFFF: each product exceeds 2^63 in int64."""
        pages = np.full((9, PAGE), 0xFF, np.uint8)
        pages[4] = 0
        _assert_publish_equal(pages, np.arange(9) % 2 == 0)


class TestPublishRows:
    """The CUDA wrapper's split of its one output buffer into hot and cold."""

    @pytest.mark.parametrize("n_ws,n_hot,n_cold", [(0, 0, 9), (12, 12, 0), (5, 3, 4)])
    def test_views_of_one_buffer(self, n_ws, n_hot, n_cold):
        buf = torch.arange(12, dtype=torch.uint8).repeat_interleave(16).reshape(12, 16)
        hot, cold = publish_rows(buf, n_ws, n_hot, n_cold)
        assert hot.shape == (n_hot, 16) and cold.shape == (n_cold, 16)
        assert hot[:, 0].tolist() == list(range(n_hot))
        assert cold[:, 0].tolist() == list(range(n_ws, n_ws + n_cold))
        for t in (hot, cold):
            assert t.is_contiguous() and t.untyped_storage().data_ptr() == buf.data_ptr()

    def test_wrapper_refuses_past_its_page_cap(self):
        """Checked before anything is read or allocated: meta tensors."""
        pages = torch.empty((PUBLISH_MAX_PAGES + 1, PAGE), dtype=torch.uint8, device="meta")
        ws = torch.empty(PUBLISH_MAX_PAGES + 1, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="at most"):
            fused_publish(pages, ws)


class TestRestoreParity:
    @pytest.mark.parametrize("n,m", [(16, 4), (37, 21), (64, 64)])
    def test_permuted_src_matches_pallas_interpret(self, n, m):
        rng = np.random.default_rng(n * m)
        chunk = rng.integers(0, 256, size=(m, PAGE), dtype=np.uint8)
        dst = np.sort(rng.choice(n, size=m, replace=False)).astype(np.int32)
        src = rng.permutation(m).astype(np.int32)
        dest_ref = rng.integers(0, 256, size=(n, PAGE), dtype=np.uint8)
        dest_t = torch.from_numpy(dest_ref.copy())
        out, csums = ref_fused_restore(dest_ref, chunk, dst, src_indices=src, **INTERP)
        got, got_cs = fused_restore(dest_t, torch.from_numpy(chunk), dst, src_indices=src)
        assert got is dest_t
        np.testing.assert_array_equal(dest_t.numpy(), np.asarray(out).reshape(n, PAGE))
        np.testing.assert_array_equal(_u32(got_cs), np.asarray(csums))

    def test_mismatch_raises_same_bad_pages(self):
        chunk, _ = _pages(6, seed=5, zero_every=0)
        idx = np.array([1, 3, 5, 7, 9, 11], np.int64)
        good = np.asarray(ref_fused_restore(np.zeros((12, PAGE), np.uint8), chunk, idx,
                                            **INTERP)[1])
        bad = good.copy()
        bad[[1, 4]] ^= 1
        with pytest.raises(RefMismatch) as want:
            ref_fused_restore(np.zeros((12, PAGE), np.uint8), chunk, idx,
                              expected_csums=bad, **INTERP)
        table = np.zeros(12, np.uint32)
        table[idx] = bad
        dest = torch.zeros((12, PAGE), dtype=torch.uint8)
        with pytest.raises(ChecksumMismatchError) as got:
            fused_restore(dest, torch.from_numpy(chunk), idx,
                          expected_table=torch.from_numpy(table.view(np.int32)))
        np.testing.assert_array_equal(got.value.bad_pages, want.value.bad_pages)
        assert got.value.bad_pages.tolist() == [3, 9]
        np.testing.assert_array_equal(dest.numpy()[idx], chunk)   # rows written either way

    def test_bound_scatter_stats_match(self):
        chunk, _ = _pages(4, seed=8, zero_every=0)
        idx = np.array([1, 4, 6, 8], np.int64)
        table = np.zeros(10, np.uint32)
        table[idx] = _u32(page_checksum_ref(torch.from_numpy(chunk)))
        ref_sf = RefFusedScatter(**INTERP)
        sf = FusedScatter()
        ref_sf.bind_checksums(table)(np.zeros((10, PAGE), np.uint8), chunk, idx)
        dest = torch.zeros((10, PAGE), dtype=torch.uint8)
        sf.bind_checksums(table)(dest, torch.from_numpy(chunk), idx)
        sf(dest, torch.from_numpy(chunk), idx)
        ref_sf(np.zeros((10, PAGE), np.uint8), chunk, idx)
        assert sf.stats == ref_sf.stats == {"batches": 2, "pages": 8, "pages_verified": 4}

    def test_duplicate_destinations_rejected(self):
        chunk, _ = _pages(2, seed=9, zero_every=0)
        with pytest.raises(AssertionError):
            fused_restore(torch.zeros((4, PAGE), dtype=torch.uint8),
                          torch.from_numpy(chunk), np.array([2, 2]))


def test_poly_weights_equal_reference():
    for lanes in (1, 7, 1024):
        np.testing.assert_array_equal(poly_weights(lanes), np.asarray(ref_poly_weights(lanes)))


def test_cuda_default_raises_without_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from repro_torch.core import HierarchicalPool, Manifest, StateImage

    with pytest.raises(RuntimeError, match="cuda"):
        HierarchicalPool(1 << 20, 1 << 20)
    with pytest.raises(RuntimeError, match="cuda"):
        StateImage.empty_like(Manifest([], 1))
