"""Port parity: the piecemeal page kernels' plain torch versions (zero_detect,
page_checksum, page_gather, page_scatter) against the JAX package's Pallas
kernels in interpret mode (exact).  The CUDA kernels are held to these plain
versions on the card in ``test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro.kernels import fused_publish as ref_fused_publish
from repro.kernels.page_checksum.ops import page_checksum as ref_page_checksum
from repro.kernels.page_checksum.ref import page_checksum_ref as ref_checksum_oracle
from repro.kernels.page_checksum.ref import poly_weights as ref_poly_weights
from repro.kernels.page_gather.ops import page_gather as ref_page_gather
from repro.kernels.page_scatter.ops import page_scatter as ref_page_scatter
from repro.kernels.zero_detect.ops import zero_detect as ref_zero_detect
from repro.kernels.zero_detect.ref import zero_detect_ref as ref_zero_oracle
from repro_torch.core import kernel_zero_scan, poly32_hash_fn
from repro_torch.kernels import (
    fused_publish,
    page_checksum,
    page_gather,
    page_scatter,
    zero_detect,
)
from repro_torch.kernels.zero_detect import value_mask

PAGE = 4096
INTERP = {"use_pallas": True, "interpret": True}
SIZES = [0, 1, 7, 8, 37, 64]


def _pages(n, seed, fill=None):
    """Random pages with every third page zero and every seventh all-0xFF;
    ``fill`` makes every page that one byte value instead."""
    rng = np.random.default_rng(seed)
    if fill is not None:
        return np.full((n, PAGE), fill, np.uint8)
    pages = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    pages[::3] = 0
    pages[1::7] = 0xFF
    return pages


def _cases():
    for n in SIZES:
        yield f"mixed-{n}", _pages(n, n)
    yield "all-zero", _pages(16, 0, fill=0)
    yield "none-zero", _pages(16, 1, fill=3)
    yield "all-ff", _pages(16, 2, fill=0xFF)


CASES = list(_cases())
IDS = [c[0] for c in CASES]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name,pages", CASES, ids=IDS)
def test_zero_detect_matches_pallas_interpret(name, pages):
    n = pages.shape[0]
    u32 = pages.view(np.uint32).reshape(n, PAGE // 4)
    want = (np.asarray(ref_zero_oracle(u32)) if n == 0
            else np.asarray(ref_zero_detect(u32, block_pages=8, **INTERP)))
    before = zero_detect.launches
    got = zero_detect(torch.from_numpy(pages))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kernel_zero_scan(torch.from_numpy(pages)).numpy(), want != 0)
    assert zero_detect.launches == before          # CPU tensors: the plain version


def test_zero_detect_float_values():
    """Value semantics: -0.0 counts as zero, NaN does not."""
    f = np.zeros((6, 1024), np.float32)
    f[1, 5] = -0.0
    f[2, :] = -0.0
    f[3, 7] = np.nan
    f[4, 1023] = 1.0
    f[5, 0] = -2.5
    want = np.asarray(ref_zero_detect(f, block_pages=2, **INTERP))
    got = zero_detect(torch.from_numpy(f))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 1, 1, 0, 0, 0]


def test_zero_detect_denormal_is_not_zero():
    """A page holding only a float32 denormal is not a zero page here.  The
    reference's compare runs under XLA, which flushes denormals to zero, so
    it reports this page as zero (ROADMAP §C records the divergence); the
    snapshot paths of both packages scan pages as integers and agree."""
    f = np.zeros((2, 1024), np.float32)
    f[1, 9] = np.float32(1e-45)                 # bits 0x00000001
    assert np.asarray(ref_zero_detect(f, block_pages=2, **INTERP)).tolist() == [1, 1]
    assert zero_detect(torch.from_numpy(f)).tolist() == [1, 0]
    u32 = f.view(np.uint32)
    assert np.asarray(ref_zero_detect(u32, block_pages=2, **INTERP)).tolist() == [1, 0]
    assert zero_detect(torch.from_numpy(u32.view(np.int32))).tolist() == [1, 0]
    assert value_mask(torch.float32) == (0x7FFFFFFF,) * 4
    assert value_mask(torch.bfloat16) == (0x7FFF7FFF,) * 4
    assert value_mask(torch.uint8) == (0xFFFFFFFF,) * 4


def test_zero_detect_half_values():
    h = torch.zeros((3, 2048), dtype=torch.float16)
    h[1, :] = -0.0
    h[2, 3] = float("nan")
    assert zero_detect(h).tolist() == [1, 1, 0]


@pytest.mark.parametrize("name,pages", CASES, ids=IDS)
def test_page_checksum_matches_pallas_interpret(name, pages):
    n = pages.shape[0]
    want = (np.asarray(ref_checksum_oracle(pages.view(np.uint32).reshape(n, PAGE // 4),
                                           ref_poly_weights(PAGE // 4)))
            if n == 0 else np.asarray(ref_page_checksum(pages, block_pages=8, **INTERP)))
    before = page_checksum.launches
    got = page_checksum(torch.from_numpy(pages))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(poly32_hash_fn(torch.from_numpy(pages))), want)
    assert page_checksum.launches == before


@pytest.mark.parametrize("n", [1, 7, 37, 64])
def test_poly32_hash_equals_fused_publish_checksums(n):
    """The store hash and the fused sweep's checksum column are one function:
    dedup hits across the two publish routes depend on it."""
    pages = _pages(n, 100 + n)
    ws = np.arange(n) % 2 == 0
    want = ref_fused_publish(pages, ws, block_pages=8, **INTERP).checksums
    fused = fused_publish(torch.from_numpy(pages), torch.from_numpy(ws)).checksums
    np.testing.assert_array_equal(_u32(fused), want)
    np.testing.assert_array_equal(_u32(poly32_hash_fn(torch.from_numpy(pages))), want)


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


@pytest.mark.parametrize("name,pages", CASES, ids=IDS)
def test_page_gather_matches_pallas_interpret(name, pages):
    n = pages.shape[0]
    idx = _perm(n, n + 5)
    want = np.asarray(ref_page_gather(pages, idx.astype(np.int32), **INTERP))
    before = page_gather.launches
    got = page_gather(torch.from_numpy(pages), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (n, PAGE)
    assert page_gather.launches == before


def test_page_gather_repeats_dtypes_and_device_indices():
    pages = _pages(12, 9)
    idx = np.array([3, 3, 11, 0, 7], np.int64)
    want = np.asarray(ref_page_gather(pages, idx.astype(np.int32), **INTERP))
    np.testing.assert_array_equal(page_gather(torch.from_numpy(pages), idx).numpy(), want)
    t = torch.from_numpy(pages)
    np.testing.assert_array_equal(page_gather(t, torch.from_numpy(idx)).numpy(), want)
    f = pages.view(np.float32)
    np.testing.assert_array_equal(page_gather(torch.from_numpy(f), idx).numpy(),
                                  np.asarray(ref_page_gather(f, idx.astype(np.int32), **INTERP)))
    assert page_gather(t, np.zeros(0, np.int64)).shape == (0, PAGE)
    with pytest.raises(IndexError):
        page_gather(t, np.array([12]))


@pytest.mark.parametrize("name,pages", CASES, ids=IDS)
def test_page_scatter_matches_pallas_interpret(name, pages):
    m = pages.shape[0]
    n = m + 9
    rng = np.random.default_rng(m + 17)
    dst = rng.permutation(n)[:m].astype(np.int64)
    dest = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    want = np.asarray(ref_page_scatter(dest, pages, dst.astype(np.int32), **INTERP))
    got = torch.from_numpy(dest.copy())
    before = page_scatter.launches
    out = page_scatter(got, torch.from_numpy(pages), dst)
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)
    assert page_scatter.launches == before


def test_page_scatter_src_indices_equal_scattering_the_permuted_rows():
    rng = np.random.default_rng(3)
    compact = _pages(10, 4)
    dst = np.array([9, 2, 14, 5, 0, 7], np.int64)
    src = np.array([4, 4, 0, 9, 1, 6], np.int64)          # repeats allowed in src
    dest = rng.integers(0, 256, (16, PAGE), dtype=np.uint8)
    want = np.asarray(ref_page_scatter(dest, compact[src], dst.astype(np.int32), **INTERP))
    got = torch.from_numpy(dest.copy())
    page_scatter(got, torch.from_numpy(compact), dst, src_indices=src)
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = np.setdiff1d(np.arange(16), dst)
    np.testing.assert_array_equal(got.numpy()[untouched], dest[untouched])
    page_scatter(got, torch.from_numpy(compact), np.zeros(0, np.int64),
                 src_indices=np.zeros(0, np.int64))
    np.testing.assert_array_equal(got.numpy(), want)


def test_page_scatter_rejects_bad_indices():
    dest = torch.zeros((4, PAGE), dtype=torch.uint8)
    compact = torch.zeros((2, PAGE), dtype=torch.uint8)
    with pytest.raises(IndexError):
        page_scatter(dest, compact, np.array([0, 4]))
    with pytest.raises(ValueError):
        page_scatter(dest, compact, np.array([0, 1, 2]))
    with pytest.raises(AssertionError):
        page_scatter(dest, compact, np.array([1, 1]))
    with pytest.raises(IndexError):
        page_scatter(dest, compact, np.array([0, 1]), src_indices=np.array([0, 2]))
