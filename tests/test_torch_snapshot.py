"""Port parity: publishing a snapshot (private layout) and reading it back —
regions, tier bytes, checksums, run index, extents and the reconstructed
image — against the JAX package with its fused publish kernel in Pallas
interpret mode (exact)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as ref
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro_torch import core as port
from repro_torch.kernels import fused_publish, make_fused_publish_fn

PAGE = 4096
CXL, RDMA = 2 << 20, 2 << 20


def make_image(seed=0):
    """~200 pages: random params, a runtime segment with scattered zero
    pages, a zero arena; the working set is a handful of short runs."""
    rng = np.random.default_rng(seed)
    runtime = rng.integers(0, 256, (96 * PAGE,), dtype=np.uint8)
    for p in rng.choice(96, 30, replace=False):
        runtime[p * PAGE : (p + 1) * PAGE] = 0
    arrays = {
        "params": rng.standard_normal((40 * 1024,)).astype(np.float32),
        "runtime": runtime,
        "arena": np.zeros((50, 1024), np.float32),
        "tail": rng.integers(1, 5, (7 * PAGE + 100,), dtype=np.uint8),
    }
    ws = sorted({*range(0, 12), *range(20, 23), 33, *range(41, 46), 60, 61, 62,
                 70, 100, *range(140, 150), 187, 190, 191})
    return arrays, ws


def publish_both(seed=0, fused=True):
    arrays, ws = make_image(seed)
    img_r = ref.StateImage.build(arrays)
    img_g = port.StateImage.build(arrays, device="cpu")
    pool_r = ref.HierarchicalPool(CXL, RDMA)
    pool_g = port.HierarchicalPool(CXL, RDMA, device="cpu")
    pool_r.cxl.alloc(3 * PAGE)        # a non-zero region base on both
    pool_g.cxl.alloc(3 * PAGE)
    kw_r = {"publish_fn": ref_publish_fn(block_pages=64, use_pallas=True, interpret=True)}
    kw_g = {"publish_fn": make_fused_publish_fn()}
    if not fused:
        kw_r = kw_g = {}
    reg_r = ref.build_snapshot(pool_r, img_r, ws, "m", version=3, metadata={"k": 1}, **kw_r)
    reg_g = port.build_snapshot(pool_g, img_g, ws, "m", version=3, metadata={"k": 1}, **kw_g)
    return (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), ws


@pytest.mark.parametrize("fused", [True, False])
def test_build_snapshot_layout_identical(fused):
    (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), ws = publish_both(fused=fused)
    assert dataclasses.asdict(reg_r) == dataclasses.asdict(reg_g)
    assert reg_g.n_hot > 0 and reg_g.n_cold > 0 and reg_g.n_zero > 0
    np.testing.assert_array_equal(pool_r.cxl.buf, pool_g.cxl.buf.numpy())
    np.testing.assert_array_equal(pool_r.rdma.buf, pool_g.rdma.buf.numpy())
    for t in ("cxl", "rdma"):
        assert getattr(pool_r, t)._free == getattr(pool_g, t).free_list()
    if fused:
        np.testing.assert_array_equal(reg_r.page_checksums,
                                      reg_g.page_checksums.numpy().view(np.uint32))
    else:
        assert getattr(reg_g, "page_checksums", None) is None
    assert (ref.estimate_snapshot_cxl_size(img_r, ws, metadata={"k": 1})
            == port.estimate_snapshot_cxl_size(img_g, ws, metadata={"k": 1})
            == reg_g.cxl_size)


def test_fused_publish_counts_no_cpu_launch():
    """The CPU path is the plain version: it never counts a kernel launch."""
    before = fused_publish.launches
    publish_both()
    assert fused_publish.launches == before


def test_reader_runs_extents_and_pages_equal():
    (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), _ = publish_both(seed=1)
    lr, lg = ref.TimeLedger(), port.TimeLedger()
    rr = ref.SnapshotReader(reg_r, pool_r.host_view("h", lr), pool_r.rdma)
    rg = port.SnapshotReader(reg_g, pool_g.host_view("h", lg), pool_g.rdma)
    rr.invalidate_cxl()
    rg.invalidate_cxl()
    (m_r, meta_r), (m_g, meta_g) = rr.machine_state(), rg.machine_state()
    assert (m_r.to_dict(), meta_r) == (m_g.to_dict(), meta_g)
    np.testing.assert_array_equal(rr.offset_array(), rg.offset_array())
    for name in ("hot_runs", "cold_runs", "zero_runs", "hot_page_indices",
                 "cold_page_indices", "zero_page_indices"):
        np.testing.assert_array_equal(getattr(rr, name)(), getattr(rg, name)())
    assert list(rr.iter_cold_extents(8)) == list(rg.iter_cold_extents(8))
    assert (list(rr.iter_cold_extents(5, largest_first=False))
            == list(rg.iter_cold_extents(5, largest_first=False)))
    for (pr, offr, nr), (pg, offg, ng) in zip(rr.iter_hot_extents(16),
                                               rg.iter_hot_extents(16), strict=True):
        np.testing.assert_array_equal(pr, pg)
        assert (offr, nr) == (offg, ng)
    for page in range(reg_g.total_pages):
        assert rr.lookup(page) == rg.lookup(page)
        np.testing.assert_array_equal(rr.read_page(page), rg.read_page(page).numpy())
    es, en, rank0, off, nb = next(rg.iter_cold_extents(8))
    payload = pool_g.rdma.read(off, nb)
    np.testing.assert_array_equal(
        rr.split_cold_extent(rank0, en, pool_r.rdma.read(off, nb)),
        rg.split_cold_extent(rank0, en, payload).numpy())
    assert rr.view.stats == rg.view.stats
    assert lr.seconds == lg.seconds


def test_reconstruct_image_bit_identical_and_free():
    (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), _ = publish_both(seed=2)
    back_r = ref.reconstruct_image(pool_r, reg_r)
    back_g = port.reconstruct_image(pool_g, reg_g)
    np.testing.assert_array_equal(back_g.buf.numpy(), img_g.buf.numpy())
    np.testing.assert_array_equal(back_g.buf.numpy(), back_r.buf)
    assert back_g.manifest.to_dict() == back_r.manifest.to_dict()
    ref.free_snapshot(pool_r, reg_r)
    port.free_snapshot(pool_g, reg_g)
    for t in ("cxl", "rdma"):
        assert getattr(pool_r, t)._free == getattr(pool_g, t).free_list()
        assert (getattr(pool_r, t).free_list_stats()
                == getattr(pool_g, t).free_list_stats())


def test_unported_layouts_raise():
    """The compressed cold tier (once the one layout the port refused):
    ``build_snapshot``, ``estimate_snapshot_cxl_size``, a ``SnapshotReader``
    over it and ``free_snapshot`` agree with the JAX package (compressed with
    ``zstandard``, uncompressed without it, in both packages alike)."""
    arrays, ws = make_image()
    img_r = ref.StateImage.build(arrays)
    img_g = port.StateImage.build(arrays, device="cpu")
    pool_r = ref.HierarchicalPool(CXL, RDMA)
    pool_g = port.HierarchicalPool(CXL, RDMA, device="cpu")
    reg_r = ref.build_snapshot(pool_r, img_r, ws, "m", compress_cold=True)
    reg_g = port.build_snapshot(pool_g, img_g, ws, "m", compress_cold=True)
    assert dataclasses.asdict(reg_r) == dataclasses.asdict(reg_g)
    np.testing.assert_array_equal(pool_r.cxl.buf, pool_g.cxl.buf.numpy())
    np.testing.assert_array_equal(pool_r.rdma.buf, pool_g.rdma.buf.numpy())
    assert (ref.estimate_snapshot_cxl_size(img_r, ws, compress_cold=True)
            == port.estimate_snapshot_cxl_size(img_g, ws, compress_cold=True)
            == reg_g.cxl_size)
    rd_r = ref.SnapshotReader(reg_r, pool_r.host_view("h"), pool_r.rdma)
    rd_g = port.SnapshotReader(reg_g, pool_g.host_view("h"), pool_g.rdma)
    for page in range(img_g.total_pages):
        assert rd_r.lookup(page) == rd_g.lookup(page)
        np.testing.assert_array_equal(rd_g.read_page(page).numpy(), img_r.page(page))
    port.free_snapshot(pool_g, reg_g)
    assert pool_g.cxl.free_list_stats()["blocks"] == 1
    assert pool_g.rdma.bytes_in_use == 0


def test_state_image_arrays_and_pages_view():
    arrays, _ = make_image(3)
    img_r = ref.StateImage.build(arrays)
    img_g = port.StateImage.build(arrays, device="cpu")
    assert img_r.manifest.to_dict() == img_g.manifest.to_dict()
    np.testing.assert_array_equal(img_r.buf, img_g.buf.numpy())
    for name, arr in arrays.items():
        np.testing.assert_array_equal(img_g.read_array(name), arr)
    pm = img_g.pages_matrix()
    assert pm.shape == (img_g.total_pages, PAGE)
    assert pm.data_ptr() == img_g.buf.data_ptr()          # a view, not a copy
    np.testing.assert_array_equal(img_r.zero_page_bitmap(), img_g.zero_page_bitmap())
    empty = port.StateImage.empty_like(img_g.manifest, device="cpu")
    assert empty.buf.shape == img_g.buf.shape and not empty.buf.any()
    assert port.runs_from_pages([5, 1, 2, 3, 9]) == ref.runs_from_pages([5, 1, 2, 3, 9])
    assert port.pages_from_runs([(1, 3), (9, 1)]) == [1, 2, 3, 9]
    assert torch.equal(img_g.page(2), img_g.buf[2 * PAGE : 3 * PAGE])
