"""Port parity: the content-addressed (dedup) snapshot layout end to end.

A small fleet of variants sharing a base (per-variant hot deltas, a
per-variant cold arena, shared zero pages and base pages that fall cold) is
published into one pool by the JAX package and by the port, through the
default, piecemeal and fused routes, and read back and restored.  Regions,
offset arrays, checksums, store states, tier bytes, estimates, reader
extents, restored images, ledgers and repair stats are held equal (exact);
the JAX side runs its Pallas kernels in interpret mode."""
import dataclasses

import numpy as np
import pytest

from repro import core as ref
from repro.core import faults as ref_faults
from repro.core.pagestore import pallas_zero_scan, set_zero_scan_backend
from repro.kernels import FusedScatter as RefFusedScatter
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro.kernels.page_checksum.ops import page_checksum as ref_page_checksum
from repro.kernels.page_gather.ops import page_gather as ref_page_gather
from repro_torch import core as port
from repro_torch.core import faults
from repro_torch.interop import dedup_store_state
from repro_torch.kernels import FusedScatter, make_fused_publish_fn
from test_torch_dedup import _ref_state

PAGE = 4096
CXL, RDMA = 4 << 20, 4 << 20
INTERP = {"use_pallas": True, "interpret": True}
N_VARIANTS, HOT, COLD, ZERO, DELTA = 4, 40, 24, 10, 3


def _ref_poly_hash(m):
    return np.asarray(ref_page_checksum(m, block_pages=8, **INTERP))


_ref_poly_hash.is_poly32 = True


def make_fleet(seed=0):
    """Arrays of each variant and its working set: shared base weights with
    per-variant delta pages, a per-variant cold arena (with repeated pages),
    and shared zero pages; the weights' last pages fall outside the working
    set, so shared base pages also land in the RDMA store."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 255, HOT * PAGE, dtype=np.int64).astype(np.uint8)
    fleet = []
    for v in range(N_VARIANTS):
        w = base.copy()
        for d in range(DELTA):
            p = v * DELTA + d
            w[p * PAGE : (p + 1) * PAGE] = rng.integers(1, 255, PAGE).astype(np.uint8)
        cold = rng.integers(1, 255, COLD * PAGE).astype(np.uint8)
        cold[5 * PAGE : 6 * PAGE] = cold[2 * PAGE : 3 * PAGE]
        w[7 * PAGE : 8 * PAGE] = 0                          # a zero page mid-weights
        arrays = {"w": w, "cold": cold, "z": np.zeros(ZERO * PAGE, np.uint8)}
        ws = sorted(set(range(HOT - 6)) | {HOT + 3, HOT + 4})
        fleet.append((arrays, ws))
    return fleet


def _routes(route):
    """(ref build kwargs, ref pool kwargs, port build kwargs, port pool kwargs)."""
    if route == "default":
        return {}, {}, {}, {}
    if route == "piecemeal":
        gather = lambda mat, idx: np.asarray(ref_page_gather(mat, idx, **INTERP))  # noqa: E731
        return ({"gather_fn": gather}, {"dedup_hash_fn": _ref_poly_hash}, {},
                {"dedup_hash_fn": port.poly32_hash_fn})
    return ({"publish_fn": ref_publish_fn(block_pages=8, **INTERP)},
            {"dedup_hash_fn": _ref_poly_hash},
            {"publish_fn": make_fused_publish_fn()}, {"dedup_hash_fn": port.poly32_hash_fn})


@pytest.fixture
def ref_zero_scan_pallas():
    prev = set_zero_scan_backend(lambda m: pallas_zero_scan(m))
    yield
    set_zero_scan_backend(prev)


def _assert_pools_equal(pool_r, pool_g):
    for t in ("cxl", "rdma"):
        np.testing.assert_array_equal(getattr(pool_r, t).buf, getattr(pool_g, t).buf.numpy())
        assert getattr(pool_r, t)._free == getattr(pool_g, t).free_list()
        assert getattr(pool_r, t).bytes_in_use == getattr(pool_g, t).bytes_in_use
    for s in ("dedup_cxl", "dedup_rdma"):
        assert dedup_store_state(getattr(pool_g, s)) == _ref_state(getattr(pool_r, s))


def publish_fleet(route="default"):
    kr, pr, kg, pg = _routes(route)
    pool_r = ref.HierarchicalPool(CXL, RDMA, **pr)
    pool_g = port.HierarchicalPool(CXL, RDMA, device="cpu", **pg)
    pool_r.cxl.alloc(2 * PAGE)
    pool_g.cxl.alloc(2 * PAGE)
    out = []
    for v, (arrays, ws) in enumerate(make_fleet()):
        img_r = ref.StateImage.build(arrays)
        img_g = port.StateImage.build(arrays, device="cpu")
        est_r = ref.estimate_snapshot_cxl_size(img_r, ws, dedup=True, pool=pool_r)
        est_g = port.estimate_snapshot_cxl_size(img_g, ws, dedup=True, pool=pool_g)
        assert est_g == est_r
        before = pool_g.cxl.bytes_in_use
        reg_r = ref.build_snapshot(pool_r, img_r, ws, f"v{v}", version=v, dedup=True, **kr)
        reg_g = port.build_snapshot(pool_g, img_g, ws, f"v{v}", version=v, dedup=True, **kg)
        assert pool_g.cxl.bytes_in_use - before == est_g
        assert dataclasses.asdict(reg_r) == dataclasses.asdict(reg_g)
        assert reg_g.dedup and reg_g.rdma_size == 0 and reg_g.n_zero > 0
        _assert_pools_equal(pool_r, pool_g)
        cs_r = getattr(reg_r, "page_checksums", None)
        cs_g = getattr(reg_g, "page_checksums", None)
        assert (cs_r is None) == (cs_g is None) == (route != "fused")
        if cs_g is not None:
            np.testing.assert_array_equal(cs_g.numpy().view(np.uint32), cs_r)
        out.append((img_r, img_g, reg_r, reg_g, ws))
    return pool_r, pool_g, out


@pytest.mark.parametrize("route", ["default", "piecemeal", "fused"])
def test_fleet_publish_reconstruct_free_match_reference(route, ref_zero_scan_pallas):
    pool_r, pool_g, fleet = publish_fleet(route)
    st = pool_g.dedup_cxl.stats
    # base hot pages (page 7 is zero) + the deltas (one of them zeroed) + the
    # two hot pages of each variant's own cold arena
    assert st["unique"] == (HOT - 6 - 1) + (N_VARIANTS * DELTA - 1) + 2 * N_VARIANTS
    assert st["dedup_hits"] > 0 and pool_g.dedup_rdma.stats["dedup_hits"] > 0
    for img_r, img_g, reg_r, reg_g, _ws in fleet:
        for tag in (port.TIER_CXL, port.TIER_RDMA):
            np.testing.assert_array_equal(port.decode_dedup_offsets(pool_g, reg_g, tag),
                                          ref.decode_dedup_offsets(pool_r, reg_r, tag))
        assert (port.exclusive_cxl_bytes(pool_g, reg_g)
                == ref.exclusive_cxl_bytes(pool_r, reg_r))
        back_g = port.reconstruct_image(pool_g, reg_g)
        back_r = ref.reconstruct_image(pool_r, reg_r)
        np.testing.assert_array_equal(back_g.buf.numpy(), img_g.buf.numpy())
        np.testing.assert_array_equal(back_g.buf.numpy(), back_r.buf)
    for _img_r, _img_g, reg_r, reg_g, _ws in fleet:
        ref.free_snapshot(pool_r, reg_r)
        port.free_snapshot(pool_g, reg_g)
        _assert_pools_equal(pool_r, pool_g)
    for s in (pool_g.dedup_cxl, pool_g.dedup_rdma):
        assert s.refcounts() == {} and s.unique_pages() == 0
    assert pool_g.cxl.bytes_in_use == 2 * PAGE and pool_g.rdma.bytes_in_use == 0


def test_fused_route_hands_checksums_to_the_stores():
    """With the fused sweep and a poly32 store, no store hash runs: the
    sweep's checksum column is the hash (same buckets as the kernel hash)."""
    calls = []

    def counting_hash(m):
        calls.append(m.shape[0])
        return port.poly32_hash_fn(m)

    counting_hash.is_poly32 = True
    arrays, ws = make_fleet()[0]
    pool = port.HierarchicalPool(CXL, RDMA, device="cpu", dedup_hash_fn=counting_hash)
    img = port.StateImage.build(arrays, device="cpu")
    r0 = port.build_snapshot(pool, img, ws, "f", dedup=True, publish_fn=make_fused_publish_fn())
    assert calls == []
    hits = pool.dedup_cxl.stats["dedup_hits"], pool.dedup_rdma.stats["dedup_hits"]
    r1 = port.build_snapshot(pool, img, ws, "k", dedup=True)
    assert calls and pool.dedup_cxl.stats["dedup_hits"] - hits[0] == r1.n_hot
    assert pool.dedup_rdma.stats["dedup_hits"] - hits[1] == r1.n_cold
    for r in (r0, r1):
        port.free_snapshot(pool, r)


def test_reader_extents_and_lookups_match():
    pool_r, pool_g, fleet = publish_fleet("default")
    for _img_r, _img_g, reg_r, reg_g, _ws in fleet[1:3]:
        lr, lg = ref.TimeLedger(), port.TimeLedger()
        rr = ref.SnapshotReader(reg_r, pool_r.host_view("h", lr), pool_r.rdma)
        rg = port.SnapshotReader(reg_g, pool_g.host_view("h", lg), pool_g.rdma)
        rr.invalidate_cxl()
        rg.invalidate_cxl()
        np.testing.assert_array_equal(rr.offset_array(), rg.offset_array())
        for chunk in (4, 256):
            got = list(rg.iter_hot_extents(chunk))
            want = list(rr.iter_hot_extents(chunk))
            assert len(got) == len(want) > 1
            for (pg, og, ng), (pw, ow, nw) in zip(got, want):
                np.testing.assert_array_equal(pg, pw)
                assert (og, ng) == (ow, nw)
        for kw in ({}, {"max_extent_pages": 3}, {"max_extent_pages": 5, "largest_first": False},
                   {"max_extent_pages": 1 << 30}):
            assert list(rg.iter_cold_extents(**kw)) == list(rr.iter_cold_extents(**kw))
        for page in range(reg_g.total_pages):
            assert rg.lookup(page) == rr.lookup(page)
            np.testing.assert_array_equal(rg.read_page(page).numpy(), rr.read_page(page))
        page = int(rg.cold_page_indices()[0])
        assert rg.cold_rank(page) == rr.cold_rank(page)
        assert rg.cold_extent_span(7, 2) == rr.cold_extent_span(7, 2)
        assert rg.view.stats == rr.view.stats and lg.seconds == lr.seconds


def _restore_pair(route, v=2, scatter=True, rdma_engine=False, inject=None):
    pool_r, pool_g, fleet = publish_fleet(route)
    img_r, img_g, reg_r, reg_g, _ws = fleet[v]
    if inject is not None:
        pool_r.attach_fault_injector(inject(ref_faults, reg_r, pool_r))
        pool_g.attach_fault_injector(inject(faults, reg_g, pool_g))
    out = []
    for mod, img, pool, reg, sf in (
            (ref, img_r, pool_r, reg_r, RefFusedScatter(**INTERP) if scatter else None),
            (port, img_g, pool_g, reg_g, FusedScatter() if scatter else None)):
        ledger = mod.TimeLedger()
        reader = mod.SnapshotReader(reg, pool.host_view("h", ledger), pool.rdma)
        reader.invalidate_cxl()
        kw = {} if mod is ref else {"device": "cpu"}
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **kw), ledger)
        eng_rdma = mod.AsyncRDMAEngine(pool.rdma, ledger, host="h") if rdma_engine else None
        eng = mod.RestoreEngine(reader, inst, rdma_engine=eng_rdma, scatter_fn=sf)
        out.append((img, pool, reg, reader, inst, eng, ledger, sf))
    return out


def _assert_same(r, g, scatter=True):
    np.testing.assert_array_equal(r[4].image.buf, g[4].image.buf.numpy())
    np.testing.assert_array_equal(r[4].present, g[4].present)
    assert r[6].seconds == g[6].seconds
    assert r[4].stats == g[4].stats
    assert r[3].view.stats == g[3].view.stats
    assert r[5].repair_stats == g[5].repair_stats
    assert r[5].retry_trace == g[5].retry_trace
    if scatter:
        assert r[7].stats == g[7].stats


@pytest.mark.parametrize("route,scatter", [("default", False), ("piecemeal", False),
                                           ("fused", True), ("fused", False)])
def test_install_all_sync_matches(route, scatter, ref_zero_scan_pallas):
    r, g = _restore_pair(route, scatter=scatter)
    for side in (r, g):
        side[5].pre_install_hot(chunk_pages=8)
    _assert_same(r, g, scatter)
    for side in (r, g):
        side[5].install_all_sync()
    _assert_same(r, g, scatter)
    assert g[4].all_present()
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    if scatter:
        assert g[7].stats["pages_verified"] == g[2].n_hot + g[2].n_cold


def test_per_page_path_matches():
    r, g = _restore_pair("default", scatter=False)
    for side in (r, g):
        side[5].pre_install_hot(use_batch=False)
        side[5].install_all_sync(use_batch=False)
    _assert_same(r, g, scatter=False)
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_demand_faults_match():
    r, g = _restore_pair("fused", v=1, rdma_engine=True)
    touches = [0, 3, 7, 9, 33, 36, 41, 44, 45, 47, 60, 70, 71]
    try:
        for side in (r, g):
            side[5].start_completion_handler()
            for p in touches:
                side[5].access(p, timeout_s=10.0)
    finally:
        for side in (r, g):
            side[5].stop()
            side[5].rdma_engine.close()
    _assert_same(r, g)
    assert g[4].stats["fault_rdma"] > 0 and g[4].stats["fault_cxl"] > 0
    assert g[5].buffers.outstanding == 0
    src = g[0].pages_matrix().numpy()
    np.testing.assert_array_equal(g[4].image.pages_matrix().numpy()[touches], src[touches])


def _poison_shared_hot_page(fmod, reg, pool):
    """Poison the first two reads of a hot page every variant shares: the
    hot-chunk read and the repair's first re-read."""
    reader = (ref if fmod is ref_faults else port).SnapshotReader(
        reg, pool.host_view("probe"), pool.rdma)
    kind, off = reader.lookup(12)
    assert kind == "cxl"
    return fmod.FaultInjector(seed=1).poison_reads("cxl", 2, off, off + PAGE)


def test_corrupt_shared_cxl_page_quarantined_and_rematerialized():
    r, g = _restore_pair("fused", v=3, inject=_poison_shared_hot_page)
    for side in (r, g):
        side[5].install_all_sync()
    _assert_same(r, g)
    rs = g[5].repair_stats
    assert rs["quarantined"] == rs["rematerialized"] == 1 and rs["checksum_repairs"] == 1
    assert g[1].fault_injector.stats == r[1].fault_injector.stats
    assert (dedup_store_state(g[1].dedup_cxl) == _ref_state(r[1].dedup_cxl))
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_reconstruct_under_poisoned_reads_matches():
    """Owner-side reconstruction with an armed injector reads run by run like
    the reference: the same checks, the same poisoned bytes."""
    pool_r, pool_g, fleet = publish_fleet("default")
    _img_r, _img_g, reg_r, reg_g, _ws = fleet[2]
    lo = int(port.decode_dedup_offsets(pool_g, reg_g, port.TIER_RDMA).min())
    pool_r.attach_fault_injector(ref_faults.FaultInjector(seed=2).poison_reads(
        "rdma", 3, lo, lo + 8 * PAGE))
    pool_g.attach_fault_injector(faults.FaultInjector(seed=2).poison_reads(
        "rdma", 3, lo, lo + 8 * PAGE))
    back_r = ref.reconstruct_image(pool_r, reg_r)
    back_g = port.reconstruct_image(pool_g, reg_g)
    np.testing.assert_array_equal(back_g.buf.numpy(), back_r.buf)
    assert pool_g.fault_injector.stats == pool_r.fault_injector.stats
    assert pool_g.fault_injector.stats["injected_poison"] == 3
