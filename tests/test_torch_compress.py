"""Port parity of the zstd-compressed cold tier (``compress_cold``): the twins
of the reference's compress cases (``tests/test_extensions.py``
``TestCompressedColdTier``, ``tests/test_recuration.py``'s reconstruct and
estimate cases, ``tests/test_serving_batched.py``'s batched-vs-per-page
case) with both packages given the same numpy-seeded images: regions, tier
bytes and the cold-length index, ``reconstruct_image``, restores on both walk
routes, demand faults (synchronous, through the async engine and through a
node server) and ``estimate_snapshot_cxl_size`` are ``==``, ledgers
included.  Skipped where ``zstandard`` is missing, as the reference's are;
the last case, ``_zstd`` set to None in both packages, needs no zstandard:
such a publish stores the cold tier uncompressed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as ref
from repro.core import snapshot as ref_snapshot
from repro.core.profiler import AccessRecorder
from repro.kernels import FusedScatter as RefFusedScatter
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro_torch import core as port
from repro_torch.core import snapshot as port_snapshot
from repro_torch.kernels import FusedScatter, make_fused_publish_fn

PAGE = 4096
needs_zstd = pytest.mark.skipif(port_snapshot._zstd is None or ref_snapshot._zstd is None,
                                reason="zstandard not installed (optional extra)")


def _kw(mod):
    return {} if mod is ref else {"device": "cpu"}


def extensions_image(seed=0):
    """``tests/test_extensions.py``'s image: compressible runtime bytes."""
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal((3000,)).astype(np.float32),
        "runtime": rng.integers(0, 4, (120000,)).astype(np.uint8),
        "arena": np.zeros((32, 1024), np.float32),
    }
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("params")
    return arrays, rec.working_set()


def noise_image(seed=1):
    """Random bytes do not compress: every cold page is stored raw."""
    rng = np.random.default_rng(seed)
    arrays = {"noise": rng.integers(0, 256, (64 * PAGE,), dtype=np.uint8),
              "hot": rng.standard_normal((512,)).astype(np.float32)}
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("hot")
    return arrays, rec.working_set()


def recuration_image(seed=0, hot_pages=32, cold_pages=64, zero_pages=16):
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal(hot_pages * PAGE // 4).astype(np.float32),
        "runtime": rng.integers(1, 7, (cold_pages * PAGE,)).astype(np.uint8),
        "arena": np.zeros(zero_pages * PAGE, np.uint8),
    }
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("params")
    return arrays, rec.working_set()


def fragmented_image(seed=0):
    """``tests/test_serving_batched.py``'s fragmented image."""
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal((40000,)).astype(np.float32),
        "emb": np.zeros((128, 1024), np.float32),
        "runtime": rng.integers(1, 7, (200 * PAGE,)).astype(np.uint8),
        "arena": np.zeros((48, 1024), np.float32),
    }
    arrays["emb"][::4] = rng.standard_normal((32, 1024)).astype(np.float32)
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("params")
    rec.touch_rows("emb", [0, 4, 8, 40, 44])
    rt = rec.manifest.by_name()["runtime"]
    for s in (3, 9, 17, 50, 51, 52, 120):
        rec.touch_pages(range(rt.first_page + s, rt.first_page + s + 2))
    return arrays, rec.working_set()


def publish_both(arrays, ws, fused=False, compress_cold=True, metadata=None):
    """The same image published through each package's ``PoolMaster``."""
    out = []
    for mod in (ref, port):
        img = mod.StateImage.build(arrays, **_kw(mod))
        pool = mod.HierarchicalPool(32 << 20, 64 << 20, **_kw(mod))
        pool.cxl.alloc(3 * PAGE)        # a non-zero region base on both
        fn = None
        if fused:
            fn = (ref_publish_fn(block_pages=64, use_pallas=True, interpret=True)
                  if mod is ref else make_fused_publish_fn())
        master = mod.PoolMaster(pool, publish_fn=fn)
        regions = master.publish("z", img, ws, compress_cold=compress_cold,
                                 metadata=metadata)
        out.append((img, pool, master, regions))
    return out


def _assert_published_equal(r, g):
    (_, pool_r, _, reg_r), (_, pool_g, _, reg_g) = r, g
    assert dataclasses.asdict(reg_r) == dataclasses.asdict(reg_g)
    for t in ("cxl", "rdma"):
        tr, tg = getattr(pool_r, t), getattr(pool_g, t)
        np.testing.assert_array_equal(tr.buf, tg.buf.numpy())
        assert tr._free == tg.free_list()
        assert tr.bytes_in_use == tg.bytes_in_use


@needs_zstd
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("make", [extensions_image, noise_image, recuration_image],
                         ids=["compressible", "incompressible", "recuration"])
def test_publish_regions_bytes_and_cold_index_equal(make, fused):
    r, g = publish_both(*make(), fused=fused)
    _assert_published_equal(r, g)
    reg = g[3]
    assert reg.cold_compressed and reg.ci_size > 0
    assert reg.cold_raw_bytes == reg.n_cold * PAGE
    if make is noise_image:
        assert reg.cold_bytes >= reg.cold_raw_bytes * 0.95
    else:
        assert reg.cold_bytes < reg.cold_raw_bytes
    readers = [mod.SnapshotReader(side[3], side[1].host_view("h"), side[1].rdma)
               for mod, side in ((ref, r), (port, g))]
    (st_r, ci_r), (st_g, ci_g) = (rd.cold_index() for rd in readers)
    np.testing.assert_array_equal(st_r, st_g)
    np.testing.assert_array_equal(ci_r, ci_g)
    for rank in range(reg.n_cold):
        assert readers[0].cold_extent(rank) == readers[1].cold_extent(rank)
    for page in range(reg.total_pages):
        assert readers[0].lookup(page) == readers[1].lookup(page)
        np.testing.assert_array_equal(readers[0].read_page(page),
                                      readers[1].read_page(page).numpy())
    for rd in readers:
        rd.view.stats.pop("bytes_read", None)
    assert readers[0].view.stats == readers[1].view.stats
    assert readers[0].view.ledger.seconds == readers[1].view.ledger.seconds


@needs_zstd
@pytest.mark.parametrize("make", [recuration_image, extensions_image, noise_image])
def test_reconstruct_image_equal(make):
    r, g = publish_both(*make())
    rebuilt_r = ref.reconstruct_image(r[1], r[3])
    rebuilt_g = port.reconstruct_image(g[1], g[3])
    np.testing.assert_array_equal(rebuilt_g.buf.numpy(), rebuilt_r.buf)
    np.testing.assert_array_equal(rebuilt_g.buf.numpy(), g[0].buf.numpy())
    assert rebuilt_g.manifest.to_dict() == rebuilt_r.manifest.to_dict()


@needs_zstd
@pytest.mark.parametrize("metadata", [None, {"origin": "test", "n": 3}])
def test_estimate_matches_build(metadata):
    arrays, ws = recuration_image()
    r, g = publish_both(arrays, ws, metadata=metadata)
    est_r = ref.estimate_snapshot_cxl_size(r[0], ws, metadata=metadata, compress_cold=True)
    est_g = port.estimate_snapshot_cxl_size(g[0], ws, metadata=metadata, compress_cold=True)
    assert est_r == est_g == g[3].cxl_size
    plain = port.estimate_snapshot_cxl_size(g[0], ws, metadata=metadata)
    assert est_g - plain == g[3].ci_size > 0


class _PerExtentScatter:
    """A scatter with no batched form: the walk runs per extent."""

    def __init__(self):
        self.inner = FusedScatter()

    def bind_checksums(self, table):
        self.inner.bind_checksums(table)
        return self

    def __call__(self, *args, **kwargs):
        return self.inner(*args, **kwargs)


def _engines(r, g, scatter, rdma_engine=False):
    out = []
    for mod, (img, pool, _m, reg) in ((ref, r), (port, g)):
        ledger = mod.TimeLedger()
        reader = mod.SnapshotReader(reg, pool.host_view("h", ledger), pool.rdma)
        reader.invalidate_cxl()
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **_kw(mod)), ledger)
        sf = None
        if scatter == "verified":
            sf = RefFusedScatter(use_pallas=True, interpret=True) if mod is ref else FusedScatter()
        elif scatter == "per_extent":
            sf = (RefFusedScatter(use_pallas=True, interpret=True) if mod is ref
                  else _PerExtentScatter())
        eng_rdma = mod.AsyncRDMAEngine(pool.rdma, ledger, host="h") if rdma_engine else None
        eng = mod.RestoreEngine(reader, inst, rdma_engine=eng_rdma, scatter_fn=sf)
        out.append((img, inst, eng, ledger, reader))
    return out


def _assert_restores_equal(a, b):
    (img_r, inst_r, eng_r, led_r, rd_r), (_img_g, inst_g, eng_g, led_g, rd_g) = a, b
    np.testing.assert_array_equal(inst_g.image.buf.numpy(), inst_r.image.buf)
    np.testing.assert_array_equal(inst_g.present, inst_r.present)
    assert led_r.seconds == led_g.seconds          # same floats, same order
    assert inst_r.stats == inst_g.stats
    assert rd_r.view.stats == rd_g.view.stats
    assert eng_r.repair_stats == eng_g.repair_stats


@needs_zstd
@pytest.mark.parametrize("scatter,route", [
    ("verified", "batched"), (None, "batched"), ("per_extent", "scatter_fn")])
def test_restore_walks_equal_on_both_routes(scatter, route):
    r, g = publish_both(*fragmented_image(), fused=scatter is not None)
    a, b = _engines(r, g, scatter)
    for side in (a, b):
        side[2].install_all_sync()
    _assert_restores_equal(a, b)
    np.testing.assert_array_equal(b[1].image.buf.numpy(), b[0].buf.numpy())
    routes = b[2].walk_routes
    if route == "batched":
        assert routes["batched"] == 2
    else:
        assert routes["batched"] == 0 and routes["per_extent"][route] == 2
    if scatter == "verified":
        reg = g[3]
        assert b[1].scatter_fn.stats["pages_verified"] == reg.n_hot + reg.n_cold


@needs_zstd
def test_batched_vs_per_page_bit_identical():
    """Twin of ``TestBatchedRestoreBitIdentical.test_batched_vs_perpage``
    with ``compress=True``."""
    r, g = publish_both(*fragmented_image())
    for batch in (False, True):
        a, b = _engines(r, g, None)
        for side in (a, b):
            side[2].pre_install_hot(use_batch=batch)
            side[2].install_all_sync(use_batch=batch)
        _assert_restores_equal(a, b)
        np.testing.assert_array_equal(b[1].image.buf.numpy(), g[0].buf.numpy())


@needs_zstd
@pytest.mark.parametrize("async_engine", [False, True])
def test_demand_faults_on_compressed_cold_pages(async_engine):
    r, g = publish_both(*extensions_image(), fused=True)
    a, b = _engines(r, g, "verified", rdma_engine=async_engine)
    cold = b[4].cold_page_indices()
    touches = [int(p) for p in cold[:: max(1, cold.size // 9)]] + [0, int(cold[-1])]
    try:
        for side in (a, b):
            if async_engine:
                side[2].start_completion_handler()
            side[2].pre_install_hot()
            for p in touches:
                side[2].access(p, timeout_s=10.0)
    finally:
        for side in (a, b):
            side[2].stop()
            if async_engine:
                side[2].rdma_engine.close()
    _assert_restores_equal(a, b)
    assert b[1].stats["fault_rdma"] == len(set(touches) & set(cold.tolist()))
    got = b[1].image.pages_matrix().numpy()
    np.testing.assert_array_equal(got[touches], g[0].pages_matrix().numpy()[touches])
    if async_engine:
        assert b[2].buffers.outstanding == 0


@needs_zstd
def test_node_server_completes_compressed_demand_reads():
    arrays, ws = fragmented_image(seed=3)
    sides = []
    for mod in (ref, port):
        img = mod.StateImage.build(arrays, **_kw(mod))
        pool = mod.HierarchicalPool(64 << 20, 64 << 20, **_kw(mod))
        master = mod.PoolMaster(pool)
        master.publish("s", img, ws, compress_cold=True)
        server = mod.NodePageServer("h0", pool)
        orch = mod.Orchestrator("h0", pool, master.catalog, node_server=server)
        ri = orch.restore("s", pre_install=False, prefetch_cold=False)
        sides.append((img, server, ri))
    cold = sides[1][2].engine.reader.cold_page_indices()
    touches = [int(p) for p in cold[::17]]
    for _img, _srv, ri in sides:
        assert ri.engine.reader.regions.cold_compressed
        ri.engine.pre_install_hot()
        for p in touches:
            ri.engine.access(p, timeout_s=10.0)
    (img_r, srv_r, ri_r), (img_g, srv_g, ri_g) = sides
    assert ri_r.ledger.seconds == ri_g.ledger.seconds
    assert ri_r.instance.stats == ri_g.instance.stats
    assert srv_g.stats["demand_reads"] == srv_r.stats["demand_reads"] == len(touches)
    for _img, _srv, ri in sides:
        ri.engine.install_all_sync()
    assert ri_r.ledger.seconds == ri_g.ledger.seconds
    np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), ri_r.instance.image.buf)
    np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), img_g.buf.numpy())
    for _img, srv, ri in sides:
        ri.shutdown()
        srv.close()


@needs_zstd
@pytest.mark.parametrize("make,use_async", [(extensions_image, True), (noise_image, False)],
                         ids=["roundtrip", "incompressible"])
def test_orchestrator_restores_like_the_reference(make, use_async):
    """Twins of ``TestCompressedColdTier``: every page touched through the
    async engine, or one synchronous walk."""
    r, g = publish_both(*make())
    out = []
    for mod, (img, pool, master, _reg) in ((ref, r), (port, g)):
        orch = mod.Orchestrator("h", pool, master.catalog, use_async_rdma=use_async)
        ri = orch.restore("z")
        if use_async:
            for p in range(img.total_pages):
                ri.engine.access(p)
        else:
            ri.engine.install_all_sync()
        out.append((img, ri))
    (img_r, ri_r), (img_g, ri_g) = out
    np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), img_g.buf.numpy())
    np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), ri_r.instance.image.buf)
    if not use_async:
        assert ri_r.ledger.seconds == ri_g.ledger.seconds
    for _img, ri in out:
        ri.shutdown()


@pytest.mark.parametrize("fused", [False, True])
def test_without_zstandard_publishes_uncompressed(monkeypatch, fused):
    """The reference's rule (``compress_cold and _zstd is not None``): with
    no zstandard a compress_cold publish is the uncompressed publish."""
    monkeypatch.setattr(ref_snapshot, "_zstd", None)
    monkeypatch.setattr(port_snapshot, "_zstd", None)
    arrays, ws = recuration_image(seed=5)
    r, g = publish_both(arrays, ws, fused=fused, compress_cold=True)
    _assert_published_equal(r, g)
    assert not g[3].cold_compressed and g[3].ci_size == 0
    plain = publish_both(arrays, ws, fused=fused, compress_cold=False)[1]
    assert dataclasses.asdict(plain[3]) == dataclasses.asdict(g[3])
    assert torch.equal(plain[1].cxl.buf, g[1].cxl.buf)
    assert torch.equal(plain[1].rdma.buf, g[1].rdma.buf)
    assert (port.estimate_snapshot_cxl_size(g[0], ws, compress_cold=True)
            == ref.estimate_snapshot_cxl_size(r[0], ws, compress_cold=True)
            == g[3].cxl_size)
    orch = port.Orchestrator("h", g[1], g[2].catalog, use_async_rdma=False)
    ri = orch.restore("z")
    ri.engine.install_all_sync()
    assert torch.equal(ri.instance.image.buf, g[0].buf)
    ri.shutdown()
