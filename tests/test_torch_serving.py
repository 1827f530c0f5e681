"""Port parity: the restore half of the main path.  Publish → pre_install_hot
→ install_all_sync with the fused verified scatter, the per-page path,
demand faults through the async RDMA engine, and checksum repair — images,
ledgers (key by key, ``==``), instance/scatter/view/repair stats against the
JAX package with its fused kernels in Pallas interpret mode (exact)."""
import numpy as np
import pytest
import torch

from repro import core as ref
from repro.core import faults as ref_faults
from repro.kernels import FusedScatter as RefFusedScatter
from repro.kernels.snapshot_fuse.ops import ChecksumMismatchError as RefMismatch
from repro_torch import core as port
from repro_torch.core import faults
from repro_torch.core.serving import BufferPool
from repro_torch.kernels import ChecksumMismatchError, FusedScatter, fused_restore
from test_torch_snapshot import CXL, RDMA, make_image, publish_both

PAGE = 4096


def _restore_pair(fused_scatter=True, seed=0, rdma_engine=False):
    (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), ws = publish_both(seed=seed)
    out = []
    for mod, img, pool, reg, sf in (
            (ref, img_r, pool_r, reg_r,
             RefFusedScatter(use_pallas=True, interpret=True) if fused_scatter else None),
            (port, img_g, pool_g, reg_g, FusedScatter() if fused_scatter else None)):
        ledger = mod.TimeLedger()
        reader = mod.SnapshotReader(reg, pool.host_view("h", ledger), pool.rdma)
        reader.invalidate_cxl()
        kw = {} if mod is ref else {"device": "cpu"}
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **kw), ledger)
        eng_rdma = (mod.AsyncRDMAEngine(pool.rdma, ledger, host="h")
                    if rdma_engine else None)
        eng = mod.RestoreEngine(reader, inst, rdma_engine=eng_rdma, scatter_fn=sf)
        out.append((img, pool, reg, reader, inst, eng, ledger, sf))
    return out


def _assert_same(r, g, scatter=True):
    img_r, _, _, rd_r, inst_r, eng_r, led_r, sf_r = r
    img_g, _, _, rd_g, inst_g, eng_g, led_g, sf_g = g
    np.testing.assert_array_equal(inst_r.image.buf, inst_g.image.buf.numpy())
    np.testing.assert_array_equal(inst_r.present, inst_g.present)
    assert led_r.seconds == led_g.seconds          # same floats, same order
    assert inst_r.stats == inst_g.stats
    assert rd_r.view.stats == rd_g.view.stats
    assert eng_r.repair_stats == eng_g.repair_stats
    assert eng_r.retry_trace == eng_g.retry_trace
    if scatter:
        assert sf_r.stats == sf_g.stats


@pytest.mark.parametrize("chunk", [16, 256])
def test_publish_preinstall_install_all_milestone(chunk):
    r, g = _restore_pair()
    n_r = r[5].pre_install_hot(chunk_pages=chunk)
    n_g = g[5].pre_install_hot(chunk_pages=chunk)
    assert n_r == n_g == g[2].n_hot
    _assert_same(r, g)
    r[5].install_all_sync()
    g[5].install_all_sync()
    _assert_same(r, g)
    img_g, inst_g = g[0], g[4]
    assert inst_g.all_present()
    np.testing.assert_array_equal(inst_g.image.buf.numpy(), img_g.buf.numpy())
    sf = inst_g.scatter_fn
    assert sf.stats["pages_verified"] == g[2].n_hot + g[2].n_cold


def test_per_page_path_matches():
    r, g = _restore_pair(fused_scatter=False)
    for side in (r, g):
        side[5].pre_install_hot(use_batch=False)
        side[5].install_all_sync(use_batch=False)
    _assert_same(r, g, scatter=False)
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_unfused_batched_path_matches():
    r, g = _restore_pair(fused_scatter=False, seed=4)
    for side in (r, g):
        side[5].install_all_sync()
    _assert_same(r, g, scatter=False)
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_demand_faults_through_async_engine():
    r, g = _restore_pair(rdma_engine=True, seed=5)
    touches = [0, 1, 2, 60, 150, 151, 99, 188, 189, 30, 31]
    try:
        for side in (r, g):
            side[5].start_completion_handler()
            side[5].pre_install_hot()
            for p in touches:
                side[5].access(p, timeout_s=10.0)
    finally:
        for side in (r, g):
            side[5].stop()
            side[5].rdma_engine.close()
    _assert_same(r, g)
    assert g[4].stats["fault_rdma"] > 0 and g[4].stats["fault_zero"] > 0
    for side in (r, g):
        eng = side[5].rdma_engine
        assert not eng._worker.is_alive()
    assert g[5].rdma_engine.stats["reads"] == r[5].rdma_engine.stats["reads"]
    assert g[5].buffers.outstanding == 0
    src = g[0].pages_matrix().numpy()
    got = g[4].image.pages_matrix().numpy()
    np.testing.assert_array_equal(got[touches], src[touches])


def test_prefetcher_installs_every_cold_page():
    r, g = _restore_pair(rdma_engine=True, seed=6)
    r[5].rdma_engine.close()                 # the port side alone here
    eng = g[5]
    try:
        eng.start_completion_handler()
        eng.pre_install_hot()
        eng.install_zero_runs()
        eng.start_prefetcher(policy=port.LayoutOrderPolicy(8))
        assert eng.wait_prefetch_idle(timeout_s=10.0)
    finally:
        eng.stop()
        eng.rdma_engine.close()
    assert g[4].all_present()
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    assert eng.prefetch_stats["pages_installed"] == g[2].n_cold
    assert eng.buffers.outstanding == 0 and not eng._prefetch_thread.is_alive()


def test_poisoned_cxl_read_repaired_like_reference():
    r, g = _restore_pair(seed=7)
    lo = g[2].hot_off
    hi = lo + 3 * PAGE
    r[1].attach_fault_injector(ref_faults.FaultInjector(seed=1).poison_reads("cxl", 2, lo, hi))
    g[1].attach_fault_injector(faults.FaultInjector(seed=1).poison_reads("cxl", 2, lo, hi))
    r[5].install_all_sync()
    g[5].install_all_sync()
    _assert_same(r, g)
    assert g[5].repair_stats["checksum_repairs"] == 2
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_corrupted_cxl_byte_exhausts_repair_like_reference():
    r, g = _restore_pair(seed=8)
    at = g[2].hot_off + 5 * PAGE + 100
    r[1].cxl.buf[at] ^= 0xFF
    g[1].cxl.buf[at] ^= 0xFF
    with pytest.raises(RefMismatch) as want:
        r[5].install_all_sync()
    with pytest.raises(ChecksumMismatchError) as got:
        g[5].install_all_sync()
    np.testing.assert_array_equal(got.value.bad_pages, want.value.bad_pages)
    assert r[5].repair_stats == g[5].repair_stats
    assert g[5].repair_stats["repair_failures"] == 1
    assert r[6].seconds == g[6].seconds
    assert r[4].stats == g[4].stats


def test_buffer_pool_conserves_buffers():
    bp = BufferPool(4, device="cpu")
    bufs = [bp.acquire() for _ in range(3)]
    assert bp.outstanding == 3 and bufs[0].shape == (PAGE,)
    for b in bufs:
        bp.release(b)
    assert bp.outstanding == 0


def test_instance_batch_skips_present_pages_via_src_indices():
    img = port.StateImage.empty_like(port.Manifest([], 8), device="cpu")
    inst = port.Instance(img, scatter_fn=FusedScatter())
    rows = np.arange(4 * PAGE, dtype=np.int64).astype(np.uint8).reshape(4, PAGE)
    inst.present[3] = True
    before = fused_restore.launches
    assert inst.uffd_copy_batch(np.array([1, 3, 4, 6]), torch.from_numpy(rows)) == 3
    got = img.pages_matrix().numpy()
    np.testing.assert_array_equal(got[[1, 4, 6]], rows[[0, 2, 3]])
    assert not got[3].any()
    assert inst.scatter_fn.stats == {"batches": 1, "pages": 3, "pages_verified": 0}
    assert fused_restore.launches == before        # CPU tensors: the plain version


def test_cxl_brownout_degrades_to_rdma_like_reference():
    """A browned-out CXL link trips the breaker: the hot set is served over
    the RDMA path instead, bit-identically, at the same modeled cost."""
    from repro.sim.clock import VirtualClock

    out = []
    for mod, fmod in ((ref, ref_faults), (port, faults)):
        arrays, ws = make_image(9)
        kw = {} if mod is ref else {"device": "cpu"}
        clock = VirtualClock()
        img = mod.StateImage.build(arrays, **kw)
        pool = mod.HierarchicalPool(CXL, RDMA, clock=clock, **kw)
        regions = mod.build_snapshot(pool, img, ws, "b")
        pool.attach_fault_injector(fmod.FaultInjector(clock=clock).brownout("cxl", 0.0, 1.0))
        ledger = mod.TimeLedger()
        reader = mod.SnapshotReader(regions, pool.host_view("h", ledger), pool.rdma)
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **kw), ledger)
        eng = mod.RestoreEngine(reader, inst, clock=clock)
        eng.install_all_sync()
        out.append((img, inst, eng, ledger, reader, pool))
    (img_r, inst_r, eng_r, led_r, rd_r, pool_r), (img_g, inst_g, eng_g, led_g, rd_g, pool_g) = out
    np.testing.assert_array_equal(inst_g.image.buf.numpy(), img_g.buf.numpy())
    np.testing.assert_array_equal(inst_r.image.buf, inst_g.image.buf.numpy())
    assert eng_g.degraded_cxl and eng_g.repair_stats["degraded_faults"] > 0
    assert eng_r.repair_stats == eng_g.repair_stats
    assert inst_r.stats == inst_g.stats
    assert rd_r.view.stats == rd_g.view.stats
    assert led_r.seconds == led_g.seconds
    assert pool_r.fault_injector.stats == pool_g.fault_injector.stats
    assert pool_r.health["cxl"].stats == pool_g.health["cxl"].stats
