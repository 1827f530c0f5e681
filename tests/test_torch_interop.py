"""Port parity across packages: a snapshot the JAX package published (with
its fused publish kernel in Pallas interpret mode) is restored by the port
bit-identically, and a snapshot the port published is restored by the JAX
package; the numpy carriers round-trip exactly."""
import dataclasses

import numpy as np

from repro import core as ref
from repro.kernels import FusedScatter as RefFusedScatter
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro_torch import core as port
from repro_torch import interop
from repro_torch.kernels import FusedScatter, make_fused_publish_fn
from test_torch_snapshot import CXL, RDMA, make_image


def _restore_port(pool, regions, manifest):
    ledger = port.TimeLedger()
    reader = port.SnapshotReader(regions, pool.host_view("h", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = port.Instance(port.StateImage.empty_like(manifest, device="cpu"), ledger)
    eng = port.RestoreEngine(reader, inst, scatter_fn=FusedScatter())
    eng.pre_install_hot()
    eng.install_all_sync()
    return inst, ledger


def test_jax_published_snapshot_restored_by_port():
    arrays, ws = make_image(11)
    img_r = ref.StateImage.build(arrays)
    pool_r = ref.HierarchicalPool(CXL, RDMA)
    reg_r = ref.build_snapshot(pool_r, img_r, ws, "m", version=2, publish_fn=ref_publish_fn(
        block_pages=64, use_pallas=True, interpret=True))
    pool_g = interop.pool_from_numpy(pool_r.cxl.buf, pool_r.rdma.buf,
                                     {"cxl": pool_r.cxl._free, "rdma": pool_r.rdma._free},
                                     device="cpu")
    reg_g = interop.regions_from_dict(reg_r.to_dict(), page_checksums=reg_r.page_checksums)
    manifest = port.Manifest.from_dict(img_r.manifest.to_dict())
    inst, ledger = _restore_port(pool_g, reg_g, manifest)
    np.testing.assert_array_equal(inst.image.buf.numpy(), img_r.buf)
    assert inst.scatter_fn.stats["pages_verified"] == reg_r.n_hot + reg_r.n_cold
    assert pool_g.cxl.free_list_stats() == pool_r.cxl.free_list_stats()
    assert pool_g.cxl.bytes_in_use == pool_r.cxl.bytes_in_use
    # the same restore in the reference package charges the same modeled time
    led_r = ref.TimeLedger()
    rd = ref.SnapshotReader(reg_r, pool_r.host_view("h", led_r), pool_r.rdma)
    rd.invalidate_cxl()
    inst_r = ref.Instance(ref.StateImage.empty_like(img_r.manifest), led_r)
    eng_r = ref.RestoreEngine(rd, inst_r, scatter_fn=RefFusedScatter(use_pallas=True,
                                                                     interpret=True))
    eng_r.pre_install_hot()
    eng_r.install_all_sync()
    assert led_r.seconds == ledger.seconds


def test_port_published_snapshot_restored_by_jax():
    arrays, ws = make_image(12)
    img_g = port.StateImage.build(arrays, device="cpu")
    pool_g = port.HierarchicalPool(CXL, RDMA, device="cpu")
    reg_g = port.build_snapshot(pool_g, img_g, ws, "m", publish_fn=make_fused_publish_fn())
    cxl, rdma, free = interop.pool_to_numpy(pool_g)
    d, checksums = interop.regions_to_dict(reg_g)
    pool_r = ref.HierarchicalPool(CXL, RDMA)
    pool_r.cxl.buf[:] = cxl
    pool_r.rdma.buf[:] = rdma
    reg_r = ref.SnapshotRegions.from_dict(d)
    reg_r.page_checksums = checksums
    rd = ref.SnapshotReader(reg_r, pool_r.host_view("h"), pool_r.rdma)
    rd.invalidate_cxl()
    manifest_d, buf = interop.state_image_to_numpy(img_g)
    inst = ref.Instance(ref.StateImage.empty_like(ref.Manifest.from_dict(manifest_d)))
    sf = RefFusedScatter(use_pallas=True, interpret=True)
    ref.RestoreEngine(rd, inst, scatter_fn=sf).install_all_sync()
    np.testing.assert_array_equal(inst.image.buf, buf)
    assert sf.stats["pages_verified"] == reg_g.n_hot + reg_g.n_cold
    assert free["cxl"] == pool_g.cxl.free_list()


def test_carriers_round_trip():
    arrays, ws = make_image(13)
    img = port.StateImage.build(arrays, device="cpu")
    d, buf = interop.state_image_to_numpy(img)
    back = interop.state_image_from_numpy(d, buf, device="cpu")
    assert back.manifest.to_dict() == d
    np.testing.assert_array_equal(back.buf.numpy(), buf)
    pool = port.HierarchicalPool(CXL, RDMA, device="cpu")
    regions = port.build_snapshot(pool, img, ws, "m", publish_fn=make_fused_publish_fn())
    cxl, rdma, free = interop.pool_to_numpy(pool)
    pool2 = interop.pool_from_numpy(cxl, rdma, free, device="cpu")
    assert interop.pool_to_numpy(pool2)[2] == free
    assert pool2.rdma.bytes_in_use == pool.rdma.bytes_in_use
    d2, cs = interop.regions_to_dict(regions)
    regions2 = interop.regions_from_dict(d2, page_checksums=cs)
    assert dataclasses.asdict(regions2) == dataclasses.asdict(regions)
    np.testing.assert_array_equal(regions2.page_checksums.numpy(),
                                  regions.page_checksums.numpy())
    inst, _ = _restore_port(pool2, regions2, img.manifest)
    np.testing.assert_array_equal(inst.image.buf.numpy(), img.buf.numpy())


def test_jax_published_dedup_fleet_restored_and_freed_by_port():
    """The JAX package publishes a dedup fleet (fused sweep, poly32 stores,
    Pallas interpret mode); the port loads arenas, free lists and both store
    states, restores every variant bit-identically and verified, shares a
    re-publish with the loaded pages, and frees the fleet to empty stores."""
    from test_torch_dedup import _ref_state
    from test_torch_dedup_layout import _ref_poly_hash, make_fleet

    pool_r = ref.HierarchicalPool(CXL, RDMA, dedup_hash_fn=_ref_poly_hash)
    published = []
    for v, (arrays, ws) in enumerate(make_fleet(seed=3)):
        img = ref.StateImage.build(arrays)
        reg = ref.build_snapshot(pool_r, img, ws, f"v{v}", version=v, dedup=True,
                                 publish_fn=ref_publish_fn(block_pages=8, use_pallas=True,
                                                           interpret=True))
        published.append((img, reg))
    pool_g = interop.pool_from_numpy(
        pool_r.cxl.buf, pool_r.rdma.buf, {"cxl": pool_r.cxl._free, "rdma": pool_r.rdma._free},
        device="cpu", dedup_hash_fn=port.poly32_hash_fn,
        dedup_states={"cxl": _ref_state(pool_r.dedup_cxl), "rdma": _ref_state(pool_r.dedup_rdma)})
    assert interop.dedup_store_state(pool_g.dedup_rdma) == _ref_state(pool_r.dedup_rdma)
    assert pool_g.cxl.dedup_store is pool_g.dedup_cxl
    regions = []
    for img, reg in published:
        reg_g = interop.regions_from_dict(reg.to_dict(), page_checksums=reg.page_checksums)
        manifest = port.Manifest.from_dict(img.manifest.to_dict())
        inst, _ = _restore_port(pool_g, reg_g, manifest)
        np.testing.assert_array_equal(inst.image.buf.numpy(), img.buf)
        assert inst.scatter_fn.stats["pages_verified"] == reg.n_hot + reg.n_cold
        regions.append(reg_g)
    unique = pool_g.dedup_cxl.unique_pages(), pool_g.dedup_rdma.unique_pages()
    arrays, ws = make_fleet(seed=3)[0]
    again = port.build_snapshot(pool_g, port.StateImage.build(arrays, device="cpu"), ws, "again",
                                dedup=True, publish_fn=make_fused_publish_fn())
    assert (pool_g.dedup_cxl.unique_pages(), pool_g.dedup_rdma.unique_pages()) == unique
    for reg_g in regions + [again]:
        port.free_snapshot(pool_g, reg_g)
    for store in (pool_g.dedup_cxl, pool_g.dedup_rdma):
        assert store.refcounts() == {} and store.unique_pages() == 0
    assert pool_g.cxl.bytes_in_use == 0 and pool_g.rdma.bytes_in_use == 0
