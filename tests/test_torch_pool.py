"""Port parity: the two-tier pool — allocator, ledgers, and the vectorized
incoherent HostView cache — against the JAX package's pool (exact)."""
import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro.core import pool as ref_pool
from repro_torch.core import faults, pool

PAGE = 4096
CXL, RDMA = 1 << 20, 2 << 20


def _pools():
    return (ref_pool.HierarchicalPool(CXL, RDMA),
            pool.HierarchicalPool(CXL, RDMA, device="cpu"))


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_scripted_alloc_free_same_offsets_and_free_lists():
    ref, got = _pools()
    script = [("a", "cxl", 5000), ("a", "cxl", 4096), ("a", "rdma", 70000),
              ("a", "cxl", 1), ("f", 1), ("a", "cxl", 9000), ("f", 0),
              ("a", "rdma", 4096 * 3), ("f", 2), ("f", 3), ("a", "cxl", 12288),
              ("f", 5), ("a", "rdma", 200000), ("f", 4)]
    held = []
    for step in script:
        if step[0] == "a":
            _, tier, n = step
            o_ref = ref.tier(0 if tier == "cxl" else 1).alloc(n)
            o_got = got.tier(0 if tier == "cxl" else 1).alloc(n)
            assert o_ref == o_got
            held.append((tier, o_ref, n))
        else:
            tier, off, n = held[step[1]]
            ref.tier(0 if tier == "cxl" else 1).free(off, n)
            got.tier(0 if tier == "cxl" else 1).free(off, n)
        for name in ("cxl", "rdma"):
            rt, gt = getattr(ref, name), getattr(got, name)
            assert rt.free_list_stats() == gt.free_list_stats()
            assert rt._free == gt.free_list()
            assert rt.bytes_in_use == gt.bytes_in_use
    for tier in (ref.cxl, got.cxl):
        with pytest.raises(RuntimeError, match="cannot alloc"):
            tier.alloc(CXL)


def test_ledger_and_arbiter_charges_equal():
    ref, got = _pools()
    lr, lg = ref_pool.TimeLedger(), pool.TimeLedger()
    for p, led in ((ref, lr), (got, lg)):
        arb = p.rdma.arbiter_for("h")
        for k, n in enumerate((4096, 65536, 1 << 20, 12345)):
            if k == 2:
                arb.register("x")
                arb.register("y")
            led.add("rdma_read", arb.charge(n))
            led.add("rdma_prefetch", arb.charge_pipelined(n, 1 + k * 40))
            led.add("uffd_copy", ref_pool.uffd_copy_batch_cost(k + 1, k)
                    if p is ref else pool.uffd_copy_batch_cost(k + 1, k))
    assert lr.seconds == lg.seconds
    assert lr.total() == lg.total()


@pytest.mark.parametrize("off,n", [(0, PAGE), (100, 3000), (64 * 7 + 5, 64 * 20)])
def test_hostview_stale_without_invalidate_fresh_after(off, n):
    ref, got = _pools()
    old, new = _bytes(2 * PAGE, 1), _bytes(2 * PAGE, 2)
    ref.cxl.write(0, old)
    got.cxl.write(0, torch.from_numpy(old))
    lr, lg = ref_pool.TimeLedger(), pool.TimeLedger()
    vr, vg = ref.host_view("h", lr), got.host_view("h", lg)
    # warm a prefix only, so the next read mixes hits and misses
    np.testing.assert_array_equal(vr.read(off, n // 2), vg.read(off, n // 2).numpy())
    np.testing.assert_array_equal(vr.read(off, n), vg.read(off, n).numpy())
    # owner-side update: a host that skips invalidate reads stale lines
    ref.cxl.write(0, new)
    got.cxl.write(0, torch.from_numpy(new))
    stale_r, stale_g = vr.read(off, n), vg.read(off, n).numpy()
    np.testing.assert_array_equal(stale_r, stale_g)
    np.testing.assert_array_equal(stale_g, old[off : off + n])
    vr.invalidate(off, n)
    vg.invalidate(off, n)
    fresh_r, fresh_g = vr.read(off, n), vg.read(off, n).numpy()
    np.testing.assert_array_equal(fresh_r, fresh_g)
    np.testing.assert_array_equal(fresh_g, new[off : off + n])
    assert vr.stats == vg.stats
    assert lr.seconds == lg.seconds
    vr.drop_all()
    vg.drop_all()
    np.testing.assert_array_equal(vr.read(0, 2 * PAGE), vg.read(0, 2 * PAGE).numpy())
    assert vr.stats == vg.stats


def test_hostview_poison_and_tier_read_match():
    ref, got = _pools()
    data = _bytes(3 * PAGE, 3)
    for p, d in ((ref, data), (got, torch.from_numpy(data))):
        p.cxl.write(PAGE, d)
    ir = ref_faults.FaultInjector(seed=4).poison_reads("cxl", 2, lo=2 * PAGE, hi=3 * PAGE)
    ig = faults.FaultInjector(seed=4).poison_reads("cxl", 2, lo=2 * PAGE, hi=3 * PAGE)
    ref.attach_fault_injector(ir)
    got.attach_fault_injector(ig)
    vr, vg = ref.host_view("h"), got.host_view("h")
    for o, n in ((PAGE, 3 * PAGE), (2 * PAGE, PAGE), (PAGE, PAGE)):
        np.testing.assert_array_equal(vr.read(o, n), vg.read(o, n).numpy())
        np.testing.assert_array_equal(ref.cxl.read(o, n), got.cxl.read(o, n).numpy())
    assert ir.stats == ig.stats and ir.stats["injected_poison"] == 2
    np.testing.assert_array_equal(ref.cxl.buf, got.cxl.buf.numpy())   # at rest: clean
