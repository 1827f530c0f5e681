"""Port parity: the content-addressed page store.  Every case runs the same
operations on the JAX package's ``DedupStore`` and on the port's, and holds
offsets, refcounts, buckets (contents and order), ``_hash_of``, quarantine
set, stats, tier bytes and free lists equal (exact).  The cases mirror
``tests/test_dedup.py``: scripted put/release/free, an always-colliding
hash, duplicates inside one batch, the marginal-size probe, mid-batch
rollback, quarantine / rematerialize / drop, and FNV-1a-64 bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import dedup as ref_dedup
from repro.core import faults as ref_faults
from repro.core.pool import CXL_COST as REF_CXL_COST
from repro.core.pool import AllocError as RefAllocError
from repro.core.pool import MemoryTier as RefTier
from repro_torch.core import dedup, faults
from repro_torch.core.pool import CXL_COST, AllocError, MemoryTier
from repro_torch.interop import dedup_store_state
from repro_torch.kernels import page_checksum, page_scatter

PAGE = 4096


def _collide_ref(m):
    return np.zeros(m.shape[0], np.uint64)


def _collide_port(m):
    return np.zeros(m.shape[0], np.uint64)


def _ref_state(store) -> dict:
    return {"buckets": {h: list(b) for h, b in store._buckets.items()},
            "refs": dict(store._refs), "hash_of": dict(store._hash_of),
            "quarantined": sorted(store._quarantined), "stats": dict(store.stats)}


class Pair:
    """One reference store and one port store on equal tiers, driven alike."""

    def __init__(self, capacity=1 << 20, hash_kind="fnv", injector=False):
        self.rt = RefTier("cxl", capacity, REF_CXL_COST)
        self.gt = MemoryTier("cxl", capacity, CXL_COST, device="cpu")
        hashes = {"fnv": (None, None), "collide": (_collide_ref, _collide_port),
                  "poly": (ref_dedup.pallas_hash_fn, dedup.poly32_hash_fn)}[hash_kind]
        self.r = ref_dedup.DedupStore(self.rt, hash_fn=hashes[0])
        self.g = dedup.DedupStore(self.gt, hash_fn=hashes[1])
        if injector:
            self.rt.fault_injector = ref_faults.FaultInjector(seed=3)
            self.gt.fault_injector = faults.FaultInjector(seed=3)

    def put_pages(self, mat: np.ndarray):
        want = self.r.put_pages(mat)
        got = self.g.put_pages(torch.from_numpy(mat))
        np.testing.assert_array_equal(got, want)
        self.check()
        return got

    def check(self):
        assert dedup_store_state(self.g) == _ref_state(self.r)
        assert list(self.g._buckets.items()) == list(self.r._buckets.items())
        np.testing.assert_array_equal(self.gt.buf.numpy(), self.rt.buf)
        assert self.gt.free_list() == self.rt._free
        assert self.gt.bytes_in_use == self.rt.bytes_in_use
        assert self.g.report() == self.r.report()


def _page(fill=None, seed=0):
    if fill is None:
        return np.random.default_rng(seed).integers(0, 256, PAGE, dtype=np.uint8)
    return np.full(PAGE, fill, np.uint8)


def test_scripted_put_release_free_sequence():
    p = Pair()
    a, b, c, d = _page(1), _page(2), _page(seed=3), _page(seed=4)
    assert p.r.put(a) == p.g.put(torch.from_numpy(a))
    assert p.r.put(a) == p.g.put(torch.from_numpy(a))
    assert p.r.put(b) == p.g.put(torch.from_numpy(b))
    p.check()
    offs = p.put_pages(np.stack([c, a, d, c, b]))
    for off in (int(offs[1]), int(offs[0])):
        p.r.release(off)
        p.g.release(off)
        p.check()
    p.r.release_offsets(offs[2:])
    p.g.release_offsets(offs[2:])
    p.check()
    for store in (p.r, p.g):
        store.release_offsets(sorted(store.refcounts()))
    p.check()
    left = p.g.refcounts()
    for store in (p.r, p.g):
        store.release_offsets(sorted(left))
    p.check()
    assert p.g.refcounts() == {} and p.gt.bytes_in_use == 0
    with pytest.raises(ValueError):
        p.g.release(12345)


@pytest.mark.parametrize("hash_kind", ["fnv", "collide", "poly"])
def test_duplicates_within_one_batch(hash_kind):
    p = Pair(hash_kind=hash_kind)
    a, b, c = _page(seed=11), _page(seed=12), _page(7)
    p.put_pages(np.stack([a, b, a, c, b, a, a]))
    p.put_pages(np.stack([c, _page(seed=13), a, _page(seed=13), _page(8)]))
    assert p.g.stats["unique"] == 5


def test_forced_hash_collision_is_byte_verified():
    p = Pair(hash_kind="collide")
    a, b = _page(1), _page(2)
    off_a = p.put_pages(a[None])[0]
    off_b = p.put_pages(b[None])[0]
    assert off_a != off_b and p.g.stats["collisions"] == 1
    assert p.put_pages(b[None])[0] == off_b
    p.put_pages(np.stack([_page(3), a, _page(4), b, _page(3)]))
    assert p.g.stats["collisions"] == 3
    for off in (off_a, off_b, off_b):
        p.r.release(off)
        p.g.release(off)
        p.check()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("hash_kind", ["fnv", "collide"])
def test_random_sequences_match(seed, hash_kind):
    """Random batches drawn from a small pool of contents (duplicates within
    and across batches), interleaved with random releases."""
    rng = np.random.default_rng(seed)
    pool = np.stack([_page(seed=100 + i) for i in range(9)] + [_page(5), _page(6)])
    p = Pair(capacity=64 * PAGE, hash_kind=hash_kind)
    for _ in range(6):
        batch = pool[rng.integers(0, pool.shape[0], rng.integers(1, 12))]
        p.put_pages(batch)
        held = sorted(p.g.refcounts())
        drop = rng.choice(held, size=min(len(held), int(rng.integers(0, 4))), replace=False)
        p.r.release_offsets(drop)
        p.g.release_offsets(drop)
        p.check()


def test_probe_new_bytes_counts_marginal_uniques():
    for hash_kind in ("fnv", "collide"):
        p = Pair(hash_kind=hash_kind)
        a, b, c = _page(1), _page(2), _page(3)
        p.put_pages(np.stack([a, b]))
        for batch in (np.stack([a, c, c]), np.stack([a, b]), np.stack([c, _page(9), c, b])):
            want = p.r.probe_new_bytes(batch)
            assert p.g.probe_new_bytes(torch.from_numpy(batch)) == want
        assert p.g.probe_new_bytes(torch.zeros((0, PAGE), dtype=torch.uint8)) == 0
        p.check()                                   # the probe stored nothing


@pytest.mark.parametrize("hash_kind", ["fnv", "collide"])
def test_mid_batch_alloc_failure_rolls_back(hash_kind):
    p = Pair(capacity=5 * PAGE, hash_kind=hash_kind)
    a, b = _page(1), _page(2)
    p.put_pages(np.stack([a, b]))
    batch = np.stack([a, _page(3), a, _page(4), _page(3), b, _page(5), _page(6)])
    with pytest.raises(RefAllocError) as want:
        p.r.put_pages(batch)
    with pytest.raises(AllocError) as got:
        p.g.put_pages(torch.from_numpy(batch))
    assert str(got.value) == str(want.value) and got.value.tier == want.value.tier
    p.check()                  # stats, bytes written before the failure, free list
    small = Pair(capacity=2 * PAGE)
    with pytest.raises(RefAllocError):
        small.r.put_pages(np.stack([_page(1), _page(2), _page(3)]))
    with pytest.raises(AllocError):
        small.g.put_pages(torch.from_numpy(np.stack([_page(1), _page(2), _page(3)])))
    small.check()
    assert small.g.refcounts() == {} and small.gt.bytes_in_use == 0


def test_injected_write_fault_rolls_back_like_reference():
    p = Pair(injector=True)
    p.put_pages(np.stack([_page(1)]))
    for inj in (p.rt.fault_injector, p.gt.fault_injector):
        inj.fail_writes("cxl", 1, lo=3 * PAGE, hi=4 * PAGE)
    batch = np.stack([_page(1), _page(2), _page(3), _page(1), _page(4), _page(5)])
    with pytest.raises(ref_faults.TierFaultError):
        p.r.put_pages(batch)
    with pytest.raises(faults.TierFaultError):
        p.g.put_pages(torch.from_numpy(batch))
    p.check()
    assert p.gt.fault_injector.stats == p.rt.fault_injector.stats
    p.put_pages(batch)
    assert p.gt.fault_injector.stats == p.rt.fault_injector.stats


def test_new_pages_written_by_one_scatter():
    g = dedup.DedupStore(MemoryTier("cxl", 1 << 20, CXL_COST, device="cpu"))
    batch = torch.from_numpy(np.stack([_page(seed=i) for i in range(5)] + [_page(seed=0)]))
    before = page_scatter.launches
    offs = g.put_pages(batch)
    assert page_scatter.launches == before          # CPU tensors: the plain version
    rows = g.tier.page_rows()
    assert torch.equal(rows[torch.from_numpy(offs // PAGE)], batch)
    assert g.decide_s > 0


def test_quarantine_rematerialize_drop():
    p = Pair(hash_kind="poly")
    a, b = _page(seed=21), _page(seed=22)
    offs = p.put_pages(np.stack([a, b, a]))
    off_a = int(offs[0])
    assert p.r.quarantine(off_a) is p.g.quarantine(off_a) is True
    assert p.r.quarantine(off_a) is p.g.quarantine(off_a) is False
    assert p.r.quarantine(1 << 40) is p.g.quarantine(1 << 40) is False
    p.check()
    p.put_pages(a[None])               # the quarantined copy is not shared
    wrong = a.copy()
    wrong[0] ^= 0xFF
    with pytest.raises(ValueError):
        p.r.rematerialize(off_a, wrong)
    with pytest.raises(ValueError):
        p.g.rematerialize(off_a, torch.from_numpy(wrong))
    p.r.rematerialize(off_a, a)
    p.g.rematerialize(off_a, torch.from_numpy(a))
    p.check()
    assert p.g.quarantined_offsets() == []
    with pytest.raises(ValueError):
        p.g.rematerialize(off_a, torch.from_numpy(a))
    for page in (a, b, _page(seed=99)):
        p.r.drop(page)
        p.g.drop(torch.from_numpy(page))
        p.check()
    assert p.g.logical_pages() == p.r.logical_pages()
    assert p.g.unique_bytes() == p.r.unique_bytes()
    assert p.g.dedup_ratio() == p.r.dedup_ratio()


def test_fnv1a_pages_bit_exact():
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 256, (9, PAGE), dtype=np.uint8)
    mat[3] = 0
    mat[4] = 0xFF
    want = ref_dedup.fnv1a_pages(mat)
    got = dedup.fnv1a_pages(torch.from_numpy(mat))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    for row in (0, 3, 4):
        assert dedup.fnv1a_page(torch.from_numpy(mat[row])) == ref_dedup.fnv1a_page(mat[row])
    assert int(dedup.FNV_OFFSET) == int(ref_dedup.FNV_OFFSET)
    assert int(dedup.FNV_PRIME) == int(ref_dedup.FNV_PRIME)


def test_poly32_hash_fn_is_the_page_checksum():
    mat = torch.from_numpy(np.stack([_page(seed=i) for i in range(4)]))
    assert dedup.poly32_hash_fn.is_poly32 and ref_dedup.pallas_hash_fn.is_poly32
    assert torch.equal(dedup.poly32_hash_fn(mat), page_checksum(mat))
    np.testing.assert_array_equal(dedup.poly32_hash_fn(mat).numpy().view(np.uint32),
                                  ref_dedup.pallas_hash_fn(mat.numpy()))
