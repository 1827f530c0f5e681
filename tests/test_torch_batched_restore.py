"""Port parity: batched restore walks.

``pre_install_hot`` and the cold walk of ``install_all_sync`` queue every
extent's scatter and install the whole walk with one row-list launch when
nothing in the walk can observe the deferral.  Everything the reference can
see stays exact against the JAX package (its fused kernels in Pallas
interpret mode): images, ``present``, ledgers (key by key, ``==``), instance,
view, scatter and repair stats, ``retry_trace`` and the ``bad_pages`` of a
raised error.  Each reason a walk stays per extent (an armed injector, a
cached HostView line over the hot rows, a corrupted arena byte caught by the
pre-verify, a scatter function with no batched form) is shown taking the
reference's own path, and the plain row-list versions are held to the
reference's restore kernel segment by segment."""
import threading

import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro.kernels.snapshot_fuse.ops import ChecksumMismatchError as RefMismatch
from repro.kernels.snapshot_fuse.ops import fused_restore as ref_fused_restore
from repro_torch import core as port
from repro_torch.core import faults
from repro_torch.kernels import (
    ChecksumMismatchError,
    FusedScatter,
    fused_restore_rows,
    page_scatter,
    page_scatter_rows,
)
from repro_torch.kernels.page_scatter.ref import page_scatter_rows_ref
from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref
import test_torch_dedup_layout as dedup_layout
import test_torch_serving as serving

PAGE = 4096
NO_PER_EXTENT = {"injector": 0, "cached_lines": 0, "preverify": 0, "scatter_fn": 0}


def _routes(batched=0, **per_extent):
    return {"batched": batched, "per_extent": {**NO_PER_EXTENT, **per_extent}}


@pytest.fixture
def launches(monkeypatch):
    """Count the batched forms' calls (one a flushed walk) and the per-extent
    scatter calls of the port side."""
    seen = {"rows": 0, "per_extent": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(page_scatter, "scatter_rows", spy(page_scatter_rows, "rows"))
    monkeypatch.setattr(FusedScatter, "scatter_rows",
                        spy(FusedScatter.scatter_rows, "rows"))
    monkeypatch.setattr(FusedScatter, "__call__", spy(FusedScatter.__call__, "per_extent"))
    return seen


def _lock_free(inst) -> bool:
    """Whether another thread can take the instance's lock (a walk's queue
    holds it until its flush)."""
    got = []

    def probe():
        ok = inst._lock.acquire(blocking=False)
        got.append(ok)
        if ok:
            inst._lock.release()

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return got == [True]


def _restore(r, g, chunk=None):
    for side in (r, g):
        side[5].pre_install_hot(chunk_pages=chunk)
    serving._assert_same(r, g, scatter=r[7] is not None)
    for side in (r, g):
        side[5].install_all_sync()
    serving._assert_same(r, g, scatter=r[7] is not None)


@pytest.mark.parametrize("verified", [True, False])
@pytest.mark.parametrize("chunk", [16, 256])
def test_private_walks_batched_exact(chunk, verified, launches):
    r, g = serving._restore_pair(fused_scatter=verified, seed=chunk)
    _restore(r, g, chunk)
    assert g[5].walk_routes == _routes(batched=2)
    assert launches == {"rows": 2, "per_extent": 0}
    assert g[4].all_present()
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    if verified:
        assert g[7].stats["pages_verified"] == g[2].n_hot + g[2].n_cold


@pytest.mark.parametrize("route,scatter", [("fused", True), ("fused", False),
                                           ("default", False)])
def test_dedup_walks_batched_exact(route, scatter, launches, ref_zero_scan_pallas):
    r, g = dedup_layout._restore_pair(route, scatter=scatter)
    for side in (r, g):
        side[5].pre_install_hot(chunk_pages=8)
    dedup_layout._assert_same(r, g, scatter)
    for side in (r, g):
        side[5].install_all_sync()
    dedup_layout._assert_same(r, g, scatter)
    assert g[5].walk_routes == _routes(batched=2)
    assert launches == {"rows": 2, "per_extent": 0}
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    if scatter:
        assert g[7].stats["pages_verified"] == g[2].n_hot + g[2].n_cold


@pytest.fixture
def ref_zero_scan_pallas():
    from repro.core.pagestore import pallas_zero_scan, set_zero_scan_backend

    prev = set_zero_scan_backend(lambda m: pallas_zero_scan(m))
    yield
    set_zero_scan_backend(prev)


def test_repeated_walk_counts_no_route(launches):
    r, g = serving._restore_pair(seed=3)
    _restore(r, g)
    for side in (r, g):
        side[5].pre_install_hot()
        side[5].install_all_sync()
    serving._assert_same(r, g)
    assert g[5].walk_routes == _routes(batched=2)
    assert launches["rows"] == 2


def test_flush_at_the_queue_limit_is_exact(monkeypatch, launches):
    """A walk whose queued buffers reach the limit flushes mid-walk."""
    monkeypatch.setattr(port.Instance, "QUEUE_FLUSH_BYTES", 5 * PAGE)
    r, g = serving._restore_pair(seed=2)
    _restore(r, g, chunk=4)
    assert g[5].walk_routes == _routes(batched=2)
    assert launches["rows"] > 2 and launches["per_extent"] == 0
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    assert g[4]._queue is None and _lock_free(g[4])


def test_other_threads_install_directly_during_a_walk():
    """Only the walk's thread queues: another thread's batch installs at
    once before the walk has queued anything, and waits for the flush once
    the walk's queue holds the lock.  A queued page is marked present only
    by the flush."""
    img = port.StateImage.empty_like(port.Manifest([], 8), device="cpu")
    inst = port.Instance(img)
    rows = torch.from_numpy(np.arange(3 * PAGE).astype(np.uint8).reshape(3, PAGE) + 1)
    flushed = []

    def launch(dest, segments):
        flushed.append([d.tolist() for _t, _r, d in segments])
        page_scatter_rows(dest, segments)

    def install(page, row):
        t = threading.Thread(target=inst.uffd_copy_batch, args=(np.array([page]), rows[row]))
        t.start()
        return t

    with inst.queued_installs(launch):
        first = install(2, 0)
        first.join(timeout=10)
        assert not first.is_alive() and torch.equal(img.pages_matrix()[2], rows[0])
        inst.uffd_copy_batch(np.array([1]), rows[1])
        assert not inst.present[1]               # queued, not yet installed
        second = install(3, 2)
        second.join(timeout=0.2)
        assert second.is_alive()                 # blocked until the walk's flush
        assert not img.pages_matrix()[1].any() and not inst.present[[1, 3]].any()
    second.join(timeout=10)
    assert not second.is_alive()
    assert flushed == [[[1]]]
    got = img.pages_matrix()
    assert torch.equal(got[1], rows[1]) and torch.equal(got[3], rows[2])
    assert inst.present[[1, 2, 3]].all() and _lock_free(inst)


def test_guest_access_during_a_walk_waits_for_its_flush():
    """A guest touch on another thread finds a page the walk has queued
    absent (no lock-free check reports it present early), faults, and
    returns only once the flush has installed the page's bytes."""
    _r, g = serving._restore_pair(fused_scatter=False, seed=5)
    src, reader, inst, eng = g[0], g[3], g[4], g[5]
    page = int(reader.walk_rows("cxl")[0][0])
    want = src.pages_matrix()[page].clone()
    errors = []

    def touch():
        try:
            eng.access(page, timeout_s=10)
        except Exception as e:                   # surfaced by the asserts below
            errors.append(e)

    with inst.queued_installs(page_scatter_rows):
        inst.uffd_copy_batch(np.array([page]), want.clone())
        assert not inst.present[page] and not inst.all_present()
        guest = threading.Thread(target=touch)
        guest.start()
        guest.join(timeout=0.3)
        assert guest.is_alive() and not inst.present[page]
        assert not inst.image.pages_matrix()[page].any()
    guest.join(timeout=10)
    assert not guest.is_alive() and errors == []
    assert inst.present[page] and torch.equal(inst.image.pages_matrix()[page], want)
    assert inst.stats["fault_cxl"] == 1 and inst.stats["uffd_copies"] == 1


def test_injector_keeps_walks_per_extent(launches):
    """An armed injector keeps both walks on the per-extent route; the
    poisoned hot read is repaired as the reference repairs it."""
    r, g = serving._restore_pair(seed=7)
    lo, hi = g[2].hot_off, g[2].hot_off + 3 * PAGE
    r[1].attach_fault_injector(ref_faults.FaultInjector(seed=1).poison_reads("cxl", 2, lo, hi))
    g[1].attach_fault_injector(faults.FaultInjector(seed=1).poison_reads("cxl", 2, lo, hi))
    for side in (r, g):
        side[5].install_all_sync()
    serving._assert_same(r, g)
    assert g[5].walk_routes == _routes(injector=2)
    assert launches["rows"] == 0 and launches["per_extent"] > 0
    assert g[5].repair_stats["checksum_repairs"] == 2
    assert g[1].fault_injector.stats == r[1].fault_injector.stats


def test_cached_line_keeps_the_hot_walk_per_extent(launches):
    """A valid HostView line over a hot row keeps the verified hot walk per
    extent (a read may return the cache's bytes); the cold walk reads the
    RDMA tier, uncached, and is batched."""
    r, g = serving._restore_pair(seed=9)
    for side in (r, g):
        side[3].view.read(side[2].hot_off + 2 * PAGE + 64, 64)
    _restore(r, g)
    assert g[5].walk_routes == _routes(batched=1, cached_lines=1)
    assert launches["rows"] == 1 and launches["per_extent"] > 0
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_corrupted_cxl_byte_caught_by_preverify_exhausts_like_reference(launches):
    r, g = serving._restore_pair(seed=8)
    at = g[2].hot_off + 5 * PAGE + 100
    r[1].cxl.buf[at] ^= 0xFF
    g[1].cxl.buf[at] ^= 0xFF
    with pytest.raises(RefMismatch) as want:
        r[5].install_all_sync()
    with pytest.raises(ChecksumMismatchError) as got:
        g[5].install_all_sync()
    np.testing.assert_array_equal(got.value.bad_pages, want.value.bad_pages)
    assert g[5].walk_routes == _routes(preverify=1)
    assert launches["rows"] == 0
    assert r[5].repair_stats == g[5].repair_stats
    assert g[5].repair_stats["repair_failures"] == 1
    assert r[6].seconds == g[6].seconds
    assert r[4].stats == g[4].stats
    assert r[5].retry_trace == g[5].retry_trace


def test_corrupted_rdma_byte_caught_by_preverify_like_reference(launches):
    """A bad cold row: the hot walk is batched, the cold walk takes the
    reference's per-extent repair, which exhausts (the arena itself is bad)."""
    r, g = serving._restore_pair(seed=10)
    at = g[2].rdma_off + 3 * PAGE + 7
    r[1].rdma.buf[at] ^= 0x01
    g[1].rdma.buf[at] ^= 0x01
    with pytest.raises(RefMismatch) as want:
        r[5].install_all_sync()
    with pytest.raises(ChecksumMismatchError) as got:
        g[5].install_all_sync()
    np.testing.assert_array_equal(got.value.bad_pages, want.value.bad_pages)
    assert g[5].walk_routes == _routes(batched=1, preverify=1)
    assert launches["rows"] == 1
    assert r[5].repair_stats == g[5].repair_stats
    assert r[6].seconds == g[6].seconds
    assert r[4].stats == g[4].stats
    np.testing.assert_array_equal(r[4].present, g[4].present)


def test_custom_scatter_fn_keeps_walks_per_extent(launches):
    calls = []

    def my_scatter(dest, compact, indices, src_indices=None):
        calls.append(len(indices))
        return page_scatter(dest, compact, indices, src_indices=src_indices)

    r, g = serving._restore_pair(fused_scatter=False, seed=11)
    g[4].scatter_fn = my_scatter
    _restore(r, g)
    assert g[5].walk_routes == _routes(scatter_fn=2)
    assert launches["rows"] == 0 and sum(calls) == g[2].n_hot + g[2].n_cold
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())


def test_arena_changed_after_preverify_is_not_a_repair_case(monkeypatch):
    """A pre-verified walk whose rows still disagree at the flush raises a
    plain RuntimeError naming the pages (no ``bad_pages``: nothing repairs)."""
    r, g = serving._restore_pair(seed=12)
    monkeypatch.setattr(FusedScatter, "verify_rows", lambda self, segments: True)
    at = g[2].hot_off + 1 * PAGE
    g[1].cxl.buf[at] ^= 0xFF
    with pytest.raises(RuntimeError, match="pre-verified") as ei:
        g[5].pre_install_hot()
    assert getattr(ei.value, "bad_pages", None) is None
    assert g[5].repair_stats["checksum_mismatches"] == 0
    assert g[4]._queue is None and _lock_free(g[4])


@pytest.mark.parametrize("dedup", [False, True])
def test_walk_rows_are_the_extents_rows(dedup, ref_zero_scan_pallas):
    if dedup:
        r, g = dedup_layout._restore_pair("fused")
    else:
        r, g = serving._restore_pair(seed=13)
    reader = g[3]
    for tier in ("cxl", "rdma"):
        pages, offs = reader.walk_rows(tier)
        if tier == "cxl":
            ext = [(p, off + PAGE * np.arange(p.size)) for p, off, _n in
                   reader.iter_hot_extents(8)]
        else:
            ext = [(np.arange(es, es + en), off + PAGE * np.arange(en)) for es, en, _r, off, _n
                   in reader.iter_cold_extents(max_extent_pages=5)]
        want_p = np.concatenate([p for p, _o in ext])
        want_o = np.concatenate([o for _p, o in ext])
        order = np.argsort(want_p)
        np.testing.assert_array_equal(pages, want_p[order])
        np.testing.assert_array_equal(offs, want_o[order])
        assert [reader.lookup(int(p))[1] for p in pages[:20]] == offs[:20].tolist()


def test_host_view_line_query_reads_nothing():
    pool = port.HierarchicalPool(1 << 20, 1 << 20, device="cpu")
    view = pool.host_view("h")
    assert not view.has_valid_lines([0, 8 * PAGE], PAGE)
    view.read(3 * PAGE + 128, 64)
    stats = dict(view.stats)
    assert view.has_valid_lines([0, 3 * PAGE], PAGE)
    assert view.has_valid_lines([3 * PAGE + 128], 1)
    assert not view.has_valid_lines([2 * PAGE, 4 * PAGE, 3 * PAGE + 192], PAGE - 192)
    assert not view.has_valid_lines([3 * PAGE], 128)
    assert not view.has_valid_lines(np.zeros(0, np.int64), PAGE)
    assert view.stats == stats and int(view._valid.sum()) == 1


# ----------------------------------------------------------------------------
# the plain row-list versions (what CPU tensors take) against the reference
# ----------------------------------------------------------------------------

def _segments(seed, sizes, dest_rows):
    rng = np.random.default_rng(seed)
    dst = rng.permutation(dest_rows)[: sum(sizes)]
    segs, at = [], 0
    for k, m in enumerate(sizes):
        t = rng.integers(0, 256, (m + 2, PAGE), dtype=np.uint8)
        t[::3] = 0xFF
        rows = rng.permutation(m + 2)[:m] if k % 2 == 0 else None
        if rows is None:
            t = t[:m]
        segs.append((t, rows, dst[at : at + m]))
        at += m
    return segs


@pytest.mark.parametrize("sizes", [(), (0,), (1,), (37,), (5, 0, 17, 1), (3,) * 9])
def test_plain_row_lists_match_reference(sizes):
    n = 300
    segs = _segments(sum(sizes) + 7 * len(sizes), sizes, n)
    dest0 = np.random.default_rng(1).integers(0, 256, (n, PAGE), dtype=np.uint8)
    want = dest0.copy()
    want_cs = []
    for t, rows, dst in segs:
        want, cs = ref_fused_restore(want, t, dst, src_indices=rows, use_pallas=True,
                                     interpret=True)
        want = np.array(want)
        want_cs.append(np.asarray(cs))
    want_cs = np.concatenate(want_cs) if want_cs else np.zeros(0, np.uint32)
    tsegs = [(torch.from_numpy(t), rows, dst) for t, rows, dst in segs]
    for fn in (page_scatter_rows, page_scatter_rows_ref):
        got = fn(torch.from_numpy(dest0.copy()), tsegs)
        np.testing.assert_array_equal(got.numpy(), want)
    for fn in (lambda d, s: fused_restore_rows(d, s), fused_restore_rows_ref):
        dest = torch.from_numpy(dest0.copy())
        cs = fn(dest, tsegs)
        np.testing.assert_array_equal(dest.numpy(), want)
        np.testing.assert_array_equal(cs.numpy().view(np.uint32), want_cs)
    np.testing.assert_array_equal(
        fused_restore_rows_ref(None, tsegs).numpy().view(np.uint32), want_cs)


def test_plain_row_list_verifies_like_reference():
    segs = _segments(4, (9, 4, 6), 64)
    dest = np.zeros((64, PAGE), np.uint8)
    dst = np.concatenate([d for _t, _r, d in segs])
    tsegs = [(torch.from_numpy(t), rows, d) for t, rows, d in segs]
    table = torch.zeros(64, dtype=torch.int32)
    table[torch.from_numpy(dst)] = fused_restore_rows_ref(None, tsegs)
    bad = dst[[2, 10, 18]]
    table[torch.from_numpy(bad)] ^= 1
    for verify_only in (True, False):
        with pytest.raises(ChecksumMismatchError) as got:
            fused_restore_rows(torch.from_numpy(dest), tsegs, expected_table=table,
                               verify_only=verify_only)
        assert sorted(got.value.bad_pages.tolist()) == sorted(bad.tolist())
        assert dest.any() == (not verify_only)
    scatter = FusedScatter().bind_checksums(table.numpy().view(np.uint32))
    assert not scatter.verify_rows(tsegs)
    table[torch.from_numpy(bad)] ^= 1
    assert FusedScatter().bind_checksums(table).verify_rows(tsegs)
    assert FusedScatter().bind_checksums(table).verify_rows([])


def test_plain_row_lists_refuse_duplicates_and_bad_rows():
    t = torch.zeros((4, PAGE), dtype=torch.uint8)
    dest = torch.zeros((8, PAGE), dtype=torch.uint8)
    dup = [(t, None, np.array([0, 1, 2, 3])), (t, np.array([0]), np.array([2]))]
    for fn in (page_scatter_rows, fused_restore_rows):
        with pytest.raises(AssertionError, match="duplicate"):
            fn(dest, dup)
        with pytest.raises(IndexError):
            fn(dest, [(t, np.array([4]), np.array([0]))])
        with pytest.raises(IndexError):
            fn(dest, [(t, None, np.array([0, 1, 2, 8]))])
        with pytest.raises(ValueError):
            fn(dest, [(t, None, np.array([0, 1]))])
        with pytest.raises(ValueError):
            fn(dest, [(torch.zeros((2, 100), dtype=torch.uint8), None, np.array([0, 1]))])
    with pytest.raises(ValueError):
        fused_restore_rows(None, [(t, None, np.arange(4))], verify_only=True)
    with pytest.raises(ValueError):
        fused_restore_rows(None, [(t, None, np.arange(4))])
