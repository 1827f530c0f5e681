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
reference's own path, a mismatch at a batched walk's flush is repaired as
the reference repairs it, and the plain row-list versions are held to the
reference's restore kernel segment by segment.  The batched cold walk over
a raw RDMA tier queues the arena's own rows, reading no extent; over a
compressed tier it still reads each."""
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
from repro_torch.core import trace
from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref
import test_torch_compress as compress
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


def test_arena_changed_after_preverify_is_repaired_like_reference(monkeypatch, launches):
    """A pre-verified walk whose row disagrees at the flush repairs it as the
    reference repairs the same mismatch in the middle of its walk: one hot
    arena byte is flipped (in the port, after the pre-verify) and flipped
    back once the walk has read it, so the re-read from the home tier is
    clean.  Bytes, ``present``, repair, instance, view and scatter stats are
    equal.  The ledgers hold the same keys with values equal within 1e-12
    relative: the same charges, the repair's summed after the walk's
    instead of between its extents."""
    r, g = serving._restore_pair(seed=12)
    at = g[2].hot_off + 1 * PAGE

    def heal_after_read(side):
        pool, view = side[1], side[3].view
        read = view.read

        def wrapped(off, nbytes):
            out = read(off, nbytes)
            if off <= at < off + nbytes:
                pool.cxl.buf[at] ^= 0xFF
            return out

        view.read = wrapped

    verify = FusedScatter.verify_rows

    def verify_then_corrupt(self, segments):
        ok = verify(self, segments)
        g[1].cxl.buf[at] ^= 0xFF
        return ok

    monkeypatch.setattr(FusedScatter, "verify_rows", verify_then_corrupt)
    r[1].cxl.buf[at] ^= 0xFF
    for side in (r, g):
        heal_after_read(side)
        side[5].pre_install_hot()
    assert g[5].walk_routes == _routes(batched=1)
    assert launches["rows"] == 1
    assert g[5].repair_stats["checksum_mismatches"] == 1
    assert g[5].repair_stats["checksum_repairs"] == 1
    assert g[4]._queue is None and _lock_free(g[4])
    for side in (r, g):
        side[5].install_all_sync()
    np.testing.assert_array_equal(r[4].image.buf, g[4].image.buf.numpy())
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    np.testing.assert_array_equal(r[4].present, g[4].present)
    assert r[5].repair_stats == g[5].repair_stats
    assert r[4].stats == g[4].stats
    assert r[3].view.stats == g[3].view.stats
    assert r[7].stats == g[7].stats
    assert r[6].seconds.keys() == g[6].seconds.keys()
    for key, want in r[6].seconds.items():
        assert g[6].seconds[key] == pytest.approx(want, rel=1e-12, abs=0.0), key


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
# the batched cold walk over a raw RDMA tier: the arena's rows, unread
# ----------------------------------------------------------------------------

@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _fault_some_cold_pages(r, g):
    """Demand-fault, on both sides, a middle page of one cold extent, the
    first and last of another and every page of a third, so the walk finds
    extents partly present, split in two ranges, and wholly present."""
    reader = g[3]
    ext = list(reader.iter_cold_extents(max_extent_pages=1 << 30,
                                        largest_first=reader.regions.dedup))
    by_size = sorted(ext, key=lambda e: -e[1])
    assert len(ext) >= 3 and by_size[1][1] >= 3
    e1, e2, e3 = by_size[0], by_size[1], by_size[-1]
    pages = [e1[0] + e1[1] // 2, e2[0], e2[0] + e2[1] - 1] + list(range(e3[0], e3[0] + e3[1]))
    for side in (r, g):
        for p in pages:
            side[5].access(int(p))
    return len(pages)


def _count_reads(tier):
    """Count ``tier.read`` calls from here on."""
    seen, read = [], tier.read

    def counted(off, nbytes):
        seen.append(nbytes)
        return read(off, nbytes)

    tier.read = counted
    return seen


@pytest.mark.parametrize("verified", [True, False])
@pytest.mark.parametrize("dedup", [False, True])
def test_cold_walk_installs_the_arena_rows_exact(dedup, verified, launches, tracing,
                                                 ref_zero_scan_pallas):
    """The batched cold walk reads no extent: it queues the RDMA arena's own
    rows and accounts every extent by array arithmetic, exactly as the
    reference reads and accounts it extent by extent (images, ``present``,
    ledgers ``==``, instance, view, scatter and repair stats), with some of
    its pages already faulted in."""
    if dedup:
        r, g = dedup_layout._restore_pair("fused", scatter=verified)
        same = dedup_layout._assert_same
    else:
        r, g = serving._restore_pair(fused_scatter=verified, seed=21)
        same = serving._assert_same
    for side in (r, g):
        side[5].pre_install_hot()
    faulted = _fault_some_cold_pages(r, g)
    same(r, g, verified)
    reads = _count_reads(g[1].rdma)
    trace.reset()
    launches.update(rows=0, per_extent=0)
    for side in (r, g):
        side[5].install_all_sync()
    same(r, g, verified)
    assert g[5].walk_routes == _routes(batched=2)
    assert launches == {"rows": 1, "per_extent": 0}
    assert reads == []
    assert trace.snapshot()["counters"]["serving.arena_rows"] == g[2].n_cold - faulted
    assert g[4].all_present()
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    if verified:
        assert g[7].stats["pages_verified"] == g[2].n_hot + g[2].n_cold


@pytest.mark.skipif(compress.port_snapshot._zstd is None
                    or compress.ref_snapshot._zstd is None,
                    reason="zstandard not installed (optional extra)")
@pytest.mark.parametrize("scatter", ["verified", None])
def test_compressed_cold_tier_keeps_the_per_extent_read(scatter, tracing):
    """A compressed cold tier has no arena row a page: its batched cold walk
    still reads and decompresses each extent, exact against the reference."""
    r, g = compress.publish_both(*compress.fragmented_image(), fused=scatter is not None)
    a, b = compress._engines(r, g, scatter)
    reads = _count_reads(g[1].rdma)
    for side in (a, b):
        side[2].install_all_sync()
    compress._assert_restores_equal(a, b)
    np.testing.assert_array_equal(b[1].image.buf.numpy(), b[0].buf.numpy())
    assert b[2].walk_routes == _routes(batched=2)
    snap = trace.snapshot()
    assert "serving.arena_rows" not in snap["counters"]
    assert [s for s in snap["spans"] if s[0] == "serving.cold_rows"] == []
    n_ext = len(list(b[4].iter_cold_extents(max_extent_pages=1 << 30, largest_first=False)))
    assert len(reads) == n_ext > 1


@pytest.mark.parametrize("limit", [None, 5 * PAGE])
def test_cold_arena_changed_after_preverify_is_repaired_like_reference(monkeypatch, launches,
                                                                       limit):
    """A cold arena row that changes after the cold walk's pre-verify fails
    at the flush and is repaired as the reference repairs the same mismatch
    in the middle of its walk: its extent's accounting is taken back, the
    extent's good rows install, and the bad page is re-read from the RDMA
    tier (the byte is put back after the flush's launch, as the reference's
    is put back after its extent's read).  With a small queue limit the walk
    flushes many times.  Bytes, ``present``, repair, instance, view and
    scatter stats are equal; the ledgers hold the same keys, their values
    equal within 1e-12 relative (the repair's charges summed after the
    walk's)."""
    if limit is not None:
        monkeypatch.setattr(port.Instance, "QUEUE_FLUSH_BYTES", limit)
    r, g = serving._restore_pair(seed=22)
    page = int(g[3].walk_rows("rdma")[0][5])
    at = g[3].lookup(page)[1] + 7
    flipped = {"ref": True, "port": False}

    ref_read = r[1].rdma.read

    def heal_after_read(off, nbytes):
        out = ref_read(off, nbytes)
        if flipped["ref"] and off <= at < off + nbytes:
            r[1].rdma.buf[at] ^= 0xFF
            flipped["ref"] = False
        return out

    r[1].rdma.read = heal_after_read
    verify, launch = FusedScatter.verify_rows, FusedScatter.scatter_rows

    def verify_then_corrupt(self, segments):
        ok = verify(self, segments)
        if segments[0][0].data_ptr() == g[1].rdma.buf.data_ptr():
            g[1].rdma.buf[at] ^= 0xFF
            flipped["port"] = True
        return ok

    def launch_then_heal(self, dest, segments):
        try:
            return launch(self, dest, segments)
        finally:
            if flipped["port"]:
                g[1].rdma.buf[at] ^= 0xFF
                flipped["port"] = False

    direct, call = [], FusedScatter.__call__

    def sized_call(self, dest, compact, indices, src_indices=None):
        direct.append(len(indices))
        return call(self, dest, compact, indices, src_indices=src_indices)

    monkeypatch.setattr(FusedScatter, "verify_rows", verify_then_corrupt)
    monkeypatch.setattr(FusedScatter, "scatter_rows", launch_then_heal)
    monkeypatch.setattr(FusedScatter, "__call__", sized_call)
    r[1].rdma.buf[at] ^= 0xFF
    for side in (r, g):
        side[5].install_all_sync()
    assert not flipped["ref"] and not flipped["port"]
    # the repair installs the good rows of the bad page's extent, then the page
    (extent,) = [en for es, en, *_ in g[3].iter_cold_extents(max_extent_pages=1 << 30)
                 if es <= page < es + en]
    assert extent > 1 and direct == [extent - 1, 1]
    assert g[5].walk_routes == _routes(batched=2)
    assert (launches["rows"] == 2) == (limit is None) and launches["rows"] >= 2
    assert g[5].repair_stats["checksum_mismatches"] == 1
    assert g[5].repair_stats["checksum_repairs"] == 1
    assert g[4]._queue is None and _lock_free(g[4])
    np.testing.assert_array_equal(r[4].image.buf, g[4].image.buf.numpy())
    np.testing.assert_array_equal(g[4].image.buf.numpy(), g[0].buf.numpy())
    np.testing.assert_array_equal(r[4].present, g[4].present)
    assert r[5].repair_stats == g[5].repair_stats
    assert r[4].stats == g[4].stats
    assert r[3].view.stats == g[3].view.stats
    assert r[7].stats == g[7].stats
    assert r[6].seconds.keys() == g[6].seconds.keys()
    for key, want in r[6].seconds.items():
        assert g[6].seconds[key] == pytest.approx(want, rel=1e-12, abs=0.0), key


@pytest.mark.parametrize("dedup", [False, True])
def test_cold_walk_extents_are_iter_cold_extents(dedup, ref_zero_scan_pallas):
    """The walk's extent table from :meth:`SnapshotReader.walk_rows`, in the
    order the per-extent walk reads them (dedup: largest run first, split
    where store offsets stop being adjacent)."""
    if dedup:
        _r, g = dedup_layout._restore_pair("fused")
    else:
        _r, g = serving._restore_pair(seed=23)
    reader = g[3]
    pages, offs, bounds = reader.cold_walk_extents(*reader.walk_rows("rdma"))
    want = list(reader.iter_cold_extents(max_extent_pages=1 << 30,
                                         largest_first=reader.regions.dedup))
    got = [(int(pages[a]), b - a, int(offs[a]), (b - a) * PAGE)
           for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist())]
    assert got == [(es, en, off, n) for es, en, _rank, off, n in want]
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        np.testing.assert_array_equal(pages[a:b], pages[a] + np.arange(b - a))
        np.testing.assert_array_equal(offs[a:b], offs[a] + PAGE * np.arange(b - a))
    if dedup:
        assert [e[1] for e in want] != sorted(e[1] for e in want)   # not guest order
    empty = np.zeros(0, np.int64)
    assert [x.tolist() for x in reader.cold_walk_extents(empty, empty)] == [[], [], [0]]


def test_arbiter_charges_and_ordered_sums_are_the_scalar_ones():
    """One ``active()`` read for a walk's charges gives the floats the
    per-extent ``charge`` gives, and ``add_each`` the sum of ``add``."""
    arb = port.LinkArbiter(port.RDMA_COST)
    sizes = np.array([4096, 7 * 4096, 1, 123 * 4096, 4096, 1 << 30], dtype=np.int64)
    for streams in range(3):
        if streams:
            arb.register(("s", streams))
        got = arb.charges(sizes)
        assert got.tolist() == [arb.charge(int(n)) for n in sizes.tolist()]
        one, each = port.TimeLedger({"k": 0.1}), port.TimeLedger({"k": 0.1})
        for t in got.tolist():
            one.add("k", t)
        each.add_each("k", got)
        each.add_each("absent", [])
        assert each.seconds == one.seconds


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
