"""The dedup fleet's benchmark cell, ``fleet24.coldstart``, on the CPU: 24
variants of one base (here 4, at the benchmark tests' size) published in the
content-addressed layout and cold-started eagerly through one node server.

The cell's run is correct; the variants share hot chunks across snapshots;
both planted faults (a cold page, a hot store row that many variants share)
are caught, and installed under ``--control unverified``; the restores equal
the reference's images; the program's spans and counters of the dedup walks
and the chunk cache agree with the cache's own statistics.  One case runs the
cell's control on the card."""
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aqbench import harness, reference  # noqa: E402
from aqbench.tests.conftest import run_tiny, tiny_cell  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402

CELL = "fleet24.coldstart"
SHARED = harness.load_module("ops", "coldstart_shared")
# an image of 8,192 pages holds ~470 hot pages, two chunks of the tier's
# 256-page grid: the second lies past every tiny variant's delta, so all of
# them read the same chunk (at 2,048 pages only two of the four share one)
WIDE_PAGES = 8192


def run_wide(seed: int = 2**31 + 77, seconds: float = 1.5) -> dict:
    cfg, mix = tiny_cell(CELL)
    cfg = dict(cfg, image_pages=WIDE_PAGES, rdma_capacity_bytes=128 << 20)
    return harness.run(CELL, cfg, mix, seed, seconds, False, device="cpu")


@contextlib.contextmanager
def shared_op(**methods):
    """The runs inside use :data:`SHARED` (the harness loads the operation's
    file anew for each run), its ``Op`` with ``methods`` replaced."""
    load = harness.load_module

    def load_module(folder: str, name: str):
        return SHARED if (folder, name) == ("ops", "coldstart_shared") else load(folder, name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_module", load_module)
        for name, fn in methods.items():
            mp.setattr(SHARED.Op, name, fn)
        yield


@contextlib.contextmanager
def restores_by_variant(**methods):
    """``{function: [(fps_equal, all_present, restored_bytes_added)]}`` of
    every start the check compares, while the context is open."""
    seen: dict = {}
    orig = SHARED.Op.check_image

    def check_image(self, f, version, buf, hot):
        want = reference.page_fps(buf).cpu().numpy()
        before = self.n["restored_bytes"]
        rs = list(self._by_image.get((f, version), []))
        orig(self, f, version, buf, hot)
        added = self.n["restored_bytes"] - before
        for r in rs:
            seen.setdefault(f, []).append(
                (bool(np.array_equal(r["fps"], want)), bool(r["present"].all()), added))

    with shared_op(check_image=check_image, **methods):
        yield seen


@pytest.fixture(scope="module")
def sound():
    with restores_by_variant() as seen:
        rec = run_tiny(CELL)
    return rec, seen


def test_the_cell_is_correct(sound):
    rec, _ = sound
    assert rec["failed"] == 0 and not rec["errors"], rec["errors"]
    assert rec["done"] > 0
    checks = rec["checks"]
    for name in ("tamper_undetected", "tamper_shared_undetected", "dedup_refs",
                 "excess_pages", "restored_bytes", "restored_missing"):
        assert name in checks
    assert {k: c["value"] for k, c in checks.items()} == {k: 0 for k in checks}
    assert harness.passed(checks)


def test_every_restored_variant_equals_its_image(sound):
    _, seen = sound
    assert len(seen) >= 2
    for f, starts in seen.items():
        assert starts and all(equal and present for equal, present, _ in starts), f


def test_cross_snapshot_hits_are_fanout_hits():
    rec = run_wide()
    assert harness.passed(rec["checks"]), rec["checks"]
    c = rec["counters"]
    assert 0 < c["cross_snapshot_hits"] <= c["fanout_hits"] <= c["hot_chunk_requests"]
    share = harness.load_reader("cross_snapshot_hit_share")(rec)
    assert 0 < share <= harness.load_reader("fanout_hit_share")(rec)


def test_cross_snapshot_share_reads_nothing_without_requests():
    read = harness.load_reader("cross_snapshot_hit_share")
    assert read({"counters": {"hot_chunk_requests": 0, "cross_snapshot_hits": 0}}) is None
    assert read({"counters": {"hot_chunk_requests": 8}}) is None
    assert read({"counters": {"hot_chunk_requests": 8, "cross_snapshot_hits": 2}}) == 25.0


def test_unverified_control_installs_both_planted_faults():
    rec = run_tiny(CELL, control="unverified")
    checks = rec["checks"]
    assert checks["tamper_undetected"]["value"] == 1
    assert checks["tamper_shared_undetected"]["value"] >= 1
    assert not harness.passed(checks)


def test_the_shared_fault_hits_a_row_two_variants_reference():
    """The planted shared fault's row: a hot page's CXL store row that the
    most references hold, referenced by both variants it starts."""
    cfg, mix = tiny_cell(CELL)
    dep = harness.Deployment(cfg, 2**31 + 77, "cpu")
    op = SHARED.Op(dep, mix, harness.Spans(), 2**31 + 77)
    try:
        page, off, variants = op.shared_target()
        refs = dep.pool.dedup_cxl.refcounts()
        assert refs[off] == max(refs.values()) >= 2 and len(set(variants)) == 2
        for f in variants:
            slot = int(op._slot(f, np.array([page]))[0])
            assert slot >> int(reference.TAG_SHIFT) == reference.TAG_CXL
            assert slot & int(reference.OFF_MASK) == off
    finally:
        op.close()


def test_a_flipped_shared_row_installed_unverified_shows_in_two_variants():
    """A byte of a base hot row that every variant references, flipped after
    the publish: the unverified restores install it, and the comparison with
    the images finds it in the starts of at least two variants."""
    orig = SHARED.Op.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        _page, off, _ = self.shared_target()
        self.dep.pool.cxl.buf[off + 77] ^= 0x3C

    with restores_by_variant(__init__=init) as seen:
        rec = run_tiny(CELL, control="unverified", seconds=1.5)
    assert rec["checks"]["restored_bytes"]["value"] > 0
    hit = {f for f, starts in seen.items() if any(added > 0 for *_, added in starts)}
    assert len(hit) >= 2, seen


def _hot_extents_loop(reader, chunk_pages: int) -> list:
    """The dedup branch of ``iter_hot_extents`` as a loop over the offset
    sub-runs, each cut at the absolute tier grid: the reference for its
    array form."""
    from repro_torch.core.snapshot import OFFSET_MASK, _offset_subruns

    hot = reader.hot_page_indices()
    offs = (reader.offset_array()[hot] & OFFSET_MASK).astype(np.int64)
    order = np.argsort(offs, kind="stable")
    hot_o, offs_o = hot[order], offs[order]
    chunk_bytes = chunk_pages * PAGE_SIZE
    out = []
    for a, k in _offset_subruns(offs_o):
        s = a
        while s < a + k:
            off_s = int(offs_o[s])
            n = min(a + k - s, max(1, (chunk_bytes - off_s % chunk_bytes) // PAGE_SIZE))
            out.append((hot_o[s:s + n].tolist(), off_s, n * PAGE_SIZE))
            s += n
    return out


@pytest.mark.parametrize("pages", [2048, WIDE_PAGES])
def test_dedup_hot_extents_equal_the_loop(pages):
    cfg, _ = tiny_cell(CELL)
    cfg = dict(cfg, image_pages=pages, rdma_capacity_bytes=128 << 20)
    dep = harness.Deployment(cfg, 4242, "cpu")
    for f in range(dep.n_fn):
        regions = dep.master.catalog.find(dep.name(f, 0)).regions
        reader = core.SnapshotReader(regions, core.HostView("h", dep.pool.cxl), dep.pool.rdma)
        for chunk in (256, 64, 7, 1):
            got = [(p.tolist(), off, n) for p, off, n in reader.iter_hot_extents(chunk)]
            assert got == _hot_extents_loop(reader, chunk), (f, chunk)
            assert sorted(sum((p for p, _, _ in got), [])) == reader.hot_page_indices().tolist()


@pytest.fixture(scope="module")
def traced_window():
    """A run at the wide size with the program's tracing on for its window
    only: the program's record and the chunk cache's statistics at the
    window's open and close."""
    stats = {}
    orig_open, orig_close = SHARED.Op.window_open, SHARED.Op.window_close

    def window_open(self):
        orig_open(self)
        stats["open"] = dict(self.server.chunks.stats)
        trace.reset()
        trace.enable()

    def window_close(self):
        trace.disable()
        stats["snap"] = trace.snapshot()
        stats["close"] = dict(self.server.chunks.stats)
        return orig_close(self)

    try:
        with shared_op(window_open=window_open, window_close=window_close):
            rec = run_wide()
    finally:
        trace.disable()
        trace.reset()
    return rec, stats


def _children(snap: dict, parent: str, child: str) -> list:
    """For each span named ``parent``, how many direct children ``child``."""
    spans = snap["spans"]
    idx = [i for i, s in enumerate(spans) if s[0] == parent]
    kids = {i: 0 for i in idx}
    for s in spans:
        if s[0] == child and s[2] in kids:
            kids[s[2]] += 1
    return [kids[i] for i in idx]


def test_every_dedup_walk_carries_its_order_span(traced_window):
    rec, stats = traced_window
    snap = stats["snap"]
    assert snap["dropped"] == 0 and rec["failed"] == 0
    hot = _children(snap, "serving.hot_walk", "serving.hot_order")
    cold = _children(snap, "serving.cold_rows", "serving.cold_order")
    # two hot walks a start (the second, inside install_all_sync, finds every
    # page present), one batched cold walk a start
    assert len(hot) == 2 * rec["counters"]["ops"] and set(hot) == {1}
    assert len(cold) == rec["counters"]["ops"] and set(cold) == {1}
    assert (len([s for s in snap["spans"] if s[0] == "serving.hot_order"])
            == len(hot))


def test_node_server_counters_equal_the_cache_stats(traced_window):
    rec, stats = traced_window
    c = stats["snap"]["counters"]
    cross = stats["close"]["cross_group_hits"] - stats["open"]["cross_group_hits"]
    reads = stats["close"]["reads"] - stats["open"]["reads"]
    assert cross == rec["counters"]["cross_snapshot_hits"] > 0
    assert c.get("nodeserver.cross_group_hits", 0) == cross
    assert c.get("nodeserver.chunk_reads", 0) == reads > 0
    assert c["nodeserver.hot_chunk_requests"] == rec["counters"]["hot_chunk_requests"]


def test_the_new_spans_and_counters_are_off_by_default():
    trace.disable()
    trace.reset()
    rec = run_tiny(CELL)
    assert rec["done"] > 0
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


@pytest.mark.gpu
def test_the_cells_control_on_the_card():
    """``--control unverified`` at the cell's own size on the card: not
    correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    out = subprocess.run([sys.executable, "aqbench/run.py", "--workload", CELL, "--seed", "7",
                          "--seconds", "3", "--trace", "0", "--control", "unverified"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is False
    assert got["checks"]["tamper_undetected"]["value"] == 1
    assert got["checks"]["tamper_shared_undetected"]["value"] >= 1
