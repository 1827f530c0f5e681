"""Cold starts of a deduplicated fleet: ``ops/coldstart.py``'s operation
and check, with two additions for a pool whose snapshots share stored pages.

* The window's ``cross_snapshot_hits``: hot-chunk requests that the node
  server answered with a read made for a restore of another snapshot
  (``HotChunkCache.stats["cross_group_hits"]``, content-keyed chunks).
* A second planted fault, ``tamper_shared_undetected``: one byte flipped in
  the CXL store row of a hot page that the most variants reference (at the
  fleet's 24 variants with a delta of 12/256 each, the deltas cover every
  hot rank, so no page is outside all of them: 23 share the row), then one
  start each of two variants that reference that row, the byte put back.
  Each start that installs the page without failing adds 1.
"""
from __future__ import annotations

import numpy as np

from aqbench import gen, harness, reference

coldstart = harness.load_module("ops", "coldstart")

SHARED_K = coldstart.TAMPER_K - 1     # the start index of the shared fault's starts


class Op(coldstart.Op):
    def window_open(self) -> None:
        super().window_open()
        self._cross0 = int(self.server.chunks.stats["cross_group_hits"])

    def window_close(self) -> tuple:
        counters, work = super().window_close()
        counters["cross_snapshot_hits"] = (int(self.server.chunks.stats["cross_group_hits"])
                                           - self._cross0)
        return counters, work

    def check_before(self, records: list) -> dict:
        n = super().check_before(records)
        n["tamper_shared_undetected"] = self._tamper_shared()
        return n

    def _slot(self, f: int, pages: np.ndarray) -> np.ndarray:
        """The offset-array slots of ``pages`` in variant ``f``'s live snapshot."""
        dep = self.dep
        reg = dep.master.catalog.find(dep.name(f, dep.version[f])).regions
        oa = dep.pool.cxl.buf[reg.oa_off:reg.oa_off + reg.total_pages * 8]
        return oa.cpu().numpy().view(np.uint64)[pages]

    def shared_target(self) -> tuple:
        """``(page, store_offset, variants)``: a hot page, drawn from the
        seed among those whose CXL store row the most references hold, its
        row's offset, and two variants whose snapshots reference it."""
        dep = self.dep
        rng = np.random.default_rng([self.seed & gen.MASK63, 47])
        a = int(rng.integers(dep.n_fn))
        pages = np.asarray(dep.ws[a], dtype=np.int64)
        slots = self._slot(a, pages)
        cxl = (slots != reference.ZERO_SLOT) & ((slots >> reference.TAG_SHIFT)
                                                == np.uint64(reference.TAG_CXL))
        pages, slots = pages[cxl], slots[cxl]
        offs = (slots & reference.OFF_MASK).astype(np.int64)
        refs = dep.pool.dedup_cxl.refcounts()
        held = np.array([refs.get(int(o), 0) for o in offs], dtype=np.int64)
        best = np.flatnonzero(held == held.max())
        i = int(best[rng.integers(best.size)])
        page, off, slot = int(pages[i]), int(offs[i]), int(slots[i])
        others = [f for f in range(dep.n_fn)
                  if f != a and int(self._slot(f, np.array([page]))[0]) == slot]
        if not others:
            raise RuntimeError(f"no hot page of {dep.name(a, dep.version[a])} shares its "
                               "store row with another variant: the layout is not dedup")
        return page, off, [a, int(others[rng.integers(len(others))])]

    def _tamper_shared(self) -> int:
        dep = self.dep
        _page, off, variants = self.shared_target()
        arena, at = dep.pool.cxl.buf, off + 321
        good = arena[at].clone()
        arena[at] = good ^ 0x5A
        undetected = 0
        try:
            for f in variants:
                try:
                    self.run(0, SHARED_K, f, fault_timeout_s=2.0)
                    undetected += 1
                except Exception:
                    pass
        finally:
            arena[at] = good
            dep.sync()
        return undetected
