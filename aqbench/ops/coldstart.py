"""Cold starts: borrow and attach through the host's node server,
pre-install the hot set, then either the guest's touches of cold pages,
each absent one demand-faulted (``"restore": "lazy"``), or the whole cold
tail installed before resume (``"eager"``); then release.

The mix's settings: ``clients``, ``restore``, ``touches`` (lazy),
``prefetch_cold`` (the background prefetch of the cold tail).  A warm-up
start touches ``WARM_UP_TOUCHES`` pages: the fault path's shapes and
threads, not a whole start.

Every cold start in the window is checked: before its release the harness
takes a fingerprint of each page of the restored instance and the mask of
pages present, and after the window the reference compares them with the
image the seed makes.  A planted fault is checked once after the window:
one stored page that the next start reads is corrupted in its tier, and
that start has to fail rather than install it.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from aqbench import gen, reference

TAMPER_K = -2          # the start index of the planted fault's cold start
WARM_UP_TOUCHES = 64
FAULT_TIMEOUT_S = 120.0


class Op:
    def __init__(self, dep, mix: dict, spans, seed: int, control: str = ""):
        core = dep.core
        self.dep, self.mix, self.spans, self.seed = dep, mix, spans, int(seed)
        self.verify = control != "unverified"
        self.lazy = mix["restore"] == "lazy"
        self.server = core.NodePageServer("host", dep.pool)
        self.hot_chunk_requests = 0
        inner, lock = self.server.hot_chunk, threading.Lock()

        def counted_hot_chunk(*args, **kwargs):
            with lock:
                self.hot_chunk_requests += 1
            return inner(*args, **kwargs)

        self.server.hot_chunk = counted_hot_chunk
        self.orchs = [core.Orchestrator(f"host-{c}", dep.pool, dep.master.catalog,
                                        node_server=self.server)
                      for c in range(int(mix["clients"]))]
        self.scatter_stats: list = []
        self.mismatches, self._lock = 0, threading.Lock()
        self._by_image: dict = {}
        self.n = {"restored_missing": 0, "restored_bytes": 0}

    def prepare(self, c: int, k: int, f: int) -> None:
        pass

    def run(self, c: int, k: int, f: int, fault_timeout_s: float = None) -> dict:
        dep, mix, sp = self.dep, self.mix, self.spans
        timeout = fault_timeout_s or FAULT_TIMEOUT_S
        orch = self.orchs[c]
        orch.scatter_fn = dep.kernels.FusedScatter() if self.verify else None
        if orch.scatter_fn is not None:
            self.scatter_stats.append(orch.scatter_fn.stats)
        name = dep.name(f, dep.version[f])
        t0 = time.time_ns()
        with sp.span("attach"):
            ri = orch.restore(name, pre_install=False,
                              prefetch_cold=bool(mix["prefetch_cold"]))
        if ri is None:
            raise RuntimeError(f"the borrow of {name} failed")
        try:
            with sp.span("pre_install"):
                ri.engine.pre_install_hot()
            sp.add("time_to_hot", t0, time.time_ns())
            touched = np.zeros(0, dtype=np.int64)
            if self.lazy:
                with sp.span("zero_runs"):
                    ri.engine.install_zero_runs()
                n = int(mix["touches"]) if k >= 0 else WARM_UP_TOUCHES
                touched = gen.touches(dep.cold[f], n, self.seed, c, k)
                present = ri.instance.present
                with sp.span("guest"):
                    for p in touched.tolist():
                        if present[p]:
                            ri.engine.access(p)
                            continue
                        with sp.span("fault"):
                            ri.engine.access(p, timeout_s=timeout)
            else:
                with sp.span("install_all"):
                    ri.engine.install_all_sync()
            with sp.span("check_fp"):
                # the pages present first: a sibling restore of the same
                # snapshot may still install into this one (fan-out), and a
                # page it adds after this copy is not held to its bytes
                present = ri.instance.present.copy()
                dep.sync()
                fps = reference.page_fps(ri.instance.image.buf).cpu().numpy()
        finally:
            with self._lock:
                self.mismatches += int(ri.engine.repair_stats["checksum_mismatches"])
            with sp.span("release"):
                ri.shutdown()
        return {"version": dep.version[f], "fps": fps, "present": present, "touched": touched}

    def window_open(self) -> None:
        self._stats0 = len(self.scatter_stats)
        self._chunks0 = (self.hot_chunk_requests, int(self.server.chunks.stats["fanout_hits"]))
        self._launches0 = self._launches()
        self._mismatches0 = self.mismatches

    def _launches(self) -> int:
        k = self.dep.kernels
        return int(k.fused_restore.launches) + int(k.page_scatter.launches)

    def window_close(self) -> tuple:
        counters = {"restore_launches": self._launches() - self._launches0,
                    "hot_chunk_requests": self.hot_chunk_requests - self._chunks0[0],
                    "fanout_hits": int(self.server.chunks.stats["fanout_hits"]) - self._chunks0[1],
                    "checksum_mismatches": self.mismatches - self._mismatches0}
        work = {"restore_pages": sum(int(s["pages"]) for s in self.scatter_stats[self._stats0:])}
        return counters, work

    # -- the check ----------------------------------------------------------

    def check_before(self, records: list) -> dict:
        """The planted fault, then the window's starts grouped by image."""
        for r in records:
            self._by_image.setdefault((r["function"], r["version"]), []).append(r)
        return {"tamper_undetected": self._tamper()}

    def _tamper(self) -> int:
        """Corrupt one byte of a cold page in the tier the next start reads
        it from, run that start, put the byte back: 1 if the start installed
        the page without failing."""
        dep = self.dep
        f = int(np.random.default_rng([self.seed & gen.MASK63, 43]).integers(dep.n_fn))
        cold = dep.cold[f]
        page = int(gen.touches(cold, 1, self.seed, 0, TAMPER_K)[0] if self.lazy else cold[0])
        reg = dep.master.catalog.find(dep.name(f, dep.version[f])).regions
        cxl = dep.pool.cxl.buf
        slot = int(cxl[reg.oa_off + page * 8:reg.oa_off + page * 8 + 8].cpu().numpy()
                   .view(np.uint64)[0])
        tag, off = slot >> int(reference.TAG_SHIFT), slot & int(reference.OFF_MASK)
        arena = dep.pool.rdma.buf if tag == reference.TAG_RDMA else cxl
        if not reg.dedup:
            off += reg.rdma_off if tag == reference.TAG_RDMA else reg.hot_off
        at = off + 123
        good = arena[at].clone()
        arena[at] = good ^ 0x5A
        try:
            self.run(0, TAMPER_K, f, fault_timeout_s=2.0)
            return 1
        except Exception:
            return 0
        finally:
            arena[at] = good
            dep.sync()

    def check_image(self, f: int, version: int, buf: torch.Tensor, hot: torch.Tensor) -> None:
        rs = self._by_image.pop((f, version), [])
        if not rs:
            return
        want = reference.page_fps(buf).cpu().numpy()
        cls = reference.classes(buf, hot)
        for r in rs:
            got = reference.check_restore(r["fps"], r["present"], want, cls, r["touched"],
                                          full=not self.lazy)
            self.n["restored_missing"] += got["missing"]
            self.n["restored_bytes"] += got["bytes"]

    def check_after(self) -> dict:
        """Starts of an image that is no longer live (none in these mixes)
        are checked here."""
        for (f, version), rs in list(self._by_image.items()):
            buf, hot = self.dep.image(f, version)
            self.check_image(f, version, buf, hot)
        return dict(self.n)

    def close(self) -> None:
        for o in self.orchs:
            o.close()
        self.server.close()
