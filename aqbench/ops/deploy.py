"""Deploys: a new version of a function, published beside the live one;
the old version is then deleted and collected.

The mix's settings: ``clients``.  A version's image is made from the seed
before the deploy's own clock starts (the harness's ``input`` span); each
deploy then times ``PoolMaster.publish`` (ending in a device synchronize)
and the retirement.  What the window published is checked after it, as the
live snapshots, by the harness.
"""
from __future__ import annotations


class Op:
    def __init__(self, dep, mix: dict, spans, seed: int, control: str = ""):
        self.dep, self.mix, self.spans = dep, mix, spans
        self.published: list = []      # (pages, non-zero pages) a publish
        self._next: dict = {}

    def prepare(self, c: int, k: int, f: int) -> None:
        """The image of ``f``'s next version, made on the device."""
        dep = self.dep
        self._next[c] = dep.image(f, dep.version[f] + 1)[0]
        dep.sync()

    def run(self, c: int, k: int, f: int) -> dict:
        dep, sp = self.dep, self.spans
        buf = self._next.pop(c)
        old = dep.version[f]
        new = old + 1
        with sp.span("publish"):
            regions = dep.publish(f, new, buf)
            dep.sync()
        del buf
        self.published.append((regions.total_pages, regions.n_hot + regions.n_cold))
        dep.version[f] = new
        with sp.span("retire"):
            if not dep.master.delete(dep.name(f, old)):
                raise RuntimeError(f"delete of {dep.name(f, old)} failed")
            dep.master.gc()
        return {"version": new}

    def window_open(self) -> None:
        d = self.dep.pool
        self._n0 = len(self.published)
        self._decide0 = d.dedup_cxl.decide_s + d.dedup_rdma.decide_s

    def window_close(self) -> tuple:
        d = self.dep.pool
        counters = {"decide_s": d.dedup_cxl.decide_s + d.dedup_rdma.decide_s - self._decide0}
        return counters, {"publish": self.published[self._n0:]}

    def check_before(self, records: list) -> dict:
        return {}

    def check_image(self, f, version, buf, hot) -> None:
        pass

    def check_after(self) -> dict:
        return {}

    def close(self) -> None:
        pass
