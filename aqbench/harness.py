"""The general harness: a deployment built from its configuration file, a
closed loop of clients driven by its traffic file, the window, the check.

Nothing here names a cell, an operation or a kind of image.
``BENCHMARK.json`` names a cell's configuration and traffic mix; each is
found by name, and so is what they name in turn:

* the configuration, ``configs/<name>.json`` (``file`` in ``BENCHMARK.json``),
  names its kind of images, ``images/<images>.py``;
* the traffic mix, ``traffic/<name>.json``, names its operation,
  ``ops/<op>.py``, and holds every setting the operation reads;
* each metric is read by ``metrics/<name>.py``, or where there is none, by
  the reader of its name without the last dotted part
  (``device_idle.deploy`` by ``metrics/device_idle.py``).

A later cell, mix, operation, kind of image or metric is a new file and a
new entry.  The program under test is the PyTorch port (``src/repro_torch``):
its pool and ``PoolMaster``, and what an operation drives.  The harness
records spans around its calls into them and reads their counters;
``reference.py`` judges what they stored and restored.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import gen, reference
from .trace import Spans, device_events, reduce_trace

PAGE = gen.PAGE
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ------------------------------------------------------------------ finding files

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    cfg = json.loads((root / find(bench, "configs", name)["file"]).read_text())
    if int(cfg["page_bytes"]) != PAGE:
        raise ValueError(f"{name}: the program's pages are {PAGE} bytes, "
                         f"not {cfg['page_bytes']}")
    return cfg


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_module(folder: str, name: str):
    """``aqbench/<folder>/<name>.py`` as a module."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"aqbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_file(name: str) -> str:
    """The reader of metric ``name``: ``metrics/<name>.py``, or that of its
    name without the last dotted part."""
    while not (HERE / "metrics" / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {name!r} in {HERE / 'metrics'}")
        name = name.rsplit(".", 1)[0]
    return name


def load_reader(name: str):
    """The ``read(rec)`` of the metric's reader."""
    return load_module("metrics", reader_file(name)).read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with a
    trace its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


# ------------------------------------------------------------------ the deployment

class Deployment:
    """The pool, its master and the live snapshots of one configuration,
    published from images the seed makes on ``device``."""

    def __init__(self, cfg: dict, seed: int, device, stores_for_versions: bool = True):
        from repro_torch import core, kernels

        self.core, self.kernels = core, kernels
        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.n_pages = int(cfg["image_pages"])
        self.n_fn = int(cfg["functions"])
        self.dedup = cfg["layout"] == "dedup"
        self.stores_for_versions = stores_for_versions
        self.pool = core.HierarchicalPool(
            cxl_capacity=int(cfg["cxl_capacity_bytes"]),
            rdma_capacity=int(cfg["rdma_capacity_bytes"]), device=self.device,
            dedup_hash_fn=core.poly32_hash_fn if cfg["dedup_hash"] == "poly32" else None)
        self.master = core.PoolMaster(self.pool, publish_fn=kernels.make_fused_publish_fn(),
                                      dedup=self.dedup)
        n = self.n_pages
        self.manifest = core.Manifest(
            [core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
        self.images = load_module("images", cfg["images"]).Images(cfg, self.seed, self.device)
        self.version = [0] * self.n_fn
        self.ws, self.cold = [], []
        for f in range(self.n_fn):
            buf, hot = self.image(f, 0)
            self.ws.append(torch.nonzero(hot).view(-1).cpu().numpy())
            self.cold.append(gen.page_classes(buf, hot)[1].cpu().numpy())
            self.publish(f, 0, buf)
            del buf, hot

    @staticmethod
    def name(f: int, version: int) -> str:
        return f"fn{f}.{version}"

    def image(self, f: int, version: int) -> tuple:
        """``(buf, hot)`` of function ``f`` at ``version``, from the seed."""
        return self.images.image(f, version)

    def publish(self, f: int, version: int, buf: torch.Tensor):
        image = self.core.StateImage(self.manifest, buf)
        dedup = self.dedup and (version == 0 or self.stores_for_versions)
        return self.master.publish(self.name(f, version), image, self.ws[f], dedup=dedup)

    def live(self) -> list:
        return [(f, self.version[f], self.master.catalog.find(self.name(f, self.version[f])))
                for f in range(self.n_fn)]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ------------------------------------------------------------------ a run

class _GcClock:
    """Seconds the interpreter's cyclic collector ran, and its full
    collections, from its start to ``stop``."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, None
        gc.callbacks.append(self._on)

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.full += int(info.get("generation") == 2)
            self._t = None

    def stop(self) -> None:
        if self._on in gc.callbacks:
            gc.callbacks.remove(self._on)


def warm_up(ops, dep: Deployment, targets: list) -> None:
    """One operation a client, all at once, on each client's first target:
    every shape and every thread the window uses exists before it starts."""
    errors = []

    def one(c: int) -> None:
        try:
            ops.prepare(c, -1, targets[c])
            ops.run(c, -1, targets[c])
        except Exception:
            errors.append(traceback.format_exc(limit=8))

    threads = [threading.Thread(target=one, args=(c,), name=f"aqbench-warm-{c}")
               for c in range(len(targets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("warm-up failed:\n" + errors[0])
    dep.sync()


def run(cell: str, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device="cuda", control: str = "", t_start: float = None) -> dict:
    """One run of a cell: set-up, window, drain, check.  Returns the record
    the metric readers read, with the check's numbers under ``checks``."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    if on_card:
        from repro_torch.kernels import build

        build.build([n for n in build.SOURCES if not n.startswith("flash_attention")])
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans()
    parts["build"] = time.perf_counter() - t_start - sum(parts.values())
    dep = Deployment(cfg, seed, dev, stores_for_versions=control != "nodedup")
    parts["deployment"] = time.perf_counter() - t_start - sum(parts.values())
    ops = load_module("ops", mix["op"]).Op(dep, mix, spans, seed, control)
    clients = int(mix["clients"])
    picks = []
    for c in range(clients):
        owned = ([f for f in range(dep.n_fn) if f % clients == c] if mix.get("partition")
                 else list(range(dep.n_fn)))
        p = gen.Picks(len(owned), mix["pick"], float(mix.get("zipf_s", 0)), seed, c)
        picks.append(lambda owned=owned, p=p: owned[p.next()])
    warm_up(ops, dep, [picks[c]() for c in range(clients)])
    parts["warm_up"] = time.perf_counter() - t_start - sum(parts.values())
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    ops.window_open()
    records = [[] for _ in range(clients)]
    go = threading.Barrier(clients + 1)
    window = {}

    def client(c: int) -> None:
        go.wait()
        k = 0
        while time.time_ns() < window["end"]:
            f = picks[c]()
            rec = {"client": c, "k": k, "function": f, "t0": time.time_ns()}
            try:
                with spans.span("input"):
                    ops.prepare(c, k, f)
                rec.update(ops.run(c, k, f))
                rec["ok"] = True
            except Exception:
                rec["ok"] = False
                rec["error"] = traceback.format_exc(limit=8)
            rec["t1"] = time.time_ns()
            records[c].append(rec)
            k += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"aqbench-client-{c}",
                                daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    setup_s = time.perf_counter() - t_start
    cpu0, times0 = time.process_time(), os.times()
    gc_clock = _GcClock()
    t0 = time.time_ns()
    window["end"] = t0 + int(seconds * 1e9)
    go.wait()
    for t in threads:
        t.join(timeout=seconds + 600)
    hung = [t.name for t in threads if t.is_alive()]
    dep.sync()
    t_drained = time.time_ns()
    # the process's CPU seconds in the window: with the rate, the CPU time
    # an operation took, whether the host was fast or the work was more
    times1 = os.times()
    gc_clock.stop()
    host = {"process_cpu_s": time.process_time() - cpu0,
            "user_s": times1.user - times0.user, "sys_s": times1.system - times0.system,
            "gc_s": gc_clock.seconds, "gc_full": gc_clock.full, "setup_parts": parts}
    trace_red = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_red = reduce_trace(device_events(prof) if on_card else [], t0, t_drained, spans)
        del prof
    flat = [r for rs in records for r in rs]
    failed = [r for r in flat if not r["ok"]]
    # the work done inside the window: every operation it finished, and of
    # each one still running at its end the share of its time inside it
    done = sum((min(r["t1"], window["end"]) - r["t0"]) / max(1, r["t1"] - r["t0"])
               for r in flat if r["ok"])
    counters, work = ops.window_close()
    counters["ops"] = len(flat) - len(failed)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    live = dep.live()
    pool = {"cxl_bytes": dep.pool.cxl.bytes_in_use, "rdma_bytes": dep.pool.rdma.bytes_in_use,
            "image_bytes": len(live) * dep.n_pages * PAGE}
    t_check = time.perf_counter()
    try:
        checks = check(dep, ops, live, flat, failed, hung)
    finally:
        ops.close()
    return {"cell": cell, "op": mix["op"], "window_s": seconds, "setup_s": setup_s,
            "done": done, "attempted": len(flat), "failed": len(failed),
            "errors": [r["error"] for r in failed][:3] + [f"hung: {h}" for h in hung],
            "seconds": spans.by_name(t0, t_drained), "counters": counters, "work": work,
            "pool": pool, "trace": trace_red, "memory_peak_bytes": peak,
            "host": host,
            "check_s": time.perf_counter() - t_check, "checks": checks}


# ------------------------------------------------------------------ the check

def _record(regions) -> dict:
    """The program's record of one snapshot, as plain values."""
    return {"total_pages": regions.total_pages, "n_hot": regions.n_hot,
            "n_cold": regions.n_cold, "n_zero": regions.n_zero, "oa_off": regions.oa_off,
            "hot_off": regions.hot_off, "rdma_off": regions.rdma_off,
            "dedup": bool(regions.dedup), "checksums": getattr(regions, "page_checksums", None)}


def _slots(cxl: torch.Tensor, regions, tag: int) -> np.ndarray:
    oa = cxl[regions.oa_off:regions.oa_off + regions.total_pages * 8].cpu().numpy().view(np.uint64)
    sel = (oa != reference.ZERO_SLOT) & ((oa >> reference.TAG_SHIFT) == np.uint64(tag))
    return (oa[sel] & reference.OFF_MASK).astype(np.int64)


def check(dep: Deployment, ops, live: list, flat: list, failed: list, hung: list) -> dict:
    """Every number compared, each with its limit (a number passes at or
    under it): what the operation checks itself (its answers in the window,
    a planted fault), the live snapshots against the images the seed makes,
    the pool's storage against the least the snapshots need."""
    n = {"failed_ops": len(failed) + len(hung), "no_ops": int(len(flat) == len(failed))}
    n.update(ops.check_before([r for r in flat if r["ok"]]))
    cxl, rdma = dep.pool.cxl.buf, dep.pool.rdma.buf
    n.update({"format_counts": 0, "format_slots": 0, "format_stored_bytes": 0,
              "format_checksums": 0})
    need_pages = 0
    distinct = {"cxl": [], "rdma": []}
    dedup_slots = {"cxl": [], "rdma": []}
    for f, version, entry in live:
        buf, hot = dep.image(f, version)
        ops.check_image(f, version, buf, hot)
        if entry is None or entry.regions is None:
            n["format_counts"] += 1
            continue
        reg = entry.regions
        got = reference.check_snapshot(_record(reg), cxl, rdma, buf, hot)
        for key in ("counts", "slots", "stored_bytes", "checksums"):
            n["format_" + key] += got[key]
        cls = reference.classes(buf, hot)
        rows = buf.view(-1, PAGE)
        need_pages += reg.ms_size // PAGE + -(-dep.n_pages * 8 // PAGE)
        if dep.dedup:
            # the configuration's guarantee: equal pages of a tier stored once
            distinct["cxl"].append(rows[cls["hot"]])
            distinct["rdma"].append(rows[cls["cold"]])
        else:
            need_pages += int(cls["hot"].numel()) + max(1, int(cls["cold"].numel()))
        if reg.dedup:
            dedup_slots["cxl"].append(_slots(cxl, reg, reference.TAG_CXL))
            dedup_slots["rdma"].append(_slots(cxl, reg, reference.TAG_RDMA))
        del buf, hot, cls, rows
    if distinct["cxl"]:
        counts = reference.distinct_pages(distinct)
        need_pages += counts["cxl"] + counts["rdma"]
        n["dedup_refs"] = (reference.dedup_refs(dedup_slots["cxl"], dep.pool.dedup_cxl.refcounts())
                           + reference.dedup_refs(dedup_slots["rdma"],
                                                  dep.pool.dedup_rdma.refcounts()))
    distinct.clear()
    held = (dep.pool.cxl.bytes_in_use + dep.pool.rdma.bytes_in_use) // PAGE
    n["excess_pages"] = abs(held - need_pages)
    n.update(ops.check_after())
    return {name: {"value": int(v), "limit": 0} for name, v in n.items()}


def passed(checks: dict) -> bool:
    """Every number at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
