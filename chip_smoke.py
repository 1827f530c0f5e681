#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's publish→restore main path on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. card    — ``nvidia-smi`` name and power limit; no CUDA card is an error.
2. build   — compiles every CUDA kernel of the path from ``src/repro_torch``
             (one nvcc per source, all at once) into ``build/repro_torch_kernels``.
3. image   — a 1.5 GiB guest image (393,216 pages of 4 KiB, the paper's
             default instance) made on the card from ``--seed``: ~60% zero
             pages, ~5.5% hot pages in runs of mean ~5, the rest cold.
4. kernels — each kernel against its plain torch version on the card,
             bit for bit (small, ragged, all-zero, all-hot, all-ones cases,
             the full image for publish, a 256-page chunk and a forced
             checksum mismatch for restore), then CUDA-event timings of
             kernel and plain version beside the least time the card could
             take for the same work.  The restore kernel's time is its
             device time per launch (the C entry point on device-resident
             indices, replayed from a CUDA graph); the wrapper's whole round
             trip is kept beside it as a separate number.
5. main    — ``HierarchicalPool`` → ``build_snapshot(publish_fn=fused)`` →
             ``SnapshotReader`` → ``Instance`` → ``RestoreEngine(FusedScatter)``
             → ``pre_install_hot`` → ``install_all_sync``; the restored image
             must equal the source, every installed page must be verified,
             and both kernels' launch counts (reset just before) must match
             the path's shape.
6. profile — publish and restore once more under ``torch.profiler``:
             device busy time by kernel and copy, and the idle share.

Prints a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to ``--out``.  Modeled ledger
seconds are the paper's CXL/RDMA cost model, not device times.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAGE = 4096
PAPER_INSTANCE_PAGES = (3 << 29) // PAGE       # 1.5 GiB (paper §2.3.3)
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12                        # 32-bit rate outside the tensor cores
PUBLISH_TPU = "src/repro/kernels/snapshot_fuse/kernel.py:94"
RESTORE_TPU = "src/repro/kernels/snapshot_fuse/kernel.py:146"
CSRC = "src/repro_torch/kernels/snapshot_fuse/csrc"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, int_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> int:
    errs = [0]
    for a, b in pairs:
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            errs.append(int((a.to(b.dtype).long() - b.long()).abs().max()))
    return max(errs)


def make_image(n_pages: int, seed: int, device):
    """Guest image on the card: alternating zero / cold regions (geometric
    lengths, means 96 and 55 pages) with hot runs (geometric, mean 5 pages,
    5.5% of the pages) laid over them; non-zero pages hold random bytes."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_reg = int(n_pages / (96 + 55) * 1.5) + 64
    lens = torch.empty(2 * n_reg, device=device)
    lens[0::2].geometric_(1 / 96, generator=g)
    lens[1::2].geometric_(1 / 55, generator=g)
    bounds = torch.cumsum(lens.long(), 0)
    if int(bounds[-1]) < n_pages:
        raise RuntimeError("region draw too short for the image")
    pages = torch.arange(n_pages, device=device)
    zero_region = torch.searchsorted(bounds, pages, right=True) % 2 == 0
    n_hot_runs = round(0.057 * n_pages / 5)    # overlaps merge: ~5.5% hot
    starts = torch.randint(0, n_pages, (n_hot_runs,), generator=g, device=device)
    run_len = torch.empty(n_hot_runs, device=device).geometric_(1 / 5, generator=g).long()
    delta = torch.zeros(n_pages + 1, dtype=torch.long, device=device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, (starts + run_len).clamp(max=n_pages), -torch.ones_like(starts))
    hot = torch.cumsum(delta, 0)[:n_pages] > 0
    buf = torch.randint(0, 256, (n_pages * PAGE,), dtype=torch.uint8, generator=g,
                        device=device)
    buf.view(n_pages, PAGE)[zero_region & ~hot] = 0
    return buf, hot


def check_publish(torch, ops, ref, cases):
    """Kernel vs plain publish, bit for bit, for each (name, pages, ws)."""
    err = 0
    for name, pages, ws in cases:
        got = ops.fused_publish(pages, ws)
        want = ref.fused_publish_ref(pages, ws)
        torch.cuda.synchronize()
        outs = (got.zero_bitmap, got.checksums, got.hot, got.cold)
        for field, a, b in zip(("zero", "csum", "hot", "cold"), outs, want):
            if not torch.equal(a, b):
                raise AssertionError(f"fused_publish differs from plain ({name}, {field})")
        err = max(err, max_abs_err(zip(outs, want)))
        log(f"  publish {name}: n={pages.shape[0]} hot={got.hot.shape[0]} "
            f"cold={got.cold.shape[0]} bit-equal")
    return err


def check_restore(torch, np, ops, ref, dest_rows: int, device):
    """Kernel vs plain restore, bit for bit; a forced mismatch must raise."""
    rng = np.random.default_rng(11)
    err = 0
    for m in (1, 37, 256):
        chunk = torch.randint(0, 256, (m, PAGE), dtype=torch.uint8, device=device)
        chunk[0] = 0xFF                                   # all-ones lanes
        dst = np.sort(rng.choice(dest_rows, m, replace=False))
        src = rng.permutation(m)
        dest_k = torch.zeros((dest_rows, PAGE), dtype=torch.uint8, device=device)
        dest_p = torch.zeros_like(dest_k)
        _, cs = ops.fused_restore(dest_k, chunk, dst, src_indices=src)
        want = ref.fused_restore_ref(dest_p, chunk, torch.from_numpy(src).to(device),
                                     torch.from_numpy(dst).to(device))
        torch.cuda.synchronize()
        if not (torch.equal(dest_k, dest_p) and torch.equal(cs, want)):
            raise AssertionError(f"fused_restore differs from plain (m={m})")
        err = max(err, max_abs_err([(cs, want)]))
        table = torch.zeros(dest_rows, dtype=torch.int32, device=device)
        table[torch.from_numpy(dst).to(device)] = want
        ops.fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
        bad = dst[[0, m - 1]] if m > 1 else dst[:1]
        table[torch.from_numpy(bad).to(device)] ^= 1
        try:
            ops.fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
        except ops.ChecksumMismatchError as e:
            if sorted(e.bad_pages.tolist()) != sorted(set(bad.tolist())):
                raise AssertionError(f"mismatch names {e.bad_pages}, want {bad}") from e
        else:
            raise AssertionError("a forced checksum mismatch did not raise")
        del dest_k, dest_p
        log(f"  restore m={m}: bit-equal, verified, mismatch raised")
    return err


def restore_kernel_ms(torch, kernel, weights, dest, chunk, src_t, dst_t, table,
                      reps: int = 100):
    """Device time per launch of the restore kernel's C entry point, verified
    as on the main path (counter reset + kernel), with indices, table and
    outputs already on the card: ``reps`` launches captured in one CUDA graph
    and replayed, so no host work sits between them.  Also returns the time
    per launch when the host issues the same launches one by one."""
    m = src_t.shape[0]
    csum = torch.empty(m, dtype=torch.int32, device=dest.device)
    n_bad = torch.empty(1, dtype=torch.int32, device=dest.device)

    def launch():
        kernel.restore(dest, chunk, src_t, dst_t, weights, table, csum, n_bad)

    issued_ms = cuda_ms(launch, iters=200, warmup=10)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph_ms = cuda_ms(graph.replay, iters=20, warmup=2) / reps
    if int(n_bad.item()) != 0 or not torch.equal(csum, table[dst_t]):
        raise AssertionError("timed restore launches disagree with the checksum table")
    return graph_ms, issued_ms


def _device_summary(torch, prof, wall_s: float, top: int = 8) -> dict:
    """Device busy time (sum of kernel and copy times) and the top entries."""
    dev = torch.autograd.DeviceType.CUDA
    evts = [e for e in prof.key_averages() if e.device_type == dev]
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3) for e in evts),
                  key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "top": [{"name": k, "count": c, "device_ms": t} for k, c, t in rows[:top]]}


def profile_main_path(torch, pool, image, working_set, ops, out_dir: Path) -> dict:
    """Publish and restore once more under torch.profiler (CPU + CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (Instance, RestoreEngine, SnapshotReader, StateImage,
                                  TimeLedger, build_snapshot)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        regions = build_snapshot(pool, image, working_set, "profiled",
                                 publish_fn=ops.make_fused_publish_fn())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["publish"] = _device_summary(torch, prof, wall)
    ledger = TimeLedger()
    reader = SnapshotReader(regions, pool.host_view("host1", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = Instance(StateImage.empty_like(image.manifest, device=image.device), ledger)
    engine = RestoreEngine(reader, inst, scatter_fn=ops.FusedScatter())
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.pre_install_hot()
        engine.install_all_sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["restore"] = _device_summary(torch, prof, wall)
    (out_dir / "profile_restore.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    if not torch.equal(inst.image.buf, image.buf):
        raise AssertionError("profiled restore differs from the published image")
    for phase, row in out.items():
        log(f"profile {phase}: wall {row['wall_ms']:.2f} ms under the profiler, device busy "
            f"{row['device_busy_ms']:.3f} ms, idle share {row['device_idle_share']:.4f}")
        for r in row["top"][:4]:
            log(f"  {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import (ArrayExtent, HierarchicalPool, Instance, Manifest,
                                  RestoreEngine, SnapshotReader, StateImage, TimeLedger,
                                  build_snapshot, free_snapshot, runs_of_indices)
    from repro_torch.kernels import build
    from repro_torch.kernels.snapshot_fuse import kernel, ops, ref

    device = torch.device("cuda", 0)
    n = PAPER_INSTANCE_PAGES
    report = {"seed": args.seed, "pages": n}

    # 1. card
    card = card_line()
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    log(f"card: {card}  ({report['torch']})")

    # 2. build
    t0 = time.perf_counter()
    compiled = build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = dict(build.build_logs)
    log(f"build: {report['build_s']:.2f} s for {sorted(compiled) or 'cached libraries'}")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. image
    t0 = time.perf_counter()
    buf, hot_mask = make_image(n, args.seed, device)
    torch.cuda.synchronize()
    manifest = Manifest([ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = StateImage(manifest, buf)
    hot_np = hot_mask.cpu().numpy()
    zero_np = ~image.pages_matrix().any(dim=1).to(torch.bool).cpu().numpy()
    working_set = np.flatnonzero(hot_np)

    def runs_of(mask):
        return runs_of_indices(np.flatnonzero(mask))[:, 1]

    comp = {"zero": float(zero_np.mean()), "hot": float((hot_np & ~zero_np).mean()),
            "cold": float((~hot_np & ~zero_np).mean()),
            "hot_runs": int(runs_of(hot_np).size),
            "mean_hot_run": float(runs_of(hot_np).mean()),
            "cold_runs": int(runs_of(~hot_np & ~zero_np).size),
            "zero_runs": int(runs_of(zero_np).size),
            "make_s": time.perf_counter() - t0}
    report["composition"] = comp
    log(f"image: {n} pages ({n * PAGE / 2**30:.3f} GiB) zero={comp['zero']:.4f} "
        f"hot={comp['hot']:.4f} cold={comp['cold']:.4f} hot_runs={comp['hot_runs']} "
        f"mean_hot_run={comp['mean_hot_run']:.3f} cold_runs={comp['cold_runs']} "
        f"zero_runs={comp['zero_runs']}")
    if not (0.469 <= comp["zero"] <= 0.907 and 0.04 <= comp["hot"] <= 0.07):
        raise AssertionError(f"composition outside the paper's range: {comp}")

    # 4. kernels against their plain versions
    log("kernels:")
    rng = np.random.default_rng(args.seed)
    small = []
    for name, rows, zero_every, ws_all in (("N=0", 0, 3, False), ("ragged N=37", 37, 3, False),
                                           ("N=1000", 1000, 3, False),
                                           ("all-zero", 64, 1, False),
                                           ("all-hot", 64, 0, True)):
        p = torch.from_numpy(rng.integers(0, 256, (rows, PAGE), dtype=np.uint8)).to(device)
        if zero_every:
            p[::zero_every] = 0
        if zero_every == 3:
            p[1::7] = 0xFF                                # all-ones lanes: the wrap case
        w = (torch.ones(rows, dtype=torch.bool, device=device) if ws_all
             else torch.from_numpy(rng.random(rows) < 0.3).to(device))
        small.append((name, p, w))
    ws_full = torch.zeros(n, dtype=torch.bool, device=device)
    ws_full[torch.from_numpy(working_set).to(device)] = True
    pm = image.pages_matrix()
    pub_err = check_publish(torch, ops, ref, small + [("1.5 GiB image", pm, ws_full)])
    res_err = check_restore(torch, np, ops, ref, n, device)

    # timings at the main path's shapes
    nnz = int((~zero_np).sum())
    pub_ms = cuda_ms(lambda: ops.fused_publish(pm, ws_full), iters=10)
    pub_plain_ms = cuda_ms(lambda: ref.fused_publish_ref(pm, ws_full), iters=3, warmup=1)
    pub_bytes = n * PAGE + n + PAGE + n + 4 * n + nnz * PAGE + 8
    pub_bound, pub_by = bound_ms(pub_bytes, 3 * n * (PAGE // 4))
    m = 256
    chunk = pm[torch.from_numpy(working_set[:m]).to(device)].contiguous()
    dst = working_set[:m]
    dest = torch.zeros_like(pm)
    table = torch.zeros(n, dtype=torch.int32, device=device)
    table[torch.from_numpy(dst).to(device)] = ops.fused_restore(dest, chunk, dst)[1]
    src_t = torch.arange(m, device=device)
    dst_t = torch.from_numpy(dst).to(device)
    res_ms, res_issued_ms = restore_kernel_ms(torch, kernel, ops._weights(device), dest,
                                              chunk, src_t, dst_t, table)
    # the wrapper's whole round trip: index checks, H2D index copy, launch, read-back
    res_wrapper_ms = cuda_ms(lambda: ops.fused_restore(dest, chunk, dst, expected_table=table),
                             iters=200, warmup=10)
    res_wrapper_unverified_ms = cuda_ms(lambda: ops.fused_restore(dest, chunk, dst),
                                        iters=200, warmup=10)
    res_plain_ms = cuda_ms(lambda: ref.fused_restore_ref(dest, chunk, src_t, dst_t),
                           iters=50, warmup=5)
    res_bound, res_by = bound_ms(2 * m * PAGE + 2 * 8 * m + 4 * m + 4 * m + PAGE,
                                 3 * m * (PAGE // 4))
    report["restore_timings_ms"] = {
        "kernel_graph_replay": res_ms, "kernel_host_issued": res_issued_ms,
        "wrapper_verified": res_wrapper_ms, "wrapper_unverified": res_wrapper_unverified_ms}
    del dest, chunk, table
    torch.cuda.empty_cache()
    log(f"  fused_publish  {pub_ms:.4f} ms (plain {pub_plain_ms:.4f} ms, bound "
        f"{pub_bound:.4f} ms by {pub_by}) at {n} pages")
    log(f"  fused_restore  kernel {res_ms:.5f} ms per launch, verified, from a CUDA graph "
        f"({res_issued_ms:.5f} ms issued one by one from the host); wrapper round trip "
        f"{res_wrapper_ms:.4f} ms verified, {res_wrapper_unverified_ms:.4f} ms unverified "
        f"(plain {res_plain_ms:.4f} ms, bound {res_bound:.6f} ms by {res_by}) per "
        f"{m}-page chunk")

    # 5. main path, counts reset just before it
    ops.fused_publish.launches = 0
    ops.fused_restore.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    pool = HierarchicalPool(device="cuda")
    t0 = time.perf_counter()
    regions = build_snapshot(pool, image, working_set, "smoke",
                             publish_fn=ops.make_fused_publish_fn())
    torch.cuda.synchronize()
    publish_s = time.perf_counter() - t0
    ledger = TimeLedger()
    reader = SnapshotReader(regions, pool.host_view("host0", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = Instance(StateImage.empty_like(image.manifest, device="cuda"), ledger)
    engine = RestoreEngine(reader, inst, scatter_fn=ops.FusedScatter())
    t0 = time.perf_counter()
    engine.pre_install_hot()
    t_hot = time.perf_counter()
    engine.install_all_sync()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    launches = {"fused_publish": ops.fused_publish.launches,
                "fused_restore": ops.fused_restore.launches}
    n_cold_runs = int(reader.cold_runs().shape[0])
    want_restore = math.ceil(regions.n_hot / 256) + n_cold_runs
    verified = inst.scatter_fn.stats["pages_verified"]
    main = {"publish_s": publish_s, "restore_s": restore_s,
            "pre_install_hot_s": t_hot - t0, "n_hot": regions.n_hot,
            "n_cold": regions.n_cold, "n_zero": regions.n_zero,
            "cold_runs": n_cold_runs, "launches": launches,
            "expected_restore_launches": want_restore, "pages_verified": verified,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "peak_mem_above_start_bytes": torch.cuda.max_memory_allocated() - base_mem,
            "modeled_ledger_s": dict(ledger.seconds),
            "modeled_total_s": ledger.total()}
    report["main"] = main
    if not torch.equal(inst.image.buf, image.buf):
        raise AssertionError("restored image differs from the published one")
    if verified != regions.n_hot + regions.n_cold:
        raise AssertionError(f"{verified} pages verified, want {regions.n_hot + regions.n_cold}")
    if launches["fused_publish"] != 1 or launches["fused_restore"] != want_restore:
        raise AssertionError(f"launch counts {launches}, want publish 1, "
                             f"restore {want_restore}")
    log(f"main path: publish {publish_s * 1e3:.2f} ms, restore {restore_s * 1e3:.2f} ms "
        f"(hot pre-install {main['pre_install_hot_s'] * 1e3:.2f} ms) wall; "
        f"n_hot={regions.n_hot} n_cold={regions.n_cold} n_zero={regions.n_zero} "
        f"cold_runs={n_cold_runs}")
    log(f"  bit-identical restore: True; pages verified {verified}; launches {launches}")
    log(f"  peak device memory {main['peak_mem_bytes'] / 2**30:.3f} GiB")
    log(f"  modeled (paper cost model, not device time): total "
        f"{main['modeled_total_s'] * 1e3:.4f} ms {json.dumps(main['modeled_ledger_s'])}")

    kernels = [
        {"name": "fused_publish", "route": "cuda", "source": f"{CSRC}/fused_publish.cu",
         "replaces": PUBLISH_TPU, "launches": launches["fused_publish"],
         "bit_equal": True, "max_abs_err": pub_err, "ms": pub_ms, "plain_ms": pub_plain_ms,
         "bound_ms": pub_bound, "bound_by": pub_by, "library_ms": None},
        {"name": "fused_restore", "route": "cuda", "source": f"{CSRC}/fused_restore.cu",
         "replaces": RESTORE_TPU, "launches": launches["fused_restore"],
         "bit_equal": True, "max_abs_err": res_err, "ms": res_ms, "plain_ms": res_plain_ms,
         "bound_ms": res_bound, "bound_by": res_by, "library_ms": None},
    ]
    report["kernels"] = kernels
    del inst, engine, reader
    free_snapshot(pool, regions)
    torch.cuda.empty_cache()
    report["profile"] = profile_main_path(torch, pool, image, working_set, ops,
                                          Path(args.out).parent)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
