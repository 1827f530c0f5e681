#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's publish→restore paths and its model on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. card    — ``nvidia-smi`` name and power limit; no CUDA card is an error.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch``
             (one nvcc per source, all at once) into ``build/repro_torch_kernels``.
3. image   — a 1.5 GiB guest image (393,216 pages of 4 KiB, the paper's
             default instance) made on the card from ``--seed``: ~60% zero
             pages, ~5.5% hot pages in runs of mean ~5, the rest cold.
4. kernels — each of the six kernels against its plain torch version on the
             card, bit for bit (small, ragged, a partial fourth publish tile,
             all-zero, none-zero, all-0xFF cases; the full image for publish
             (its one-pass kernel's registers and spills read back by
             ``cuobjdump -res-usage``), zero_detect and
             page_checksum; the image's hot and cold sets for page_gather;
             one-segment restores and a forced checksum mismatch; rows past
             2^31 bytes of a 3 GiB arena for page_gather and page_scatter).
             The row-list forms of fused_restore and page_scatter at the
             private walks' shapes — the hot walk in 256-page chunks, the cold walk in guest
             runs, one segment an extent: verified installs, verify-only
             launches, three forced mismatches named exactly, the row
             scatter.  Then CUDA-event times of each kernel, its plain
             version and its library yardstick at the paths' shapes, beside
             the least time the card could take for the same work: the
             row-list kernels one launch a walk on a device-resident row list,
             and page_scatter's store write in
             turns with ``Tensor.index_copy_``.
5. main    — the private layout: ``HierarchicalPool`` →
             ``build_snapshot(publish_fn=fused)`` → ``SnapshotReader`` →
             ``Instance`` → ``RestoreEngine(FusedScatter)`` →
             ``pre_install_hot`` → ``install_all_sync``; the restored image
             must equal the source, every installed page must be verified,
             both walks must take the batched route, and both kernels'
             launch counts (reset just before) must match it: one publish,
             a verify-only launch and an install a walk.  Then the same
             snapshot restored on the batched and the per-extent route in
             turns (walls; routes asserted).
6. profile — the private path once more under ``torch.profiler``, the
             restore on both routes: device busy time by kernel and copy,
             and the idle share.
7. dedup   — a fleet of four variants of the image (shared base hot pages,
             a per-variant hot delta of round(n_hot*12/256) pages, a
             per-variant cold arena, shared zero pages) published into one
             content-addressed pool: variants 0 and 1 through the default
             kernels (zero_detect, page_gather, page_checksum as the store
             hash, page_scatter for store writes and restores), 2 and 3
             through the fused publish and the verified fused restore.  Store
             counts, refcounts (I6), the CXL estimate, every restore (all
             walks batched), the reconstruction of variant 3 and the launch
             counts of all six kernels (reset just before) must match the
             fleet's shape; variants 0 and 2 are restored again on both
             routes in turns; freeing the fleet must empty both stores.  One
             more variant is published and restored on both routes under
             ``torch.profiler``.

8. pod     — the pod's control plane at the same 1.5 GiB image:
             ``PoolMaster(publish_fn=fused).publish``; host a, a
             ``NodePageServer`` behind an ``Orchestrator``, attaches 8
             restores of the snapshot (one fan-out group) and each session's
             own thread pre-installs the hot set, installs the zero runs,
             starts the prefetcher and touches 1,024 cold pages in seeded
             order through ``access``; host b restores once through
             ``Orchestrator(prefetch_cold=True).restore`` beside them.  Once
             the nine borrows are out, an update (4,096 pages rewritten,
             driven through ``PoolMaster.publish_steps`` with a 1 ms poll)
             starts and must stay draining until the last
             ``RestoredInstance.shutdown``; version 1 is then restored on
             host b.  Every image bit-identical and every page verified, one
             CXL read per hot chunk for the group (7 fan-out hits each), two
             publish launches, every fused_restore launch accounted; delete and gc
             return the pool to its start, the servers park and no thread
             is left.  Prints time to hot and to full per instance, the
             fault-service latency of absent pages, the phase wall, the
             device idle share over a 3 s window under ``torch.profiler``
             once the nine borrows are out, and the peak memory.

9. model   — flash attention against its plain versions on the card, each
             case on the route ``ops.route`` gives it and asserted so: bf16
             with Dk == Dv in {64, 128} on the tensor-core kernel
             (``flash_attention_sm90.cu``), float32 and Dk != Dv on the SIMT
             kernel (``flash_attention.cu``); the prefill path's shape B=1,
             Hq=24, Hkv=8, S=8192, D=128, causal, one tile, keys not a
             multiple of 128, ragged Sq < Skv and non-causal cases; bf16
             within one rounding of the float32 reference on the upcast
             inputs, 2^-8|want| + 1e-4, float32 within 1e-5.  At the prefill
             shape, in turns in one call, the tensor-core kernel, the SIMT
             kernel on the same bf16 inputs and ``scaled_dot_product_attention``,
             beside the plain version and the bound; whether the library's
             SASS holds HGMMA and UTMALDG.  Then Phi-4-mini 3.8B at full width
             from seeded random weights: ``build(...).forward`` over one
             8,192-token sequence with all 32 layers (32 launches, all on the
             tensor-core route, finite logits), the
             serving engine answering 4 requests of 128-token prompts with 32
             new tokens each through ``generate`` (decode attention, no
             kernel launch), the full-depth bf16 forward's last logits against
             the engine's prefill logits (printed), and decode against forward
             at full width, 2 layers, float32 (relative error < 2e-3).  One
             prefill forward and four decode steps run under torch.profiler.

Prints each phase's wall time, a ``{"kernels": [...]}`` line, the card line,
and as the last line ``{"ok": true, "device": {...}}``.  Details go to
``--out``.  Modeled ledger seconds are the paper's CXL/RDMA cost model, not
device times.
"""
from __future__ import annotations

import argparse
import json
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
ROW_KERNELS = {   # name -> the TPU kernel it replaces
    "zero_detect": "src/repro/kernels/zero_detect/kernel.py:26",
    "page_checksum": "src/repro/kernels/page_checksum/kernel.py:22",
    "page_gather": "src/repro/kernels/page_gather/kernel.py:26",
    "page_scatter": "src/repro/kernels/page_scatter/kernel.py:25",
}
ARENA_BYTES = 3 << 30          # the dedup pool's RDMA arena: rows pass 2^31 bytes
N_VARIANTS = 4
POD_SESSIONS = 8     # co-located restores on host a: concurrency_bench.py's level 8
POD_TOUCHES = 1024   # guest touches an instance makes, cold pages in seeded order
POD_DELTA = 4096     # non-zero pages the update rewrites
POD_PROFILE_S = 3.0  # the profiled window of the group restore, once all borrows are out
BF16_FLOPS_PER_S = 989e12                      # H100 SXM data sheet, dense tensor cores
F32_FLOPS_PER_S = 67e12                        # float32 outside the tensor cores
MODEL_ARCH = "phi4-mini-3.8b"
PREFILL_SEQ = 8192          # prefill_32k cut to one 8,192-token sequence
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:91"
FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc"
FLASH_SRC = {"sm90": f"{FLASH_CSRC}/flash_attention_sm90.cu",
             "simt": f"{FLASH_CSRC}/flash_attention.cu"}


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


def publish_bound(n: int, nnz: int):
    """The publish sweep's bound ``(ms, by, bytes)`` at ``n`` pages of which
    ``nnz`` are non-zero: the pages read once, the non-zero pages written
    once, 6 bytes a page of flags and checksums, the weights and the counts."""
    nbytes = n * PAGE + n + PAGE + n + 4 * n + nnz * PAGE + 8
    return (*bound_ms(nbytes, 3 * n * (PAGE // 4)), nbytes)


def time_publish(torch, ops, ref, pm, ws, nnz: int) -> dict:
    """The publish kernel's own time (memset and kernel, launched back to
    back on preallocated outputs), the wrapper's (the working set's size read
    before the launch, the counts after), the plain version's, and the bound
    (``publish_bound``)."""
    from repro_torch.kernels.page_checksum.ops import weights_on
    from repro_torch.kernels.snapshot_fuse import kernel

    n = pm.shape[0]
    n_ws = int(ws.sum())
    t = ops.PUBLISH_TILE_PAGES
    zero = torch.empty(n, dtype=torch.bool, device=pm.device)
    csum = torch.empty(n, dtype=torch.int32, device=pm.device)
    out, counts = torch.empty_like(pm), torch.empty(2, dtype=torch.int32, device=pm.device)
    scratch = torch.empty(1 + -(-n // t), dtype=torch.int64, device=pm.device)
    w = weights_on(pm.device, PAGE // 4)

    def launch():
        kernel.publish(pm, ws, w, n_ws, t, zero, csum, out, counts, scratch)

    ms = cuda_ms(launch, iters=20)
    del out
    bound, by, nbytes = publish_bound(n, nnz)
    return {"ms": ms, "wrapper_ms": cuda_ms(lambda: ops.fused_publish(pm, ws), iters=10),
            "plain_ms": cuda_ms(lambda: ref.fused_publish_ref(pm, ws), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "tile_pages": t}


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
    """Publish once more, then restore on the batched and on the per-extent
    route, under torch.profiler (CPU + CUDA)."""
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
    for key, scatter in (("restore", ops.FusedScatter()),
                         ("restore_per_extent", PerExtentScatter())):
        ledger = TimeLedger()
        reader = SnapshotReader(regions, pool.host_view(f"host-{key}", ledger), pool.rdma)
        reader.invalidate_cxl()
        inst = Instance(StateImage.empty_like(image.manifest, device=image.device), ledger)
        engine = RestoreEngine(reader, inst, scatter_fn=scatter)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.pre_install_hot()
            engine.install_all_sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[key] = _device_summary(torch, prof, wall)
        out[key]["walk_routes"] = engine.walk_routes
        check_routes(f"profiled {key}", engine.walk_routes,
                     "" if key == "restore" else "scatter_fn")
        (out_dir / f"profile_{key}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
        if not torch.equal(inst.image.buf, image.buf):
            raise AssertionError(f"profiled {key} differs from the published image")
        del inst, engine, reader
    for phase, row in out.items():
        log(f"profile {phase}: wall {row['wall_ms']:.2f} ms under the profiler, device busy "
            f"{row['device_busy_ms']:.3f} ms, idle share {row['device_idle_share']:.4f}")
        for r in row["top"][:4]:
            log(f"  {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return out


def _require_equal(name: str, got, want) -> None:
    import torch

    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version")


def check_row_kernels(torch, np, pm, fused_csum, hot_idx, cold_idx, device) -> dict:
    """The four piecemeal kernels against their plain versions on the card,
    bit for bit; returns each kernel's largest absolute difference (0)."""
    from repro_torch.kernels import page_checksum, page_gather, page_scatter, zero_detect
    from repro_torch.kernels.page_checksum.ref import page_checksum_ref
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.page_scatter.ref import page_scatter_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    rng = np.random.default_rng(5)
    err = dict.fromkeys(ROW_KERNELS, 0)

    def pages(rows, fill):
        if fill is not None:
            return torch.full((rows, PAGE), fill, dtype=torch.uint8, device=device)
        p = torch.from_numpy(rng.integers(0, 256, (rows, PAGE), dtype=np.uint8)).to(device)
        p[::3] = 0
        p[1::7] = 0xFF
        return p

    cases = [(name, pages(rows, fill)) for name, rows, fill in (
        ("N=0", 0, None), ("ragged N=37", 37, None), ("N=1000", 1000, None),
        ("all-zero", 64, 0), ("none-zero", 64, 7), ("all-0xFF", 64, 0xFF))]
    cases.append(("1.5 GiB image", pm))
    for name, p in cases:
        z, c = zero_detect(p), page_checksum(p)
        zr, cr = zero_detect_ref(p), page_checksum_ref(p)
        torch.cuda.synchronize()
        _require_equal(f"zero_detect ({name})", z, zr)
        _require_equal(f"page_checksum ({name})", c, cr)
        err["zero_detect"] = max(err["zero_detect"], max_abs_err([(z, zr)]))
        err["page_checksum"] = max(err["page_checksum"], max_abs_err([(c, cr)]))
        log(f"  zero_detect + page_checksum {name}: n={p.shape[0]} bit-equal")
    f = torch.zeros((5, 1024), dtype=torch.float32, device=device)
    f[1, 3] = -0.0
    f[2, :] = -0.0
    f[3, 5] = float("nan")
    f[4, 1023] = 1.0
    zf = zero_detect(f)
    _require_equal("zero_detect (float32 +-0, NaN)", zf, zero_detect_ref(f))
    if zf.tolist() != [1, 1, 1, 0, 0]:
        raise AssertionError(f"zero_detect float32 value semantics: {zf.tolist()}")
    _require_equal("page_checksum vs fused_publish's column (1.5 GiB image)",
                   page_checksum(pm), fused_csum)
    log("  zero_detect float32 +-0/NaN by value; page_checksum equals fused_publish's column")
    for name, idx in (("hot set", hot_idx), ("cold set", cold_idx),
                      ("N=0", np.zeros(0, np.int64)),
                      ("ragged N=37, permuted, repeated", rng.integers(0, pm.shape[0], 37))):
        got = page_gather(pm, idx)
        want = page_gather_ref(pm, torch.from_numpy(np.asarray(idx, np.int64)).to(device))
        torch.cuda.synchronize()
        _require_equal(f"page_gather ({name})", got, want)
        log(f"  page_gather {name}: m={len(idx)} bit-equal")
    chunk = page_gather(pm, hot_idx[:256])
    for name, m, with_src in (("256-page chunk", 256, False),
                              ("256-page chunk, src perm", 256, True),
                              ("N=0", 0, False), ("ragged N=37", 37, True)):
        dst = np.sort(rng.choice(pm.shape[0], m, replace=False))
        src = rng.permutation(256)[:m] if with_src else None
        compact = chunk if with_src else chunk[:m]
        dest_k = torch.zeros((pm.shape[0], PAGE), dtype=torch.uint8, device=device)
        dest_p = torch.zeros_like(dest_k)
        page_scatter(dest_k, compact, dst, src_indices=src)
        page_scatter_ref(dest_p, compact, torch.from_numpy(dst).to(device),
                         None if src is None else torch.from_numpy(src).to(device))
        torch.cuda.synchronize()
        _require_equal(f"page_scatter ({name})", dest_k, dest_p)
        del dest_k, dest_p
        log(f"  page_scatter {name}: m={m} bit-equal")
    check_far_rows(torch, np, chunk, device)
    return err


def check_far_rows(torch, np, chunk, device) -> None:
    """page_gather and page_scatter on rows whose byte offsets pass 2^31 in a
    3 GiB arena (64-bit offsets), against the plain versions."""
    from repro_torch.kernels import page_gather, page_scatter
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    arena = torch.zeros((ARENA_BYTES // PAGE, PAGE), dtype=torch.uint8, device=device)
    far = np.array([arena.shape[0] - 1, 600_000, 1 << 19, (1 << 19) - 1], np.int64)
    page_scatter(arena, chunk, far, src_indices=np.array([3, 2, 1, 0]))
    far_t = torch.from_numpy(far).to(device)
    got = page_gather(arena, far)
    torch.cuda.synchronize()
    _require_equal("page_gather (rows past 2^31 bytes)", got, page_gather_ref(arena, far_t))
    _require_equal("page_scatter (rows past 2^31 bytes)", got, chunk[[3, 2, 1, 0]])
    if int(zero_detect_ref(arena).sum()) != arena.shape[0] - 4:
        raise AssertionError("page_scatter past 2^31 bytes wrote rows it was not given")
    log(f"  page_gather + page_scatter rows {far.tolist()} of a 3 GiB arena "
        f"(byte offsets up to {int(far.max()) * PAGE}): bit-equal, other rows untouched")


def gather_turns(torch, page_gather, page_gather_ref, pm, idx_t) -> dict:
    """page_gather and ``torch.index_select`` on the same rows, timed in
    turns (kernel, library, library, kernel); ``ms`` and ``library_ms`` are
    the means of each pair."""
    turns = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        fn = ((lambda: page_gather(pm, idx_t)) if name == "kernel"
              else (lambda: torch.index_select(pm, 0, idx_t)))
        turns[name].append(cuda_ms(fn, iters=20))
    return {"ms": sum(turns["kernel"]) / 2, "library_ms": sum(turns["library"]) / 2,
            "turns_ms": turns,
            "plain_ms": cuda_ms(lambda: page_gather_ref(pm, idx_t), iters=5, warmup=1)}


def time_row_kernels(torch, pm, hot_idx, cold_idx, device) -> dict:
    """CUDA-event times of zero_detect, page_checksum and page_gather, their
    plain versions and their library yardsticks at the dedup path's shapes,
    beside their bounds (page_scatter: :func:`time_row_lists`)."""
    from repro_torch.kernels import page_checksum, page_gather, zero_detect
    from repro_torch.kernels.page_checksum.ref import page_checksum_ref
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    n = pm.shape[0]
    out = {}
    lanes = PAGE // 4
    b, by = bound_ms(n * PAGE + 4 * n, 2 * n * lanes)
    out["zero_detect"] = {
        "shape": f"full image, {n} pages", "ms": cuda_ms(lambda: zero_detect(pm), iters=20),
        "plain_ms": cuda_ms(lambda: zero_detect_ref(pm), iters=5, warmup=1),
        "library_ms": cuda_ms(lambda: pm.any(dim=1), iters=10), "library": "Tensor.any(dim=1)",
        "bound_ms": b, "bound_by": by}
    hot_t = torch.from_numpy(hot_idx).to(device)
    cold_t = torch.from_numpy(cold_idx).to(device)
    sizes = {}
    for name, idx_t in (("cold", cold_t), ("hot", hot_t)):
        m = idx_t.shape[0]
        rows = page_gather(pm, idx_t)
        bc, byc = bound_ms(m * PAGE + 4 * m, 2 * m * lanes)
        bg, byg = bound_ms(2 * m * PAGE + 8 * m, 0)
        sizes[name] = {
            "page_checksum": {
                "shape": f"{name} store batch, {m} pages",
                "ms": cuda_ms(lambda: page_checksum(rows), iters=20),
                "plain_ms": cuda_ms(lambda: page_checksum_ref(rows), iters=3, warmup=1),
                "library_ms": None, "library": None, "bound_ms": bc, "bound_by": byc},
            "page_gather": gather_turns(torch, page_gather, page_gather_ref, pm, idx_t) | {
                "shape": f"{name} set of the image, {m} pages",
                "library": "torch.index_select", "bound_ms": bg, "bound_by": byg}}
        del rows
    out["page_checksum"] = sizes["cold"]["page_checksum"]
    out["page_gather"] = sizes["cold"]["page_gather"]
    out["hot_shapes"] = {k: sizes["hot"][k] for k in ("page_checksum", "page_gather")}
    b_img, by_img = bound_ms(n * PAGE + 4 * n, 2 * n * lanes)
    out["page_checksum_full_image"] = {"ms": cuda_ms(lambda: page_checksum(pm), iters=10),
                                       "bound_ms": b_img, "bound_by": by_img}
    torch.cuda.empty_cache()
    for name in ("zero_detect", "page_checksum", "page_gather"):
        r = out[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms ({r['library']})"
        log(f"  {name:13s} {r['ms']:.5f} ms at {r['shape']} (plain {r['plain_ms']:.5f} ms, "
            f"library {lib}, bound {r['bound_ms']:.6f} ms by {r['bound_by']})")
    for name, r in out["hot_shapes"].items():
        log(f"  {name:13s} {r['ms']:.5f} ms at {r['shape']} (plain {r['plain_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.6f} ms)")
    for r in (out["page_gather"], out["hot_shapes"]["page_gather"]):
        log(f"  page_gather   in turns (kernel, index_select, index_select, kernel) at "
            f"{r['shape']}: {r['turns_ms']['kernel'][0]:.5f}, {r['turns_ms']['library'][0]:.5f}, "
            f"{r['turns_ms']['library'][1]:.5f}, {r['turns_ms']['kernel'][1]:.5f} ms")
    r = out["page_checksum_full_image"]
    log(f"  page_checksum {r['ms']:.5f} ms at the full image (bound {r['bound_ms']:.5f} ms)")
    return out


def walk_segments(torch, np, pm, pages: np.ndarray, chunk: int = 0):
    """A restore walk's row list as the serving layer queues it: the walk's
    pages gathered once (the extents' buffers), one segment an extent —
    ``chunk``-page chunks (the private hot walk) or the guest runs (the cold
    walk) — each a view at its own address.  Returns (segments, buffers)."""
    from repro_torch.kernels import page_gather

    buf = page_gather(pm, pages)
    if chunk:
        cuts = list(range(chunk, pages.size, chunk))
    else:
        cuts = (np.flatnonzero(np.diff(pages) != 1) + 1).tolist()
    bounds = [0, *cuts, int(pages.size)]
    segs = [(buf[a:b], None, pages[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    return segs, buf


def check_row_lists(torch, np, pm, table, walks) -> int:
    """Both row-list kernels against their plain versions at the private
    walks' shapes, bit for bit: verified installs, verify-only launches,
    forced mismatches named exactly, and the row scatter."""
    from repro_torch.kernels import ChecksumMismatchError, fused_restore_rows, page_scatter_rows
    from repro_torch.kernels.page_scatter.ref import page_scatter_rows_ref
    from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref

    err = 0
    for name, (segs, _buf) in walks.items():
        dst = np.concatenate([d for _t, _r, d in segs])
        dst_t = torch.from_numpy(dst).to(pm.device)
        dest_p = torch.zeros_like(pm)
        cs_p = fused_restore_rows_ref(dest_p, segs)
        if not torch.equal(cs_p, table[dst_t]):
            raise AssertionError(f"plain checksums of the {name} walk differ from the publish")
        bad = dst[[0, dst.size // 2, dst.size - 1]]
        dest_k = torch.zeros_like(pm)
        cs = fused_restore_rows(dest_k, segs, expected_table=table)
        cs_v = fused_restore_rows(None, segs, expected_table=table, verify_only=True)
        torch.cuda.synchronize()
        _require_equal(f"fused_restore_rows ({name} walk)", dest_k, dest_p)
        _require_equal(f"fused_restore_rows csum ({name} walk)", cs, cs_p)
        _require_equal(f"fused_restore_rows verify-only ({name} walk)", cs_v, cs_p)
        err = max(err, max_abs_err([(cs, cs_p), (cs_v, cs_p)]))
        table[torch.from_numpy(bad).to(pm.device)] ^= 1
        try:
            for verify_only in (True, False):
                try:
                    fused_restore_rows(dest_k, segs, expected_table=table,
                                       verify_only=verify_only)
                except ChecksumMismatchError as e:
                    if sorted(e.bad_pages.tolist()) != sorted(bad.tolist()):
                        raise AssertionError(f"mismatch names {e.bad_pages}, want {bad}")
                else:
                    raise AssertionError("a forced checksum mismatch did not raise")
        finally:
            table[torch.from_numpy(bad).to(pm.device)] ^= 1
        dest_k.zero_()
        page_scatter_rows(dest_k, segs)
        want = page_scatter_rows_ref(torch.zeros_like(pm), segs)
        torch.cuda.synchronize()
        _require_equal(f"page_scatter_rows ({name} walk)", dest_k, want)
        del dest_k, want, dest_p
        log(f"  row lists, {name} walk ({dst.size} rows, {len(segs)} segments): "
            "fused_restore_rows installed + verify-only bit-equal, 3 forced mismatches "
            "named, page_scatter_rows bit-equal")
    torch.cuda.empty_cache()
    return err


def _turns(order, fns, iters):
    """CUDA-event ms of each named function, called in ``order``."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(cuda_ms(fns[name], iters=iters))
    return out


def time_row_lists(torch, np, pm, table, walks, cold_idx, device) -> dict:
    """At the private walks' shapes, device times of one launch of each
    row-list kernel on a device-resident row list, beside the bound, the
    plain version and the wrapper's whole flush (address build, one pinned
    upload, launch, the verify read-back).  Then the store-write form of
    page_scatter (one compact tensor of the cold set, device-resident
    indices into a 3 GiB arena), in turns with ``Tensor.index_copy_``."""
    from repro_torch import kernels
    from repro_torch.kernels import page_gather, rows
    from repro_torch.kernels.page_scatter import kernel as skernel
    from repro_torch.kernels.page_scatter.ref import page_scatter_ref, page_scatter_rows_ref
    from repro_torch.kernels.snapshot_fuse import kernel as rkernel
    from repro_torch.kernels.snapshot_fuse.ops import _weights
    from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref

    weights = _weights(device)
    out = {}
    for name, (segs, _buf) in walks.items():
        dst = np.concatenate([d for _t, _r, d in segs])
        m = dst.size
        _segs, _dst, addr = rows.check_segments(name, segs, PAGE, pm.shape[0])
        idx = rows.upload([addr, dst], device)
        dest = torch.zeros_like(pm)
        csum = torch.empty(m, dtype=torch.int32, device=device)
        bad = torch.empty(m, dtype=torch.uint8, device=device)
        n_bad = torch.empty(1, dtype=torch.int32, device=device)
        fns = {
            "install": lambda: rkernel.restore_rows(dest, 0, 1, idx[0], idx[1], weights, table,
                                                    csum, bad, n_bad),
            "verify_only": lambda: rkernel.restore_rows(None, 0, 1, idx[0], idx[1], weights,
                                                        table, csum, bad, n_bad),
            "scatter": lambda: skernel.scatter_rows(dest, 0, 1, idx[0], idx[1])}
        row = {"rows": m, "segments": len(segs)}
        for op, nbytes in (("install", m * (2 * PAGE + 16 + 4 + 4 + 1) + 4),
                           ("verify_only", m * (PAGE + 16 + 4 + 4 + 1) + 4),
                           ("scatter", m * (2 * PAGE + 16))):
            b, by = bound_ms(nbytes, 3 * m * (PAGE // 4) if op != "scatter" else 0)
            row[op] = {"ms": cuda_ms(fns[op], iters=20), "bound_ms": b, "bound_by": by}
            torch.cuda.synchronize()
            if op != "scatter" and (int(n_bad.item()) != 0 or not torch.equal(
                    csum, table[idx[1]])):
                raise AssertionError(f"timed {op} launches disagree with the checksum table")
        if not torch.equal(page_gather(dest, idx[1]), page_gather(pm, idx[1])):
            raise AssertionError(f"timed row-list launches left wrong rows ({name} walk)")
        row["flush_wrapper_ms"] = cuda_ms(lambda: kernels.fused_restore_rows(
            dest, segs, expected_table=table), iters=5, warmup=1)
        row["scatter_wrapper_ms"] = cuda_ms(lambda: kernels.page_scatter_rows(dest, segs),
                                            iters=5, warmup=1)
        row["plain_ms"] = cuda_ms(lambda: fused_restore_rows_ref(dest, segs), iters=1, warmup=1)
        row["scatter_plain_ms"] = cuda_ms(lambda: page_scatter_rows_ref(dest, segs), iters=1,
                                          warmup=1)
        out[name] = row
        del dest, idx
        for op in ("install", "verify_only", "scatter"):
            r = row[op]
            log(f"  row list {name} walk ({m} rows, {len(segs)} segments) {op}: "
                f"{r['ms']:.5f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
        log(f"  row list {name} walk: wrapper flush {row['flush_wrapper_ms']:.4f} ms verified, "
            f"{row['scatter_wrapper_ms']:.4f} ms scatter; plain {row['plain_ms']:.3f} / "
            f"{row['scatter_plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    # the store write: one compact tensor, device-resident destination rows
    cold_t = torch.from_numpy(cold_idx).to(device)
    compact = page_gather(pm, cold_t)
    del cold_t
    arena = torch.zeros((ARENA_BYTES // PAGE, PAGE), dtype=torch.uint8, device=device)
    at = torch.arange(compact.shape[0], device=device) * 5 % arena.shape[0]
    m = compact.shape[0]
    fns = {"kernel": lambda: skernel.scatter_rows(arena, compact.data_ptr(), PAGE, None, at),
           "library": lambda: arena.index_copy_(0, at, compact)}
    turns = _turns(("kernel", "library", "library", "kernel"), fns, iters=10)
    b, by = bound_ms(2 * m * PAGE + 8 * m, 0)
    wrapper_ms = cuda_ms(lambda: kernels.page_scatter(arena, compact, at), iters=10)
    plain_ms = cuda_ms(lambda: page_scatter_ref(arena, compact, at), iters=3, warmup=1)
    torch.cuda.synchronize()
    if not torch.equal(page_gather(arena, at), compact):
        raise AssertionError("timed store writes left the wrong rows")
    out["store_write"] = {
        "shape": f"cold store write, {m} pages from one tensor into a 3 GiB arena",
        "rows": m, "turns_ms": turns, "ms": {k: sum(t) / 2 for k, t in turns.items()},
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library": "Tensor.index_copy_",
        "bound_ms": b, "bound_by": by}
    del arena, compact, at
    torch.cuda.empty_cache()
    r = out["store_write"]
    log(f"  page_scatter  store write ({m} rows), in turns kernel, library, library, kernel: "
        + ", ".join(f"{k} {r['ms'][k]:.5f} ms {turns[k]}" for k in turns)
        + f"; wrapper {wrapper_ms:.5f} ms; plain {plain_ms:.5f} ms; bound {b:.5f} ms")
    return out


class PerExtentScatter:
    """A scatter without a batched form, so every bulk walk runs per extent
    (the route before batched walks, kept to time against them): it wraps a
    ``FusedScatter`` (verified once bound) or ``page_scatter``."""

    def __init__(self, inner=None):
        from repro_torch.kernels import FusedScatter

        self.inner = FusedScatter() if inner is None else inner
        self.stats = getattr(self.inner, "stats", None)

    def bind_checksums(self, table) -> "PerExtentScatter":
        return PerExtentScatter(self.inner.bind_checksums(table))

    def __call__(self, *args, **kwargs):
        return self.inner(*args, **kwargs)


def check_routes(where: str, routes: dict, per_extent: str = "", walks: int = 2) -> None:
    """Every one of the ``walks`` walks with rows took the batched route
    (``per_extent`` given: every walk stayed per extent for that reason)."""
    total = routes["batched"] + sum(routes["per_extent"].values())
    want = ({"batched": total, "per_extent": dict.fromkeys(routes["per_extent"], 0)}
            if not per_extent else
            {"batched": 0, "per_extent": {k: (total if k == per_extent else 0)
                                          for k in routes["per_extent"]}})
    if routes != want or total != walks:
        raise AssertionError(f"{where}: walk routes {routes}, want {want} over {walks} walks")


def restore_once(torch, pool, regions, src_buf, manifest, scatter) -> dict:
    """One restore (pre-install, then install everything) of a published
    snapshot through ``RestoreEngine`` on a fresh host view and instance,
    compared with its source; wall time and the walks' routes."""
    from repro_torch import core

    ledger = core.TimeLedger()
    reader = core.SnapshotReader(regions, pool.host_view(f"turn-{time.perf_counter_ns()}",
                                                         ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = core.Instance(core.StateImage.empty_like(manifest, device=src_buf.device), ledger)
    eng = core.RestoreEngine(reader, inst, scatter_fn=scatter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.pre_install_hot()
    eng.install_all_sync()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.equal(inst.image.buf, src_buf):
        raise AssertionError(f"restore of {regions.name} differs from its source")
    stats = getattr(inst.scatter_fn, "stats", None)
    verified = None if stats is None else stats["pages_verified"]
    if (verified is not None and reader.page_checksums() is not None
            and verified != regions.n_hot + regions.n_cold):
        raise AssertionError(f"{regions.name}: {verified} pages verified")
    return {"restore_s": wall, "walk_routes": eng.walk_routes, "pages_verified": verified,
            "modeled_ledger_s": dict(ledger.seconds), "modeled_total_s": ledger.total()}


def route_turns(torch, where: str, restore, batched_scatter, per_extent_scatter) -> dict:
    """Restore walls of one snapshot on the batched and the per-extent route,
    in turns (batched, per-extent, per-extent, batched), routes asserted."""
    out = {"batched": [], "per_extent": []}
    for route in ("batched", "per_extent", "per_extent", "batched"):
        r = restore(batched_scatter() if route == "batched" else per_extent_scatter())
        check_routes(f"{where} ({route})", r["walk_routes"],
                     "" if route == "batched" else "scatter_fn")
        out[route].append(r["restore_s"])
    log(f"  {where} restore in turns (batched, per-extent, per-extent, batched): batched "
        f"{', '.join(f'{t * 1e3:.2f}' for t in out['batched'])} ms, per-extent "
        f"{', '.join(f'{t * 1e3:.2f}' for t in out['per_extent'])} ms wall; bit-identical")
    return out


def make_variant(torch, base: "torch.Tensor", hot_t, cold_t, d: int, v: int, seed: int):
    """Variant ``v`` of the fleet: the base image with its hot pages at ranks
    [v*d, (v+1)*d) and all its cold pages drawn anew from ``(seed, v)``."""
    g = torch.Generator(device=base.device)
    g.manual_seed(seed * 1_000_003 + 7919 * (v + 1))
    buf = base.clone()
    rows = torch.cat([hot_t[v * d : (v + 1) * d], cold_t])
    buf.view(-1, PAGE)[rows] = torch.randint(0, 256, (rows.numel(), PAGE), dtype=torch.uint8,
                                             generator=g, device=base.device)
    return buf


def i6_holds(np, core, pool, all_regions) -> bool:
    """Store refcounts == live offset-array slots pointing at them, per tier."""
    for store, tag in ((pool.dedup_cxl, core.TIER_CXL), (pool.dedup_rdma, core.TIER_RDMA)):
        want = {}
        for r in all_regions:
            uniq, counts = np.unique(core.decode_dedup_offsets(pool, r, tag), return_counts=True)
            for off, k in zip(uniq.tolist(), counts.tolist()):
                want[off] = want.get(off, 0) + k
        if want != store.refcounts():
            return False
    return True


def dedup_phase(torch, np, base_buf, working_set, cold_idx, manifest, seed, out_dir) -> dict:
    """Publish, restore, check and free the four-variant fleet (see the
    module docstring); returns the phase's numbers."""
    from repro_torch import core
    from repro_torch.kernels import (FusedScatter, fused_publish, fused_restore,
                                     make_fused_publish_fn, page_checksum, page_gather,
                                     page_scatter, zero_detect)

    device = base_buf.device
    n_hot, n_cold = int(working_set.size), int(cold_idx.size)
    d = round(n_hot * 12 / 256)
    hot_t = torch.from_numpy(working_set).to(device)
    cold_t = torch.from_numpy(cold_idx).to(device)
    t0 = time.perf_counter()
    variants = [make_variant(torch, base_buf, hot_t, cold_t, d, v, seed)
                for v in range(N_VARIANTS)]
    torch.cuda.synchronize()
    rep = {"n_variants": N_VARIANTS, "n_hot": n_hot, "n_cold": n_cold, "delta_pages": d,
           "make_s": time.perf_counter() - t0, "publishes": [], "restores": []}
    counted = {"zero_detect": zero_detect, "page_checksum": page_checksum,
               "page_gather": page_gather, "page_scatter": page_scatter,
               "fused_publish": fused_publish, "fused_restore": fused_restore}
    for k in counted.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = core.HierarchicalPool(device=device, rdma_capacity=ARENA_BYTES,
                                 dedup_hash_fn=core.poly32_hash_fn)
    stores = (pool.dedup_cxl, pool.dedup_rdma)
    regions = []
    for v, buf in enumerate(variants):
        image = core.StateImage(manifest, buf)
        kw = {} if v < 2 else {"publish_fn": make_fused_publish_fn()}
        est = (core.estimate_snapshot_cxl_size(image, working_set, dedup=True, pool=pool)
               if v == 3 else None)
        before = [(s.stats["unique"], s.stats["dedup_hits"], s.decide_s) for s in stores]
        cxl_before = pool.cxl.bytes_in_use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regions.append(core.build_snapshot(pool, image, working_set, f"v{v}", version=v,
                                           dedup=True, **kw))
        torch.cuda.synchronize()
        row = {"variant": v, "route": "kernels" if v < 2 else "fused",
               "publish_s": time.perf_counter() - t0,
               "cxl_bytes_added": pool.cxl.bytes_in_use - cxl_before, "cxl_estimate": est}
        for (u0, h0, s0), s, tier in zip(before, stores, ("cxl", "rdma")):
            row[f"{tier}_new"] = s.stats["unique"] - u0
            row[f"{tier}_hits"] = s.stats["dedup_hits"] - h0
            row[f"{tier}_decide_s"] = s.decide_s - s0
        rep["publishes"].append(row)
        if est is not None and est != row["cxl_bytes_added"]:
            raise AssertionError(f"estimate {est} != CXL bytes the publish added "
                                 f"{row['cxl_bytes_added']}")
        if v >= 2 and row["cxl_hits"] != n_hot - d:
            raise AssertionError(f"variant {v}: {row['cxl_hits']} hot hits on stored base "
                                 f"pages, want {n_hot - d}")
        log(f"  publish v{v} ({row['route']}): {row['publish_s'] * 1e3:.2f} ms wall; new "
            f"cxl {row['cxl_new']} rdma {row['rdma_new']}, hits cxl {row['cxl_hits']} "
            f"rdma {row['rdma_hits']}; host decision {row['cxl_decide_s'] * 1e3:.2f} + "
            f"{row['rdma_decide_s'] * 1e3:.2f} ms")
    want_scatter = 2 * N_VARIANTS      # one store write per put_pages with new rows
    want_restore = 0
    for v, (reg, buf) in enumerate(zip(regions, variants)):
        scatter = None if v < 2 else FusedScatter()
        row = restore_once(torch, pool, reg, buf, manifest, scatter)
        row["variant"] = v
        rep["restores"].append(row)
        check_routes(f"dedup v{v}", row["walk_routes"])
        walks = row["walk_routes"]["batched"]
        if v < 2:
            want_scatter += walks          # one install a walk
        else:
            want_restore += 2 * walks      # a verify-only launch and an install a walk
        log(f"  restore v{v} ({'page_scatter' if v < 2 else 'fused, verified'}): "
            f"{row['restore_s'] * 1e3:.2f} ms wall, {walks} batched walks, bit-identical; "
            f"modeled {row['modeled_total_s'] * 1e3:.4f} ms")
    t0 = time.perf_counter()
    back = core.reconstruct_image(pool, regions[3])
    torch.cuda.synchronize()
    rep["reconstruct_s"] = time.perf_counter() - t0
    if not torch.equal(back.buf, variants[3]):
        raise AssertionError("reconstruct_image of v3 differs from its source")
    del back
    want_scatter += 2
    launches = {name: k.launches for name, k in counted.items()}
    rep["launches"] = launches
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    want = {"zero_detect": 3, "page_checksum": 5, "page_gather": 7, "page_scatter": want_scatter,
            "fused_publish": 2, "fused_restore": want_restore}
    rep["expected_launches"] = want
    if launches != want:
        raise AssertionError(f"dedup launch counts {launches}, want {want}")
    cxl, rdma = pool.dedup_cxl, pool.dedup_rdma
    rep["stores"] = {"cxl": cxl.report(), "rdma": rdma.report()}
    checks = {"cxl unique": (cxl.stats["unique"], n_hot + N_VARIANTS * d),
              "rdma unique": (rdma.stats["unique"], N_VARIANTS * n_cold),
              "cxl hits": (cxl.stats["dedup_hits"], N_VARIANTS * n_hot - cxl.stats["unique"]),
              "rdma hits": (rdma.stats["dedup_hits"], N_VARIANTS * n_cold - rdma.stats["unique"]),
              "cxl logical": (cxl.logical_pages(), N_VARIANTS * n_hot),
              "rdma logical": (rdma.logical_pages(), N_VARIANTS * n_cold)}
    for name, (got, exp) in checks.items():
        if got != exp:
            raise AssertionError(f"dedup {name}: {got}, want {exp}")
    if not i6_holds(np, core, pool, regions):
        raise AssertionError("I6: store refcounts differ from the live offset arrays")
    rep["collisions"] = {"cxl": cxl.stats["collisions"], "rdma": rdma.stats["collisions"]}
    log(f"  stores: cxl unique {cxl.stats['unique']} (= n_hot + 4d) hits "
        f"{cxl.stats['dedup_hits']}; rdma unique {rdma.stats['unique']} (= 4 n_cold) hits "
        f"{rdma.stats['dedup_hits']}; collisions cxl {cxl.stats['collisions']} rdma "
        f"{rdma.stats['collisions']}; I6 holds; reconstruct v3 "
        f"{rep['reconstruct_s'] * 1e3:.2f} ms, bit-identical")
    log(f"  launches {launches} as the fleet's shape implies; peak device memory "
        f"{rep['peak_mem_bytes'] / 2**30:.3f} GiB")

    def per_extent_page_scatter(*args, **kwargs):      # page_scatter, no batched form
        return page_scatter(*args, **kwargs)

    rep["routes_in_turns"] = {
        f"v{v}": route_turns(
            torch, f"dedup v{v} ({label})",
            lambda scatter, v=v: restore_once(torch, pool, regions[v], variants[v], manifest,
                                              scatter),
            batched, per_extent)
        for v, label, batched, per_extent in (
            (0, "page_scatter", lambda: None, lambda: per_extent_page_scatter),
            (2, "fused, verified", FusedScatter, PerExtentScatter))}
    rep["profile"] = profile_dedup(torch, core, pool, base_buf, hot_t, cold_t, d, seed,
                                   working_set, manifest, out_dir)
    t0 = time.perf_counter()
    for reg in regions:
        core.free_snapshot(pool, reg)
    rep["free_s"] = time.perf_counter() - t0
    if (cxl.unique_pages() or rdma.unique_pages() or pool.cxl.bytes_in_use
            or pool.rdma.bytes_in_use):
        raise AssertionError("freeing the fleet left pages in the stores")
    log(f"  freed the fleet in {rep['free_s'] * 1e3:.2f} ms: both stores empty, "
        "both tiers' bytes_in_use 0")
    return rep


def profile_dedup(torch, core, pool, base_buf, hot_t, cold_t, d, seed, working_set, manifest,
                  out_dir) -> dict:
    """One more variant published (kernel route) and restored on the batched
    and on the per-extent route under torch.profiler while the fleet is
    stored; freed afterwards."""
    from torch.profiler import ProfilerActivity, profile

    buf = make_variant(torch, base_buf, hot_t, cold_t, d, N_VARIANTS, seed)
    image = core.StateImage(manifest, buf)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        reg = core.build_snapshot(pool, image, working_set, "profiled", dedup=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["publish"] = _device_summary(torch, prof, wall)
    (out_dir / "profile_dedup_publish.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    from repro_torch.kernels import page_scatter

    def per_extent_page_scatter(*args, **kwargs):      # page_scatter, no batched form
        return page_scatter(*args, **kwargs)

    for key, scatter in (("restore", None), ("restore_per_extent", per_extent_page_scatter)):
        ledger = core.TimeLedger()
        reader = core.SnapshotReader(reg, pool.host_view(f"host-profiled-{key}", ledger),
                                     pool.rdma)
        reader.invalidate_cxl()
        inst = core.Instance(core.StateImage.empty_like(manifest, device=buf.device), ledger)
        eng = core.RestoreEngine(reader, inst, scatter_fn=scatter)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.pre_install_hot()
            eng.install_all_sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[key] = _device_summary(torch, prof, wall)
        out[key]["walk_routes"] = eng.walk_routes
        check_routes(f"profiled dedup {key}", eng.walk_routes,
                     "" if key == "restore" else "scatter_fn")
        (out_dir / f"profile_dedup_{key}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
        if not torch.equal(inst.image.buf, buf):
            raise AssertionError(f"profiled dedup {key} differs from its source")
        del inst, eng, reader
    core.free_snapshot(pool, reg)
    for phase, row in out.items():
        log(f"  profile dedup {phase}: wall {row['wall_ms']:.2f} ms under the profiler, "
            f"device busy {row['device_busy_ms']:.3f} ms, idle share "
            f"{row['device_idle_share']:.4f}")
        for r in row["top"][:4]:
            log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return out


def _guest(engine, trace, lat: list) -> None:
    """The guest thread: touch ``trace`` through ``engine.access``; the
    service time of every page absent at its touch goes to ``lat``."""
    present = engine.instance.present
    for p in trace.tolist():
        if present[p]:
            engine.access(p)
            continue
        t0 = time.perf_counter()
        engine.access(p, timeout_s=120.0)
        lat.append(time.perf_counter() - t0)


def _pod_restores(np, ops, orch_a, orch_b, name: str, seed: int, on_borrowed=None):
    """Restore ``name`` ``POD_SESSIONS`` times on host a through its node
    server: every session attaches first (one fan-out group), then each
    session's own thread pre-installs the hot set, installs the zero runs,
    starts the prefetcher, runs its guest trace and waits for the last cold
    page.  With ``orch_b``, one more restore through host b's plain entry
    point runs beside them in a thread of its own, and ``on_borrowed`` runs
    once all the borrows are out.  Every restore gets its own FusedScatter,
    so its verified pages are its own.  Returns ``(restored, records)``."""
    import threading

    ris, recs, errs = [], [], []
    for _ in range(POD_SESSIONS):
        orch_a.scatter_fn = ops.FusedScatter()
        t0 = time.perf_counter()
        ri = orch_a.restore(name, pre_install=False, prefetch_cold=False)
        if ri is None:
            raise AssertionError(f"host a: the borrow of {name} failed")
        ris.append(ri)
        recs.append({"host": "a", "attach_s": time.perf_counter() - t0, "fault_s": [],
                     "scatter": ri.instance.scatter_fn.stats})

    def trace(ri, k):
        cold = ri.engine.reader.cold_page_indices()
        return np.random.default_rng(seed + k).permutation(cold)[:POD_TOUCHES]

    def finish(ri, rec, k, t0):
        ri.engine.install_zero_runs()
        if rec["host"] == "a":                # host b's restore() started its prefetcher
            ri.engine.start_prefetcher()
        _guest(ri.engine, trace(ri, k), rec["fault_s"])
        if not ri.engine.wait_prefetch_idle(300.0):
            raise AssertionError(f"{rec['host']}: cold pages still absent after 300 s")
        if not ri.instance.all_present():
            raise AssertionError(f"{rec['host']}: pages absent after the restore")
        rec["to_full_s"] = rec.get("attach_s", 0.0) + time.perf_counter() - t0

    def run_a(k):
        ri, rec = ris[k], recs[k]
        try:
            t0 = time.perf_counter()
            ri.engine.pre_install_hot()
            rec["to_hot_s"] = rec["attach_s"] + time.perf_counter() - t0
            finish(ri, rec, k, t0)
        except BaseException as e:           # re-raised by the main thread
            errs.append(e)

    b_in = threading.Event()

    def run_b():
        try:
            orch_b.scatter_fn = ops.FusedScatter()
            t0 = time.perf_counter()
            ri = orch_b.restore(name)         # borrow, flush, pre-install, prefetch
            if ri is None:
                raise AssertionError(f"host b: the borrow of {name} failed")
            rec = {"host": "b", "to_hot_s": time.perf_counter() - t0, "fault_s": [],
                   "scatter": ri.instance.scatter_fn.stats}
            ris.append(ri)
            recs.append(rec)
            b_in.set()
            finish(ri, rec, POD_SESSIONS, t0)
        except BaseException as e:
            errs.append(e)
        finally:
            b_in.set()

    # daemon threads: a failed run exits at once, never waiting on a restore
    threads = [threading.Thread(target=run_a, args=(k,), daemon=True)
               for k in range(POD_SESSIONS)]
    if orch_b is not None:
        threads.append(threading.Thread(target=run_b, daemon=True))
    for t in threads:
        t.start()
    if orch_b is not None:
        b_in.wait(timeout=300.0)
        if on_borrowed is not None and not errs:
            on_borrowed()
    for t in threads:
        t.join(timeout=600.0)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a restore thread did not finish within 600 s")
    return ris, recs


def _pct(np, xs, q):
    return float(np.percentile(xs, q)) * 1e3 if len(xs) else None


def pod_phase(torch, np, image, working_set, cold_idx, seed: int, out_dir: Path) -> dict:
    """The pod's control plane at the paper's instance size (see the module
    docstring): PoolMaster.publish, 8 + 1 co-located demand-paged restores
    through Orchestrator with a profiled window once their borrows are out,
    an update that drains under them, the update restored as version 1,
    delete and gc."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as kmod
    from repro_torch.core import (STATE_TOMBSTONE, HierarchicalPool, NodePageServer,
                                  Orchestrator, PoolMaster, RestoreEngine, StateImage)
    from repro_torch.kernels.snapshot_fuse import ops

    device = image.buf.device
    name = "inst"
    g = torch.Generator(device=device)
    g.manual_seed(seed + 17)
    nonzero = torch.from_numpy(np.concatenate([working_set, cold_idx])).to(device)
    delta = nonzero[torch.randperm(nonzero.numel(), generator=g, device=device)[:POD_DELTA]]
    image2 = StateImage(image.manifest, image.buf.clone())
    image2.pages_matrix()[delta] = torch.randint(1, 256, (delta.numel(), PAGE),
                                                 dtype=torch.uint8, generator=g, device=device)
    counted = {"fused_publish": ops.fused_publish, "fused_restore": ops.fused_restore,
               **{n: getattr(kmod, n) for n in ROW_KERNELS}}
    threads_before = set(threading.enumerate())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counted.values():
        k.launches = 0
    t_phase = time.perf_counter()

    pool = HierarchicalPool(device=device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    master = PoolMaster(pool, publish_fn=ops.make_fused_publish_fn())
    t0 = time.perf_counter()
    v0 = master.publish(name, image, working_set)
    torch.cuda.synchronize()
    rep = {"publish_s": time.perf_counter() - t0, "n_hot": v0.n_hot, "n_cold": v0.n_cold,
           "n_zero": v0.n_zero, "sessions": POD_SESSIONS, "touches": POD_TOUCHES,
           "delta_pages": POD_DELTA}
    server_a = NodePageServer("a", pool)
    orch_a = Orchestrator("a", pool, master.catalog, node_server=server_a)
    orch_b = Orchestrator("b", pool, master.catalog, prefetch_cold=True)
    entry = master.catalog.find(name)
    in_use0 = (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use)
    upd = {}

    def update():
        """The owner's update through ``publish_steps``, polling the entry's
        refcount once a millisecond while it drains.  A pod's master runs on
        a host of its own; in this one process, ``publish``'s 10 µs poll
        would take the interpreter lock from the restores thousands of times
        a second."""
        try:
            for label, value in master.publish_steps(name, image2, working_set):
                upd["label"] = label
                if label == "draining":
                    upd["polls"] = upd.get("polls", 0) + 1
                    time.sleep(1e-3)
                elif label == "done":
                    upd["regions"] = value
        except BaseException as e:           # re-raised by the main thread
            upd["error"] = e

    updater = threading.Thread(target=update, daemon=True)

    def on_borrowed():
        """All nine borrows are out: start the update, and profile a window
        of the restores (the profiler traces every thread's launches)."""
        updater.start()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(POD_PROFILE_S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep["profile_window"] = _device_summary(torch, prof, wall)
        (out_dir / "profile_pod_window.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))

    # 1. the measured run: 8 sessions on host a, one on host b, the update
    # started once all nine borrows are out
    t0 = time.perf_counter()
    ris, recs = _pod_restores(np, ops, orch_a, orch_b, name, seed, on_borrowed=on_borrowed)
    torch.cuda.synchronize()
    rep["restores_wall_s"] = time.perf_counter() - t0
    chunks_a, server_stats_a = dict(server_a.chunks.stats), dict(server_a.stats)
    srv_b = orch_b._owned_server
    for ri in ris:
        if not torch.equal(ri.instance.image.buf, image.buf):
            raise AssertionError(f"pod: a restore on host {ri.engine.reader.view.host} "
                                 "differs from the published image")
        verified = ri.instance.scatter_fn.stats["pages_verified"]
        if verified != v0.n_hot + v0.n_cold:
            raise AssertionError(f"pod: {verified} pages verified, want {v0.n_hot + v0.n_cold}")
        check_routes("pod restore", ri.engine.walk_routes, walks=1)
    n_chunks = -(-v0.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
    if (chunks_a["reads"], chunks_a["fanout_hits"]) != (n_chunks, (POD_SESSIONS - 1) * n_chunks):
        raise AssertionError(f"pod: group a chunk stats {chunks_a}, want {n_chunks} reads and "
                             f"{(POD_SESSIONS - 1) * n_chunks} fan-out hits")
    if server_stats_a["fanout_installs"] <= 0:
        raise AssertionError(f"pod: no fan-out install on host a: {server_stats_a}")

    # 2. the update drains until the last borrow goes
    def draining() -> bool:
        return (updater.is_alive() and upd.get("label") == "draining"
                and entry.state.load() == STATE_TOMBSTONE and entry.regions is v0
                and (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use) == in_use0)

    ledger_a, ledger_b = dict(ris[0].ledger.seconds), dict(ris[-1].ledger.seconds)
    drained_checks = 0
    for ri in ris:
        if not draining():
            raise AssertionError(f"pod: the update is not draining with {ri.borrow.entry.refcount.load()}"
                                 f" borrows out ({upd})")
        drained_checks += 1
        ri.shutdown()
    updater.join(timeout=120.0)
    if updater.is_alive() or "regions" not in upd:
        raise AssertionError(f"pod: the update did not finish after the last release: {upd}")
    v1 = upd["regions"]
    if v1.version != 1:
        raise AssertionError(f"pod: the update published version {v1.version}, want 1")
    del ris
    # host b restores the new version: borrow, clflushopt, walks
    orch_b.scatter_fn = ops.FusedScatter()
    ri = orch_b.restore(name, prefetch_cold=False)
    ri.engine.install_all_sync()
    torch.cuda.synchronize()
    if ri.borrow.version != 1 or not torch.equal(ri.instance.image.buf, image2.buf):
        raise AssertionError("pod: the restore of version 1 differs from the updated image")
    if ri.instance.scatter_fn.stats["pages_verified"] != v1.n_hot + v1.n_cold:
        raise AssertionError("pod: not every page of version 1 was verified")
    check_routes("pod version-1 restore", ri.engine.walk_routes)
    b2 = {"scatter": ri.instance.scatter_fn.stats, "walks": ri.engine.walk_routes["batched"],
          "cold_extents": sum(1 for _ in ri.engine.reader.iter_cold_extents(
              max_extent_pages=1 << 30, largest_first=False))}
    ri.shutdown()
    del ri
    launches = {n: k.launches for n, k in counted.items()}
    if launches["fused_publish"] != 2:
        raise AssertionError(f"pod: fused_publish launched {launches['fused_publish']} times, "
                             "want 2 (the publish and the update)")
    # every fused_restore launch accounted: a direct install a batch not
    # queued, and a verify-only launch and an install a batched walk
    queued = len(recs) * n_chunks + (-(-v1.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
                                     + b2["cold_extents"])
    batches = sum(r["scatter"]["batches"] for r in recs) + b2["scatter"]["batches"]
    walks = len(recs) + b2["walks"]
    want_restore = batches - queued + 2 * walks
    if launches["fused_restore"] != want_restore:
        raise AssertionError(f"pod: fused_restore launched {launches['fused_restore']} times, "
                             f"want {want_restore}")
    others = {n: c for n, c in launches.items() if n in ROW_KERNELS and c}
    if others:
        raise AssertionError(f"pod: launches of kernels off the pod's path: {others}")
    rep["launches"] = launches
    rep["launch_parts"] = {"direct_installs": batches - queued, "batched_walks": walks}
    rep["wall_to_update_s"] = time.perf_counter() - t_phase

    # 3. delete and gc: every byte back, servers parked, no thread left
    if not master.delete(name) or master.gc() != 0:
        raise AssertionError("pod: delete did not reclaim the snapshot at once")
    if (pool.cxl.free_list(), pool.rdma.free_list()) != free0 or pool.cxl.bytes_in_use \
            or pool.rdma.bytes_in_use:
        raise AssertionError(f"pod: pool not back to its start: cxl {pool.cxl.free_list()} "
                             f"rdma {pool.rdma.free_list()}")
    for srv in (server_a, srv_b):
        if srv._pump_thread is not None or srv._completion_thread is not None \
                or srv.engine._worker.is_alive() or srv.buffers.outstanding:
            raise AssertionError(f"pod: node server {srv.host} not parked "
                                 f"(outstanding buffers {srv.buffers.outstanding})")
    orch_a.close()
    orch_b.close()
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"pod: threads left after the phase: {left}")
    torch.cuda.synchronize()
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

    faults = [x for r in recs for x in r["fault_s"]]
    rep["instances"] = [{k: v for k, v in r.items() if k not in ("fault_s", "scatter")}
                        | {"faults": len(r["fault_s"])} for r in recs]
    rep["fault_ms"] = {"n": len(faults), "p50": _pct(np, faults, 50), "p99": _pct(np, faults, 99),
                       "max": max(faults) * 1e3 if faults else None}
    rep["chunks_a"], rep["server_a"] = chunks_a, server_stats_a
    rep["server_b"] = dict(srv_b.stats)
    rep["longest_install_ms"] = {"a": server_a.longest_install_s * 1e3,
                                 "b": srv_b.longest_install_s * 1e3}
    rep["install_share"] = {"a": server_a.install_s / rep["restores_wall_s"],
                            "b": srv_b.install_s / rep["restores_wall_s"]}
    rep["engines"] = {"a": dict(server_a.engine.stats), "b": dict(srv_b.engine.stats)}
    rep["drain_checks"], rep["drain_polls"] = drained_checks, upd["polls"]
    rep["modeled_ledger_s"] = {"a0": ledger_a, "b": ledger_b}
    rep["modeled_total_s"] = {"a0": sum(ledger_a.values()), "b": sum(ledger_b.values())}
    return rep


def log_pod(rep: dict, card: str) -> None:
    ms = {k: v * 1e3 for k, v in rep.items() if k.endswith("_s") and isinstance(v, float)}
    log(f"  [{card}] publish {ms['publish_s']:.2f} ms; n_hot={rep['n_hot']} "
        f"n_cold={rep['n_cold']} n_zero={rep['n_zero']}; {rep['sessions']} + 1 restores "
        f"{ms['restores_wall_s']:.1f} ms wall; phase {ms['phase_wall_s']:.1f} ms wall")
    for i, r in enumerate(rep["instances"]):
        log(f"  [{card}] instance {i} host {r['host']}: time to hot "
            f"{r['to_hot_s'] * 1e3:.2f} ms, to full {r['to_full_s'] * 1e3:.2f} ms, "
            f"{r['faults']} pages absent at the touch")
    f = rep["fault_ms"]
    log(f"  [{card}] fault service of access() on absent pages: n={f['n']} "
        f"p50 {f['p50']} ms p99 {f['p99']} ms max {f['max']} ms; longest install by a "
        f"completion worker {rep['longest_install_ms']} ms; its installs' share of the "
        f"restores' wall {rep['install_share']}")
    p = rep["profile_window"]
    log(f"  [{card}] profiled {p['wall_ms']:.1f} ms window of the 8 + 1 restores: device "
        f"busy {p['device_busy_ms']:.3f} ms, idle share {p['device_idle_share']:.4f}")
    for r in p["top"][:4]:
        log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    log(f"  [{card}] peak device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB")
    log(f"  [{card}] group a chunks {rep['chunks_a']}; fan-out installs "
        f"{rep['server_a']['fanout_installs']}, demand reads {rep['server_a']['demand_reads']}; "
        f"update drained ({rep['drain_polls']} polls) under {rep['drain_checks']} borrows, "
        f"then version 1 restored "
        f"bit-identically; launches {rep['launches']} ({rep['launch_parts']})")
    log(f"  [{card}] modeled (paper cost model, not device time): instance a0 "
        f"{rep['modeled_total_s']['a0'] * 1e3:.4f} ms, b {rep['modeled_total_s']['b'] * 1e3:.4f} "
        f"ms {json.dumps(rep['modeled_ledger_s']['a0'])}")


def flash_pairs(b: int, hq: int, sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: suffix-aligned causal rows
    see i + Skv - Sq + 1 keys."""
    if not causal:
        return b * hq * sq * skv
    off = skv - sq
    return b * hq * (sq * (off + 1) + sq * (sq - 1) // 2)


def flash_bound_ms(q, k, v, causal: bool):
    """Least time for one call: 2*(Dk+Dv) operations per (query, key) pair at
    the peak rate for the inputs' type (bf16: tensor cores; float32: CUDA
    cores, as its float32 semantics rule out TF32), against q, k, v read and
    the output written once at the memory rate."""
    import torch

    b, hq, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[3]
    ops = 2 * (dk + dv) * flash_pairs(b, hq, sq, skv, causal)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    nbytes = (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) * q.element_size()
    t, by = bound_ms(nbytes, 0)
    if ops / rate * 1e3 > t:
        t, by = ops / rate * 1e3, "operations"
    return t, by, ops, nbytes


def _cuobjdump():
    import shutil

    tool = Path("/usr/local/cuda/bin/cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def sass_counts(lib_path: Path) -> dict:
    """How many HGMMA (wgmma) and UTMALDG (TMA load) instructions the
    library's SASS holds, where the toolkit has ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return {"cuobjdump": None}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    return {"cuobjdump": tool, "HGMMA": sass.count("HGMMA"), "UTMALDG": sass.count("UTMALDG")}


def res_usage(lib_path: Path, function: str) -> dict:
    """Registers, stack, local (spill) and shared bytes of the kernel whose
    mangled name holds ``function``, as ``cuobjdump -res-usage`` reads them."""
    import re

    tool = _cuobjdump()
    if tool is None:
        return {"cuobjdump": None}
    text = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    at = text.find(function)
    m = re.search(r"REG:\d+[^\n]*", text[at:]) if at >= 0 else None
    if m is None:
        raise AssertionError(f"cuobjdump -res-usage lists no kernel named {function}")
    return {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", m.group(0))}


def check_flash(torch, device, seed: int) -> dict:
    """Flash attention against its plain versions on the card, each case on
    the route ``ops.route`` gives it (asserted, by the rule and by the launch
    counts): the prefill path's shape (B=1, Hq=24, Hkv=8, S=8192, D=128,
    causal) in bf16 and float32, one tile, keys not a multiple of 128, a
    ragged Sq=1000 < Skv=1500 case, Dk != Dv and non-causal ones.  Then, at
    the prefill shape in bf16 and in turns, CUDA-event times of the
    tensor-core kernel, the SIMT kernel on the same inputs and the library
    call, beside the plain version and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, chunked_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device=device)
    g.manual_seed(seed + 17)

    def qkv(b, hq, hkv, sq, skv, dk, dv, dtype):
        return (torch.randn(b, hq, sq, dk, generator=g, device=device).to(dtype),
                torch.randn(b, hkv, skv, dk, generator=g, device=device).to(dtype),
                torch.randn(b, hkv, skv, dv, generator=g, device=device).to(dtype))

    # The reference runs in float32 on the inputs upcast, so it carries no
    # bf16 rounding: float32 output within 1e-5 (summation order), bf16
    # output within one round-to-nearest of it, |got - want| <= 2^-8 |want|
    # + 1e-4.  Truncating, computing in bf16, rounding P to bf16 or TF32 for
    # the P.V product, or losing 1% of a tile fails.
    tol = {torch.float32: {"rtol": 1e-5, "atol": 1e-5},
           torch.bfloat16: {"rtol": 2.0 ** -8, "atol": 1e-4}}

    def share_of(got, want, dtype):
        t = tol[dtype]
        err = (got.float() - want).abs()
        return float(err.max()), float((err / (t["atol"] + t["rtol"] * want.abs())).max())

    def check(name, got, want, dtype):
        """``want``: float32 from the upcast inputs.  Returns (max abs error,
        worst share of the limit)."""
        err, share = share_of(got, want, dtype)
        if got.dtype != dtype or got.shape != want.shape or share > 1:
            raise AssertionError(f"flash_attention ({name}) differs from its float32 plain "
                                 f"version: max_abs_err {err}, {share:.3f} of "
                                 f"the limit {tol[dtype]}")
        return err, share

    bf, f32 = torch.bfloat16, torch.float32
    path = (1, 24, 8, PREFILL_SEQ, PREFILL_SEQ, 128, 128)
    cases = [("path shape bf16", path, bf, True, "sm90"),
             ("path shape f32", path, f32, True, "simt"),
             ("one tile Sq=Skv=128", (1, 24, 8, 128, 128, 128, 128), bf, True, "sm90"),
             ("Skv=1100, not a multiple of 128", (2, 24, 8, 700, 1100, 128, 128), bf, True,
              "sm90"),
             ("ragged Sq=1000<Skv=1500", (1, 24, 8, 1000, 1500, 128, 128), bf, True, "sm90"),
             ("ragged f32, Dk=192 Dv=128", (2, 6, 2, 333, 517, 192, 128), f32, True, "simt"),
             ("non-causal", (1, 24, 8, 1000, 1500, 128, 128), bf, False, "sm90"),
             ("non-causal D=64", (2, 8, 2, 300, 200, 64, 64), bf, False, "sm90"),
             ("non-causal f32", (2, 8, 2, 300, 200, 64, 64), f32, False, "simt")]
    out = {"cases": [], "tolerance": {"float32": tol[f32], "bfloat16": tol[bf]}}
    for name, shape, dtype, causal, want_route in cases:
        q, k, v = qkv(*shape, dtype)
        before = fops.launches_by_route()
        got = flash_attention(q, k, v, causal=causal)
        took = [r for r, n in fops.launches_by_route().items() if n != before[r]]
        if fops.route(q, k, v) != want_route or took != [want_route]:
            raise AssertionError(f"flash_attention ({name}) took route {took}, want {want_route}")
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        err, share = check(name, got, want, dtype)
        row = {"name": name, "shape": list(shape), "dtype": str(dtype), "causal": causal,
               "route": want_route, "max_abs_err": err, "share_of_limit": share}
        if shape == path and dtype == bf:
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            row["library_max_abs_err"], row["library_share_of_limit"] = share_of(lib, want, bf)
            del lib
        out["cases"].append(row)
        log(f"  flash_attention {name} {tuple(shape)} causal={causal} route {want_route}: "
            f"max_abs_err {err:.3g}, {share:.3f} of the limit {tol[dtype]}")
        if "library_share_of_limit" in row:
            log(f"    scaled_dot_product_attention on the same inputs: max_abs_err "
                f"{row['library_max_abs_err']:.3g}, {row['library_share_of_limit']:.3f} of the "
                "limit (for information, not asserted)")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    q, k, v = qkv(*path, bf)
    chunked = chunked_attention_ref(q.float(), k.float(), v.float())
    err, share = check("vs chunked", flash_attention(q, k, v), chunked, bf)
    log(f"  flash_attention path shape bf16 vs chunked_attention_ref (float32): max_abs_err "
        f"{err:.3g}, {share:.3f} of the limit")
    del chunked
    bound, by, ops, nbytes = flash_bound_ms(q, k, v, True)
    o = torch.empty_like(q)
    scale = q.shape[3] ** -0.5

    def sm90():
        return flash_attention(q, k, v)

    def simt():      # the SIMT kernel on the same bf16 inputs, through its binding
        fkernel.flash_attention(q, k, v, o, scale, True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    turns = {"sm90": [], "simt": [], "library": []}
    for name, fn, iters in (("sm90", sm90, 20), ("simt", simt, 5), ("library", library, 20),
                            ("library", library, 20), ("simt", simt, 5), ("sm90", sm90, 20)):
        turns[name].append(cuda_ms(fn, iters=iters))
    simt()
    torch.cuda.synchronize()
    err_simt, share_simt = check("SIMT kernel, bf16", o, attention_ref(
        q.float(), k.float(), v.float()), bf)
    r = {"shape": f"B=1 Hq=24 Hkv=8 S={PREFILL_SEQ} D=128 causal bf16", "turns_ms": turns,
         "ms": sum(turns["sm90"]) / 2, "simt_ms": sum(turns["simt"]) / 2,
         "library_ms": sum(turns["library"]) / 2,
         "order": "sm90, simt, library, library, simt, sm90",
         "plain_ms": cuda_ms(lambda: chunked_attention_ref(q, k, v), iters=3, warmup=1),
         "plain": "chunked_attention_ref (block_k=512), the CPU dispatch's version at this Skv",
         "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
         "simt_share_of_limit": share_simt,
         "bound_ms": bound, "bound_by": by, "flop": ops, "bytes": nbytes}
    del q, k, v, o
    qf, kf, vf = qkv(1, 24, 8, PREFILL_SEQ, PREFILL_SEQ, 128, 128, f32)
    bf_, byf, _, _ = flash_bound_ms(qf, kf, vf, True)
    r["f32"] = {"ms": cuda_ms(lambda: flash_attention(qf, kf, vf), iters=5),
                "bound_ms": bf_, "bound_by": byf, "route": "simt"}
    del qf, kf, vf
    torch.cuda.empty_cache()
    out["timing"] = r
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"])
    out["sass"] = sass_counts(build.lib_path("flash_attention_sm90"))
    log(f"  flash_attention {r['ms']:.4f} ms on the tensor cores at {r['shape']} "
        f"({', '.join(f'{t:.4f}' for t in turns['sm90'])}); SIMT kernel {r['simt_ms']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in turns['simt'])}); library {r['library_ms']:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in turns['library'])}); plain chunked "
        f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms by {by}: {ops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; float32 {r['f32']['ms']:.3f} ms on the SIMT kernel (bound "
        f"{bf_:.3f} ms at the CUDA-core rate)")
    log(f"  flash_attention_sm90 SASS: {out['sass']}")
    return out


def profile_model(torch, fn, name: str, out_dir: Path) -> dict:
    """``fn()`` under torch.profiler: device busy time and idle share, the top
    device kernels, and the top host ops by their own CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = _device_summary(torch, prof, wall, top=6)
    host = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CUDA]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    row["host_top"] = [{"name": e.key, "count": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3}
                       for e in host[:6]]
    (out_dir / f"profile_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25) + "\n" +
        prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
    log(f"  profile {name}: wall {row['wall_ms']:.2f} ms under the profiler, device busy "
        f"{row['device_busy_ms']:.3f} ms, idle share {row['device_idle_share']:.4f}")
    for r in row["top"][:3]:
        log(f"    device {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    for r in row["host_top"][:3]:
        log(f"    host {r['self_cpu_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return row


def model_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Phi-4-mini at full width on the card through the port's entry points:
    the full-depth prefill forward (flash kernel), the serving engine
    (decode attention), and decode against forward (see the docstring)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build
    from repro_torch.serve import new_instance

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MODEL_ARCH)
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "param_count": cfg.param_count()}
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    # prefill: Model.forward, all layers, one 8,192-token sequence
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=device)
    params = model.init(seed)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_SEQ), generator=g, device=device)
    fwd_s = []
    for i in range(2):
        if i == 0:
            fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        if i == 0:
            rep["launches"] = flash_attention.launches
            rep["launches_by_route"] = fops.launches_by_route()
            if rep["launches_by_route"] != {"sm90": cfg.n_layers, "simt": 0}:
                raise AssertionError(f"prefill forward launched flash_attention "
                                     f"{rep['launches_by_route']}, want {cfg.n_layers} on the "
                                     "tensor-core route and none on the SIMT one")
        if (logits.shape != (1, PREFILL_SEQ, cfg.padded_vocab) or logits.dtype != torch.float32
                or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} {logits.dtype} not "
                                 "finite / of the expected shape")
        del logits
    rep["forward_s"] = fwd_s
    rep["forward_tokens_per_s"] = PREFILL_SEQ / min(fwd_s)
    rep["forward_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  prefill: Model.forward of {PREFILL_SEQ} tokens, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}: {fwd_s[0]:.3f} s cold, {fwd_s[1]:.3f} s warm; "
        f"flash_attention launches {rep['launches']} {rep['launches_by_route']}; logits finite; "
        "peak device memory "
        f"{rep['forward_peak_mem_bytes'] / 2**30:.3f} GiB (init {rep['init_s']:.2f} s)")
    rep["profile_prefill"] = profile_model(
        torch, lambda: model.forward(params, {"tokens": tokens}), "prefill", out_dir)

    # serve: 4 requests of 128-token prompts, 32 new tokens each, through generate
    batch, prompt_len, n_new = 4, 128, 32
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inst = new_instance(cfg, params, batch=batch, max_len=prompt_len + n_new, device=device)
    answer = inst.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if answer.shape != (batch, n_new) or inst.pos != prompt_len + n_new:
        raise AssertionError(f"generate gave {answer.shape} at pos {inst.pos}")
    if flash_attention.launches != before:
        raise AssertionError("the serving engine launched flash_attention")
    # the same requests once more, prefill and decode timed apart
    inst2 = new_instance(cfg, params, batch=batch, max_len=prompt_len + n_new, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_logits = inst2.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(pre_logits, dim=-1)[:, None].to(torch.int32)
    again = []
    t0 = time.perf_counter()
    for _ in range(n_new):
        again.append(tok[:, 0].cpu().numpy())
        tok = torch.argmax(inst2.decode(tok), dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not np.array_equal(np.stack(again, axis=1), answer):
        raise AssertionError("a second serving of the same requests gave other tokens")
    rep["serve"] = {"batch": batch, "prompt_len": prompt_len, "new_tokens": n_new,
                    "generate_s": gen_s, "prefill_s": prefill_s, "decode_s": decode_s,
                    "decode_tokens_per_s": batch * n_new / decode_s,
                    "prefill_tokens_per_s": batch * prompt_len / prefill_s,
                    "answer_first_tokens": answer[:, :4].tolist()}
    log(f"  serve: {batch} requests x {prompt_len}-token prompts, {n_new} new tokens each: "
        f"generate {gen_s:.3f} s (incl. instance set-up); timed apart: prefill "
        f"{prefill_s:.3f} s ({rep['serve']['prefill_tokens_per_s']:.1f} tokens/s, one decode "
        f"step per prompt token), decode {decode_s:.3f} s "
        f"({rep['serve']['decode_tokens_per_s']:.1f} tokens/s); flash_attention launches "
        "unchanged; both servings gave the same tokens")
    del inst

    # decode vs forward, full depth bf16: last-position logits of the forward
    # (flash path) against the engine's prefill logits (decode path)
    full, _ = model.forward(params, {"tokens": prompts})
    last = full[:, -1]
    del full
    rel = float((last - pre_logits).abs().max() / last.abs().max())
    agree = float((last.argmax(-1) == pre_logits.argmax(-1)).float().mean())
    rep["bf16_forward_vs_prefill"] = {"rel_max_err": rel, "argmax_agreement": agree}
    log(f"  full depth bf16: forward last-position logits vs engine prefill logits: "
        f"relative max error {rel:.4g}, argmax agreement {agree:.2f} (not asserted)")
    del inst2, last, pre_logits

    # four decode steps of a fresh instance under the profiler (after two)
    inst3 = new_instance(cfg, params, batch=batch, max_len=8, device=device)
    tok = prompts[:, :1].to(torch.int32)
    for _ in range(2):
        inst3.decode(tok)

    def four_steps():
        for _ in range(4):
            inst3.decode(tok)
    rep["profile_decode"] = profile_model(torch, four_steps, "decode", out_dir)
    del inst3, params, model
    torch.cuda.empty_cache()

    # decode vs forward, full width, 2 layers, float32 compute (tests/test_models.py's bound)
    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-2l-f32", n_layers=2,
                               compute_dtype="float32")
    m2 = build(cfg2, device=device)
    p2 = m2.init(seed + 1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g, device=device)
    full, _ = m2.forward(p2, {"tokens": toks})
    caches = m2.init_caches(p2, 2, 16)
    dec = []
    for t in range(16):
        lg, caches = m2.decode_step(p2, {"tokens": toks[:, t:t + 1], "pos": t}, caches)
        dec.append(lg[:, 0])
    rel2 = float((torch.stack(dec, 1) - full).abs().max() / full.abs().max())
    rep["f32_decode_vs_forward_rel"] = rel2
    if not rel2 < 2e-3:
        raise AssertionError(f"f32 decode vs forward relative error {rel2} >= 2e-3")
    log(f"  full width, 2 layers, float32: decode vs forward relative max error {rel2:.3g} "
        "(< 2e-3)")
    del p2, m2, full, dec, caches
    torch.cuda.empty_cache()
    return rep


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
    from repro_torch.kernels.snapshot_fuse import ops, ref

    device = torch.device("cuda", 0)
    n = PAPER_INSTANCE_PAGES
    report = {"seed": args.seed, "pages": n, "phase_s": {}}
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        report["phase_s"][name] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {name}: {report['phase_s'][name]:.2f} s")

    # 1. card
    card = card_line()
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    log(f"card: {card}  ({report['torch']})")
    phase_done("card")

    # 2. build
    t0 = time.perf_counter()
    compiled = build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build_s_by_library"] = compiled
    report["build_logs"] = dict(build.build_logs)
    log(f"build: {report['build_s']:.2f} s for {sorted(compiled) or 'cached libraries'}, in "
        f"parallel: {', '.join(f'{n} {t:.2f} s' for n, t in sorted(compiled.items()))}")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    phase_done("build")

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
    cold_idx = np.flatnonzero(~hot_np & ~zero_np)
    if zero_np[working_set].any():
        raise AssertionError("a hot page of the image is all zero")
    phase_done("image")

    # 4. kernels against their plain versions
    log("kernels:")
    rng = np.random.default_rng(args.seed)
    small = []
    for name, rows, zero_every, ws_all in (("N=0", 0, 3, False), ("ragged N=37", 37, 3, False),
                                           ("N=1000", 1000, 3, False),
                                           ("N=3T+5", 3 * ops.PUBLISH_TILE_PAGES + 5, 3, False),
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
    pub = time_publish(torch, ops, ref, pm, ws_full, nnz)
    pub["resources"] = res_usage(build.lib_path("fused_publish"), "publish_kernel")
    report["publish"] = pub
    log(f"  fused_publish  {pub['ms']:.4f} ms a launch ({pub['bound_ms'] / pub['ms']:.3f} of the "
        f"bound {pub['bound_ms']:.4f} ms by {pub['bound_by']}); through the wrapper "
        f"{pub['wrapper_ms']:.4f} ms; plain {pub['plain_ms']:.4f} ms; at {n} pages; "
        f"publish_kernel {pub['resources']}")
    table = ops.fused_publish(pm, ws_full).checksums      # guest-indexed, as a snapshot's
    walks = {"hot": walk_segments(torch, np, pm, working_set, RestoreEngine.HOT_CHUNK_PAGES),
             "cold": walk_segments(torch, np, pm, cold_idx)}
    res_err = max(res_err, check_row_lists(torch, np, pm, table, walks))
    row_lists = time_row_lists(torch, np, pm, table, walks, cold_idx, device)
    report["row_lists"] = row_lists
    del walks, table
    torch.cuda.empty_cache()
    fused_csum = ops.fused_publish(pm, ws_full).checksums
    row_err = check_row_kernels(torch, np, pm, fused_csum, working_set, cold_idx, device)
    del fused_csum
    row_t = time_row_kernels(torch, pm, working_set, cold_idx, device)
    report["row_kernel_timings"] = row_t
    phase_done("kernels")

    # 5. main path, counts reset just before it
    from repro_torch import kernels as kmod

    row_kernels = {name: getattr(kmod, name) for name in ROW_KERNELS}
    for k in (ops.fused_publish, ops.fused_restore, *row_kernels.values()):
        k.launches = 0
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
    launches_private_row = {name: k.launches for name, k in row_kernels.items()}
    n_cold_runs = int(reader.cold_runs().shape[0])
    routes = engine.walk_routes
    want_restore = 2 * routes["batched"]     # a walk: one verify-only launch, one install
    verified = inst.scatter_fn.stats["pages_verified"]
    main = {"publish_s": publish_s, "restore_s": restore_s,
            "pre_install_hot_s": t_hot - t0, "n_hot": regions.n_hot,
            "n_cold": regions.n_cold, "n_zero": regions.n_zero,
            "cold_runs": n_cold_runs, "launches": launches, "walk_routes": routes,
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
    check_routes("private main path", routes)
    if launches["fused_publish"] != 1 or launches["fused_restore"] != want_restore:
        raise AssertionError(f"launch counts {launches}, want publish 1, "
                             f"restore {want_restore}")
    log(f"main path: publish {publish_s * 1e3:.2f} ms, restore {restore_s * 1e3:.2f} ms "
        f"(hot pre-install {main['pre_install_hot_s'] * 1e3:.2f} ms) wall; "
        f"n_hot={regions.n_hot} n_cold={regions.n_cold} n_zero={regions.n_zero} "
        f"cold_runs={n_cold_runs}")
    log(f"  bit-identical restore: True; pages verified {verified}; launches {launches}; "
        f"walks {routes}")
    log(f"  peak device memory {main['peak_mem_bytes'] / 2**30:.3f} GiB")
    log(f"  modeled (paper cost model, not device time): total "
        f"{main['modeled_total_s'] * 1e3:.4f} ms {json.dumps(main['modeled_ledger_s'])}")
    main["routes_in_turns"] = route_turns(
        torch, "private", lambda scatter: restore_once(
            torch, pool, regions, image.buf, image.manifest, scatter),
        ops.FusedScatter, PerExtentScatter)
    phase_done("main")

    del inst, engine, reader
    free_snapshot(pool, regions)
    del pool
    torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    report["profile"] = profile_main_path(torch, HierarchicalPool(device="cuda"), image,
                                          working_set, ops, out.parent)
    phase_done("profile")

    # 7. the dedup fleet, counts reset inside just before it
    log("dedup fleet:")
    report["dedup"] = dedup_phase(torch, np, buf, working_set, cold_idx, manifest, args.seed,
                                  out.parent)
    torch.cuda.empty_cache()
    phase_done("dedup")

    # 8. the pod's control plane, counts reset inside just before it
    log("pod:")
    report["pod"] = pod_phase(torch, np, image, working_set, cold_idx, args.seed, out.parent)
    log_pod(report["pod"], card)
    torch.cuda.empty_cache()
    phase_done("pod")

    # 9. the model: the flash kernel's checks and timings, then Phi-4-mini's
    # prefill forward (counts reset inside just before it), serving and parity
    log("model:")
    del pm, image, buf
    torch.cuda.empty_cache()
    report["flash"] = check_flash(torch, device, args.seed)
    report["model"] = model_phase(torch, np, args.seed, device, out.parent)
    phase_done("model")

    dedup_launches = report["dedup"]["launches"]
    pod_launches = report["pod"]["launches"]
    cold, hot, store = row_lists["cold"], row_lists["hot"], row_lists["store_write"]
    kernels = [
        {"name": "fused_publish", "route": "cuda", "source": f"{CSRC}/fused_publish.cu",
         "replaces": PUBLISH_TPU, "launches": launches["fused_publish"],
         "launches_by_path": {"private": launches["fused_publish"],
                              "dedup": dedup_launches["fused_publish"],
                              "pod": pod_launches["fused_publish"]},
         "bit_equal": True, "max_abs_err": pub_err, "ms": pub["ms"], "plain_ms": pub["plain_ms"],
         "bound_ms": pub["bound_ms"], "bound_by": pub["bound_by"], "library_ms": None,
         "wrapper_ms": pub["wrapper_ms"], "resources": pub["resources"],
         "shape": f"{n} pages, {nnz} non-zero, one launch"},
        {"name": "fused_restore", "route": "cuda", "source": f"{CSRC}/fused_restore.cu",
         "replaces": RESTORE_TPU, "launches": launches["fused_restore"],
         "launches_by_path": {"private": launches["fused_restore"],
                              "dedup": dedup_launches["fused_restore"],
                              "pod": pod_launches["fused_restore"]},
         "bit_equal": True, "max_abs_err": res_err,
         "ms": cold["install"]["ms"], "plain_ms": cold["plain_ms"],
         "bound_ms": cold["install"]["bound_ms"], "bound_by": cold["install"]["bound_by"],
         "library_ms": None,
         "shape": f"private cold walk, verified install, {cold['rows']} rows from "
                  f"{cold['segments']} segments",
         "verify_only_ms": cold["verify_only"]["ms"],
         "verify_only_bound_ms": cold["verify_only"]["bound_ms"],
         "hot_walk_ms": hot["install"]["ms"], "hot_walk_bound_ms": hot["install"]["bound_ms"],
         "flush_wrapper_ms": cold["flush_wrapper_ms"]},
    ]
    for name, tpu in ROW_KERNELS.items():
        if name == "page_scatter":
            r = dict(store, ms=store["ms"]["kernel"], library_ms=store["ms"]["library"],
                     walk_ms=cold["scatter"]["ms"], walk_bound_ms=cold["scatter"]["bound_ms"])
        else:
            r = row_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu", "replaces": tpu,
            "launches": dedup_launches[name],
            "launches_by_path": {"private": launches_private_row[name],
                                 "dedup": dedup_launches[name], "pod": pod_launches[name]},
            "bit_equal": True, "max_abs_err": row_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({} if name != "page_scatter" else
               {"walk_ms": r["walk_ms"],
                "walk_bound_ms": r["walk_bound_ms"]})})
    r = report["flash"]["timing"]
    by_route = report["model"]["launches_by_route"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC["sm90"],
        "replaces": FLASH_TPU, "launches": by_route["sm90"],
        "launches_by_route": by_route,
        "launches_by_path": {"prefill_forward": report["model"]["launches"]},
        "bit_equal": False, "tolerance": report["flash"]["tolerance"],
        "max_abs_err": report["flash"]["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "simt_ms": r["simt_ms"], "simt_source": FLASH_SRC["simt"], "shape": r["shape"]})
    report["kernels"] = kernels
    out.write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
