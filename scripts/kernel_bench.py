#!/usr/bin/env python3
"""Kernel benchmark and calibration for the port's snapshot data plane.

    PYTHONPATH=src python scripts/kernel_bench.py [--quick] [--device cuda|cpu]
        [--write-calibration]

The port's twin of ``benchmarks/kernel_bench.py``, in three layers:

* **modeled** — roofline byte counts of the piecemeal op sequence against
  the fused kernels at a canonical workload (65,536 pages, a third zero,
  16,384-page chunk) through ``roofline.analysis.movement_roofline`` at the
  H100's memory rate.  The piecemeal bytes are the reference's formulas;
  the fused bytes are those the port's kernels move, which
  ``chip_smoke.publish_bound`` and ``chip_smoke.restore_rows_bytes`` count
  (``fused_traffic_vs_tpu`` names what differs from the TPU kernels').
  Pure arithmetic, so these are the keys ``check_regressions.py`` gates.
* **measured** — on ``cuda`` the six kernel wrappers and fused against
  piecemeal, timed with CUDA events after a warm call at the reference's
  dispatch shapes (8,192 pages, 2,048-page chunk, 5 reps); ``--quick``
  takes the reference's interpret shapes (64 pages, 16-page chunk, 2 reps).
  On ``cpu`` the wrappers run their plain versions.  Every time here is a
  wall clock or a device time of this run and is never gated; the fused
  and piecemeal paths' bit-identity on the timed shapes is.
* **calibration** — the per-page constants that ``serve/strategies.py``
  reads from ``experiments/torch/kernel_calibration.json``, derived from the
  fused kernels' bytes at the H100's memory rate (:func:`calibration_section`,
  the one derivation; ``scripts/write_calibration.py`` calls it).
  ``--write-calibration`` also writes it beside the bench's output, with the
  card's ``nvidia-smi`` name and power limit (so only on a card).

Results go to ``experiments/torch/kernel_bench.json`` (the committed CPU run)
or ``build/benches/`` with another ``--device``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    fused_publish,
    fused_restore,
    page_checksum,
    page_gather,
    page_scatter,
    zero_detect,
)
from repro_torch.roofline.analysis import HBM_BW, movement_roofline  # noqa: E402

OUT = ROOT / "experiments" / "torch"

# The reference's canonical modeled workload, so the modeled keys do not
# depend on the tier: a 256 MiB image, a third zero, the working set half
# of the non-zero pages; a restore pre-installs a 64 MiB hot chunk.
MODEL_N = 65536
MODEL_ZERO = MODEL_N // 3
MODEL_HOT = (MODEL_N - MODEL_ZERO) // 2
MODEL_COLD = MODEL_N - MODEL_ZERO - MODEL_HOT
MODEL_CHUNK = 16384

FUSED_TRAFFIC_VS_TPU = {
    "publish": "reads a 1-byte working-set flag a page and the 4 KiB of poly32 weights, "
               "writes a 1-byte zero flag and a 4-byte checksum a page and 8 bytes of "
               "counts; the TPU kernel's count is 8 bytes written a page",
    "restore": "reads a 16-byte address and destination and a 4-byte expected checksum a "
               "row, writes a 4-byte checksum and a 1-byte bad flag a row and a 4-byte "
               "mismatch count; the TPU kernel's count is 4 bytes written a row",
}


# -- modeled (gated) ----------------------------------------------------------
def publish_traffic(n: int, n_hot: int, n_cold: int):
    """(read, written) HBM bytes per op of the reference's piecemeal publish
    sequence (zero bitmap, guest-indexed checksum table, compacted hot and
    cold rows, dedup hashes; int32 bitmap and checksums), and of the port's
    one-pass publish kernel (``chip_smoke.publish_bound``'s bytes)."""
    p, nz = PAGE_SIZE, n_hot + n_cold
    piecemeal = {
        "zero_detect": (n * p, 4 * n),
        "page_checksum": (n * p, 4 * n),
        "gather_hot": (n_hot * p, n_hot * p),
        "gather_cold": (n_cold * p, n_cold * p),
        "dedup_hash": (nz * p, 4 * nz),
    }
    fused = (n * p + n + p, n + 4 * n + nz * p + 8)
    return piecemeal, fused


def restore_traffic(m: int):
    """Piecemeal pre-install (gather → checksum → scatter), the reference's
    bytes, against the port's verified row-list install of ``m`` rows
    (``chip_smoke.restore_rows_bytes``)."""
    p = PAGE_SIZE
    piecemeal = {
        "page_gather": (m * p, m * p),
        "page_checksum": (m * p, 4 * m),
        "page_scatter": (m * p, m * p),
    }
    fused = (m * p + 16 * m + 4 * m, m * p + 4 * m + m + 4)
    return piecemeal, fused


def _modeled_pair(piecemeal: dict, fused_rw) -> dict:
    ops = [movement_roofline(k, r, w) for k, (r, w) in piecemeal.items()]
    fused = movement_roofline("fused", *fused_rw)
    piece_s = sum(o["bound_s"] for o in ops)
    speedup = piece_s / fused["bound_s"]
    return {
        "piecemeal_s": piece_s,
        "fused_s": fused["bound_s"],
        "speedup": speedup,
        "speedup_ge_2": bool(speedup >= 2.0),
        "piecemeal_ops": ops,
        "fused": fused,
    }


def modeled_section() -> dict:
    pub = _modeled_pair(*publish_traffic(MODEL_N, MODEL_HOT, MODEL_COLD))
    res = _modeled_pair(*restore_traffic(MODEL_CHUNK))
    return {
        "workload": {"n_pages": MODEL_N, "n_zero": MODEL_ZERO,
                     "n_hot": MODEL_HOT, "n_cold": MODEL_COLD,
                     "chunk_pages": MODEL_CHUNK, "hbm_bw_Bps": HBM_BW},
        "publish": pub,
        "restore": res,
        "fused_traffic_vs_tpu": FUSED_TRAFFIC_VS_TPU,
    }


def calibration_section(modeled: dict, card=None) -> dict:
    """The per-page constants of ``experiments/torch/kernel_calibration.json``:
    the fused kernels' bytes of ``modeled`` at the H100's memory rate, for
    the card named by ``card`` (its ``nvidia-smi`` name and power limit)."""
    rate = modeled["workload"]["hbm_bw_Bps"]
    publish_bytes = modeled["publish"]["fused"]["bytes_total"]
    preinstall_bytes = modeled["restore"]["fused"]["bytes_total"]
    csum = movement_roofline("page_checksum", PAGE_SIZE, 4, bw=rate)
    return {
        "written_by": "scripts/write_calibration.py",
        "note": "per-page data-plane costs at the H100 memory rate for the bytes the "
                "port's kernels move; serve/strategies.py reads `constants` at import",
        "card": card,
        "platform": {"hbm_bw_Bps": rate},
        "per_page": {
            "checksum_bytes": PAGE_SIZE + 4,
            "publish_sweep_bytes": publish_bytes / MODEL_N,
            "preinstall_bytes": preinstall_bytes / MODEL_CHUNK,
        },
        "constants": {
            "checksum_bw_Bps": PAGE_SIZE / csum["bound_s"],
            "publish_sweep_page_s": publish_bytes / MODEL_N / rate,
            "preinstall_page_s": preinstall_bytes / MODEL_CHUNK / rate,
        },
    }


def calibration_in_sync(cal: dict) -> bool:
    """Do the constants ``serve/strategies.py`` loaded (from the committed
    file) match what this bench derives now?  Flips the gated boolean when
    the kernels' traffic changes and the file is not written again."""
    from repro_torch.serve import strategies

    loaded = {
        "checksum_bw_Bps": strategies.CHECKSUM_BW,
        "publish_sweep_page_s": strategies.PUBLISH_SWEEP_PAGE_S,
        "preinstall_page_s": strategies.PREINSTALL_PAGE_S,
    }
    want = cal["constants"]
    return all(abs(loaded[k] - want[k]) <= 1e-9 * abs(want[k]) for k in want)


# -- measured (informational) -------------------------------------------------
def _time(fn, reps: int, device: torch.device):
    """(first_call_s, steady_s): the first call on its own (on the card it
    includes loading the kernel's library), then one warm call, then the
    mean of ``reps`` calls: CUDA events on the card, the host clock on the
    CPU."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return first, (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return first, start.elapsed_time(end) / 1e3 / reps


def _mk_workload(n: int, device: torch.device, seed: int = 0):
    """The reference's pages (every third zero) and working set (half the
    pages), from the same numpy stream, on ``device``."""
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, size=(n, PAGE_SIZE), dtype=np.uint8)
    pages[::3] = 0
    ws = np.zeros(n, dtype=bool)
    ws[rng.choice(n, size=n // 2, replace=False)] = True
    pages_t = torch.from_numpy(pages).to(device)
    return pages_t, pages_t.view(torch.int32), torch.from_numpy(ws).to(device), ws


def measured_section(quick: bool, device) -> dict:
    """The six wrappers and both fused-against-piecemeal pairs on
    ``device``: the quick tier at (64 pages, 16-row chunk, 2 reps), the
    full one at (8,192, 2,048, 5)."""
    device = torch.device(device)
    tier = "quick" if quick else "full"
    n, m, reps = (64, 16, 2) if quick else (8192, 2048, 5)
    pages, u32, ws_t, ws = _mk_workload(n, device)
    rows = []

    def bench(name, fn, nbytes):
        first, steady = _time(fn, reps, device)
        rows.append({
            "kernel": name, "tier": tier, "bytes": nbytes,
            "first_call_s": first, "steady_s": steady,
            "steady_GBps": nbytes / steady / 1e9,
            "modeled_s": nbytes / HBM_BW,
        })
        return steady

    bench("zero_detect", lambda: zero_detect(u32), u32.numel() * 4)
    bench("page_checksum", lambda: page_checksum(pages), pages.numel())
    zb = zero_detect(u32).cpu().numpy() != 0
    hot_idx = np.flatnonzero(~zb & ws)
    cold_idx = np.flatnonzero(~zb & ~ws)
    bench("page_gather", lambda: page_gather(u32, hot_idx), 2 * hot_idx.size * PAGE_SIZE)
    chunk = page_gather(u32, hot_idx)
    dst = np.sort(hot_idx)
    src = np.arange(dst.size, dtype=np.int64)
    dest0 = torch.zeros_like(u32)
    bench("page_scatter", lambda: page_scatter(dest0, chunk, dst), 2 * dst.size * PAGE_SIZE)

    # fused against piecemeal: publish
    def piecemeal_publish():
        zb_ = zero_detect(u32) != 0
        csum = page_checksum(pages)
        zb_host = zb_.cpu().numpy()
        hi = np.flatnonzero(~zb_host & ws)
        ci = np.flatnonzero(~zb_host & ~ws)
        hot = page_gather(u32, hi)
        cold = page_gather(u32, ci)
        return zb_, csum, hot, cold, page_checksum(hot), page_checksum(cold)

    def do_fused_publish():
        return fused_publish(pages, ws_t)

    nz_bytes = (hot_idx.size + cold_idx.size) * PAGE_SIZE
    pm_bytes = 2 * n * PAGE_SIZE + 2 * nz_bytes + nz_bytes
    fu_bytes = n * PAGE_SIZE + nz_bytes
    pm_pub = bench("publish_piecemeal", piecemeal_publish, pm_bytes)
    fu_pub = bench("publish_fused", do_fused_publish, fu_bytes)

    # fused against piecemeal: the restore's pre-install of one chunk; each
    # path writes a frame of its own, zero but for the chunk's rows
    m = min(m, dst.size)
    chunk_m, src_m, dst_m = chunk[:m], src[:m], dst[:m]
    chunk_b = chunk_m.view(torch.uint8)
    dest_b = torch.zeros((n, PAGE_SIZE), dtype=torch.uint8, device=device)
    dest_pm = torch.zeros_like(u32)

    def piecemeal_restore():
        g = page_gather(chunk_m, src_m)
        return page_checksum(g), page_scatter(dest_pm, g, dst_m)

    def do_fused_restore():
        return fused_restore(dest_b, chunk_b, dst_m, src_indices=src_m)

    pm_res = bench("restore_piecemeal", piecemeal_restore, 5 * m * PAGE_SIZE)
    fu_res = bench("restore_fused", do_fused_restore, 2 * m * PAGE_SIZE)

    # bit-identity of the two paths on the timed shapes (untimed)
    zb_, csum, hot, cold, hhash, chash = piecemeal_publish()
    fp = do_fused_publish()
    f_out, f_csums = do_fused_restore()
    p_csums, p_out = piecemeal_restore()
    identical = bool(
        torch.equal(fp.zero_bitmap, zb_)
        and torch.equal(fp.checksums, csum)
        and torch.equal(fp.hot.view(torch.int32), hot)
        and torch.equal(fp.cold.view(torch.int32), cold)
        and torch.equal(fp.checksums[torch.from_numpy(hot_idx).to(device)], hhash)
        and torch.equal(fp.checksums[torch.from_numpy(cold_idx).to(device)], chash)
        and torch.equal(f_csums, p_csums)
        and torch.equal(f_out.view(torch.int32), p_out)
    )

    # per-call overhead: the steady time of a 3-page publish is ~pure
    # per-call cost; its share of each full-shape path's steady time says
    # how far the path is from bandwidth-bound on this device
    p1, _, w1, _ = _mk_workload(3, device)
    _, pm1 = _time(lambda: fused_publish(p1, w1), reps, device)
    n_pm_ops = 6  # zero + csum + 2x gather + 2x hash calls
    overhead = {
        "per_dispatch_s": pm1,
        "publish_piecemeal_fraction": min(1.0, n_pm_ops * pm1 / pm_pub),
        "publish_fused_fraction": min(1.0, pm1 / fu_pub),
        "restore_piecemeal_fraction": min(1.0, 3 * pm1 / pm_res),
        "restore_fused_fraction": min(1.0, pm1 / fu_res),
    }
    return {
        "tier": tier, "backend": device.type,
        "n_pages": n, "chunk_pages": int(m), "reps": reps,
        "per_kernel": rows,
        "publish": {"piecemeal_steady_s": pm_pub, "fused_steady_s": fu_pub,
                    "speedup": pm_pub / fu_pub},
        "restore": {"piecemeal_steady_s": pm_res, "fused_steady_s": fu_res,
                    "speedup": pm_res / fu_res},
        "python_overhead": overhead,
        "bit_identical": identical,
    }


# -- driver -------------------------------------------------------------------
def run(quick: bool = False, write_calibration: bool = False, device="cuda") -> dict:
    backend = torch.device(device).type
    modeled = modeled_section()
    card = None
    if write_calibration:
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        card = chip_smoke.card_line()
    cal = calibration_section(modeled, card)
    measured = measured_section(quick, device)
    out = {
        "config": {"tier": "quick" if quick else "full", "backend": backend},
        "modeled": modeled,
        "measured": measured,
        "criteria": {
            "bit_identical": measured["bit_identical"],
            "calibration_in_sync": calibration_in_sync(cal),
            "publish_speedup_ge_2": modeled["publish"]["speedup_ge_2"],
            "restore_speedup_ge_2": modeled["restore"]["speedup_ge_2"],
        },
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "kernel_bench.json").write_text(json.dumps(out, indent=2))
    if write_calibration:
        (OUT / "kernel_calibration.json").write_text(json.dumps(cal, indent=2) + "\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's interpret-tier shapes (64 pages, 16-row chunk)")
    ap.add_argument("--write-calibration", action="store_true",
                    help="also write kernel_calibration.json beside the output (on a card)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(quick=args.quick, write_calibration=args.write_calibration, device=args.device)

    mo, me = out["modeled"], out["measured"]
    print(f"tier={out['config']['tier']} backend={out['config']['backend']}")
    for r in me["per_kernel"]:
        print(f"  {r['kernel']:20s} first={r['first_call_s'] * 1e3:8.2f}ms  "
              f"steady={r['steady_s'] * 1e3:8.3f}ms  "
              f"{r['steady_GBps']:7.2f} GB/s")
    for op in ("publish", "restore"):
        print(f"{op}: modeled at the H100 roof {mo[op]['speedup']:.2f}x "
              f"(piecemeal {mo[op]['piecemeal_s'] * 1e3:.3f}ms -> "
              f"fused {mo[op]['fused_s'] * 1e3:.3f}ms), "
              f"measured {me[op]['speedup']:.2f}x steady-state")
    print(f"criteria: {out['criteria']}")
    return 0 if all(out["criteria"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
