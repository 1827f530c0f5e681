#!/usr/bin/env python3
"""Benchmark-regression gate of the PyTorch port.

    PYTHONPATH=src python scripts/check_regressions.py            # re-run + compare
    PYTHONPATH=src python scripts/check_regressions.py --no-run   # compare disk files
    PYTHONPATH=src python scripts/check_regressions.py --baseline-dir DIR

The port's twin of ``benchmarks/check_regressions.py``, over the committed
CPU runs in ``experiments/torch/`` only.  It re-runs the quick bench twins
on the CPU (their files go to ``build/check_regressions/``, so the
committed ones stay as they are) and compares the modeled-time, count and
boolean keys below against the committed baselines, read through
``git show HEAD:experiments/torch/<file>`` so that a bench run that
rewrote the working tree's files cannot launder a regression.  Any key
drifting beyond its tolerance (±10% by default), any boolean flipping, or
any key missing fails the gate with a non-zero exit.  Every key compared
is deterministic; wall clocks are never compared.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

REPO = Path(__file__).resolve().parents[1]
for p in (REPO / "src", REPO / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

EXPERIMENTS = REPO / "experiments" / "torch"
FRESH_OUT = REPO / "build" / "check_regressions"

DEFAULT_TOLERANCE = 0.10

# Key spec: dotted path into the benchmark's JSON (integers index lists);
# optionally (path, tolerance).  Booleans compare exactly.
KeySpec = Union[str, Tuple[str, float]]

BASELINES: Dict[str, List[KeySpec]] = {
    "breakdown.json": [
        "breakdown.firecracker.total",
        "breakdown.reap.total",
        "breakdown.faasnap.total",
        "breakdown.fctiered.total",
        "breakdown.aquifer.total",
        "breakdown.aquifer_perpage.total",
        "hot_preinstall.speedup",
        "speedup_vs_firecracker",
        "speedup_vs_faasnap",
        "restore_bit_identical",
    ],
    "serving_bench.json": [
        "rows.0.modes.per_page.total_modeled_s",
        "rows.0.modes.batched.total_modeled_s",
        "rows.0.modes.batched.preinstall_modeled_s",
        "rows.0.preinstall_speedup",
        "rows.0.total_speedup",
        "all_bit_identical_and_not_slower",
    ],
    "concurrency_bench_quick.json": [
        "rows.0.restore_p50_ms",
        "rows.0.agg_throughput_GBps",
        "rows.1.restore_p50_ms",
        "rows.1.agg_throughput_GBps",
        "rows.2.restore_p50_ms",
        "rows.2.agg_throughput_GBps",
        "rows.3.restore_p50_ms",
        "rows.3.agg_throughput_GBps",
        "criteria.all_bit_identical",
        "criteria.model_within_15pct",
    ],
    "adaptive_bench_quick.json": [
        "adaptive.frozen_first_invocation_s",
        "adaptive.frozen_e2e_s",
        "adaptive.adaptive_e2e_s",
        "adaptive.recovery_x",
        "criteria.recovery_ge_1_3x",
        "criteria.all_restores_bit_identical",
        "criteria.recuration_happened",
        "criteria.capacity_managed",
        # predictive prefetch A/B: paced-drain residual stalls
        # are modeled-deterministic, so ±10% only absorbs real drift
        "prefetch_ab.layout_stall_s",
        "prefetch_ab.predicted_stall_s",
        "prefetch_ab.stall_reduction_x",
        "prefetch_ab.bit_identical",
        "criteria.predicted_stall_cut_ge_2x",
    ],
    "dedup_bench_quick.json": [
        "effective_capacity_x",
        "dedup.unique_byte_ratio",
        "dedup.publish_modeled_s",
        "dedup.restore_modeled_s",
        "dedup.exec_restore_total_s",
        "baseline.publish_modeled_s",
        "criteria.capacity_x_ge_1_5",
        "criteria.all_restores_bit_identical",
        "criteria.i6_consistent",
        "criteria.dedup_worthwhile",
    ],
    # fleet serving (DESIGN.md §14): cold-start tails and hit fractions are
    # discrete-event results on modeled restore costs under a fixed seed —
    # bit-reproducible, so drift means placement/economics actually changed
    "fleet_bench_quick.json": [
        "pod.mean_shared_base_frac",
        "pod.probe_marginal_bytes_total",
        "policies.locality.p50_cold_start_s",
        "policies.locality.p99_cold_start_s",
        "policies.locality.throughput_rps",
        "policies.locality.warm_frac",
        "policies.locality.join_frac",
        "policies.random.p99_cold_start_s",
        "policies.round_robin.p99_cold_start_s",
        "locality_vs_random_p99_x",
        "criteria.locality_vs_random_p99_ge_1_3x",
        "criteria.bit_deterministic",
        "criteria.restores_bit_identical",
        "criteria.profile_matches_restore_model",
        "criteria.all_completed",
    ],
    # multi-pod topology (DESIGN.md §16): same discrete-event determinism as
    # fleet_bench_quick; drift means the replica planner, the fabric
    # surcharge, or the migration-economics gate actually changed
    "fleet_bench_multipod_quick.json": [
        "tiers.single_pod.p99_cold_start_s",
        "tiers.no_replication.p99_cold_start_s",
        "tiers.replicated.p99_cold_start_s",
        "tiers.replicated.p50_cold_start_s",
        "single_vs_replicated_p99_x",
        "replication_plan.replicas_added",
        "replication_plan.skipped_uneconomic",
        "criteria.replicated_beats_single_pod_p99",
        "criteria.replicated_beats_no_replication_p99",
        "criteria.economics_gate_filtered",
        "criteria.bit_deterministic",
        "criteria.restores_bit_identical",
        "criteria.all_completed",
    ],
    # fused data plane (DESIGN.md §13): the modeled keys are roofline byte-
    # math at a canonical workload — deterministic, so drift means the kernel
    # sequence's traffic actually changed; wall-clock keys are never gated
    "kernel_bench.json": [
        "modeled.publish.piecemeal_s",
        "modeled.publish.fused_s",
        "modeled.publish.speedup",
        "modeled.restore.piecemeal_s",
        "modeled.restore.fused_s",
        "modeled.restore.speedup",
        "criteria.bit_identical",
        "criteria.calibration_in_sync",
        "criteria.publish_speedup_ge_2",
        "criteria.restore_speedup_ge_2",
    ],
    # fault tolerance (DESIGN.md §15): all sweeps run under VirtualClock
    # with seeded fault schedules, so every modeled key is bit-reproducible;
    # the overhead key holds the armed fault seam to exactly-zero cost
    "fault_bench_quick.json": [
        "sweeps.none.p50_modeled_ms",
        # exact-zero baseline: any nonzero fresh value is an infinite
        # relative drift, so the armed seam staying free is gated twice
        # (here numerically, below as a boolean criterion)
        "fault_free_overhead_pct",
        "sweeps.rdma_timeouts.p50_modeled_ms",
        "sweeps.rdma_timeouts.total_retries",
        "sweeps.cxl_poison.p50_modeled_ms",
        "sweeps.cxl_poison.total_repairs",
        "sweeps.brownout.p50_modeled_ms",
        "degraded_model.degraded_ms",
        "criteria.fault_free_overhead_zero",
        "criteria.all_bit_identical",
        "criteria.retries_recovered",
        "criteria.repairs_happened",
        "criteria.brownout_degrades_not_fails",
        "criteria.degraded_costs_more",
        "criteria.degraded_model_within_15pct",
    ],
    # the paper's evaluation (Fig. 3, 4, 7): page classes and run lengths are
    # counts over seeded images, the invocation times modeled seconds
    "characterization.json": [
        "average.zero_frac",
        "average.hot_frac",
        "average.cold_frac_of_nonzero",
        *(f"rows.{i}.kernel_bitmap_match" for i in range(9)),
    ],
    "runlength.json": [
        "aggregate.mean_run",
        "aggregate.frac_runs_lt4",
        "aggregate.mean_runs_per_snapshot",
        "rows.0.mmap_over_uffd",
    ],
    "scalability.json": [
        "results.chameleon.aquifer.32",
        "results.chameleon.firecracker.32",
        "hot_preinstall_per_page_vs_batched.chameleon.speedup",
        "geomean_speedups_at_32.vs_firecracker",
        "geomean_speedups_at_32.vs_faasnap",
        "geomean_speedups_at_32.vs_reap",
        "geomean_speedups_at_32.vs_fctiered",
        "geomean_speedups_at_32.vs_reap_excl_ffmpeg",
    ],
}


def get_path(obj, path: str):
    cur = obj
    for part in path.split("."):
        if isinstance(cur, list):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def compare(name: str, baseline: dict, fresh: dict,
            keys: Sequence[KeySpec],
            tolerance: float = DEFAULT_TOLERANCE) -> List[str]:
    """Violation messages for every key that regressed beyond tolerance."""
    violations: List[str] = []
    for spec in keys:
        path, tol = (spec, tolerance) if isinstance(spec, str) else spec
        try:
            base = get_path(baseline, path)
        except (KeyError, IndexError, TypeError):
            violations.append(f"{name}: baseline is missing key {path!r}")
            continue
        try:
            new = get_path(fresh, path)
        except (KeyError, IndexError, TypeError):
            violations.append(f"{name}: fresh run is missing key {path!r}")
            continue
        if isinstance(base, bool) or isinstance(new, bool):
            if bool(base) != bool(new):
                violations.append(
                    f"{name}: {path} flipped {base!r} -> {new!r}")
            continue
        base_f, new_f = float(base), float(new)
        denom = max(abs(base_f), 1e-12)
        rel = abs(new_f - base_f) / denom
        if rel > tol:
            violations.append(
                f"{name}: {path} drifted {rel:+.1%} beyond ±{tol:.0%} "
                f"(baseline {base_f:.6g}, now {new_f:.6g})")
    return violations


def load_baseline(fname: str, baseline_dir: Optional[Path] = None) -> dict:
    """The committed baseline: ``git show HEAD:experiments/torch/<fname>``
    so that a working-tree overwrite cannot mask drift; ``baseline_dir``
    overrides for tests and checkouts without git."""
    if baseline_dir is not None:
        return json.loads((Path(baseline_dir) / fname).read_text())
    proc = subprocess.run(
        ["git", "-C", str(REPO), "show", f"HEAD:experiments/torch/{fname}"],
        capture_output=True, text=True)
    if proc.returncode == 0:
        return json.loads(proc.stdout)
    # no git: the on-disk file (warn: it may have been rewritten)
    path = EXPERIMENTS / fname
    if not path.exists():
        raise FileNotFoundError(
            f"no committed baseline for {fname} (git show failed: "
            f"{proc.stderr.strip()!r}) and {path} does not exist")
    print(f"warning: using working-tree {path} as baseline (not in git)",
          file=sys.stderr)
    return json.loads(path.read_text())


def run_fresh(out_dir: Path = FRESH_OUT) -> Dict[str, dict]:
    """Re-run the quick twins on the CPU, their files written to
    ``out_dir``; returns the results keyed like :data:`BASELINES`."""
    import adaptive_bench
    import breakdown
    import characterization
    import concurrency_bench
    import dedup_bench
    import fault_bench
    import fleet_bench
    import kernel_bench
    import runlength
    import scalability
    import serving_bench

    mods = (adaptive_bench, breakdown, characterization, concurrency_bench, dedup_bench,
            fault_bench, fleet_bench, kernel_bench, runlength, scalability, serving_bench)
    for mod in mods:
        mod.OUT = Path(out_dir)
    cpu = {"device": "cpu"}
    return {
        "breakdown.json": breakdown.run(**cpu),
        "serving_bench.json": serving_bench.run(["chameleon"], **cpu),
        "concurrency_bench_quick.json": concurrency_bench.run(quick=True, **cpu),
        "adaptive_bench_quick.json": adaptive_bench.run(quick=True, **cpu),
        "dedup_bench_quick.json": dedup_bench.run(quick=True, **cpu),
        "kernel_bench.json": kernel_bench.run(quick=True, **cpu),
        "fleet_bench_quick.json": fleet_bench.run(quick=True, **cpu),
        "fleet_bench_multipod_quick.json": fleet_bench.run_multipod(quick=True, **cpu),
        "fault_bench_quick.json": fault_bench.run(quick=True, **cpu),
        "characterization.json": characterization.run(**cpu),
        "runlength.json": runlength.run(**cpu),
        "scalability.json": scalability.run(**cpu),
    }


def check_all(fresh: Dict[str, dict],
              baseline_dir: Optional[Path] = None,
              tolerance: float = DEFAULT_TOLERANCE) -> List[str]:
    violations: List[str] = []
    for fname, keys in BASELINES.items():
        if fname not in fresh:
            violations.append(f"{fname}: no fresh result produced")
            continue
        try:
            baseline = load_baseline(fname, baseline_dir)
        except (FileNotFoundError, json.JSONDecodeError) as e:
            violations.append(f"{fname}: cannot load baseline ({e})")
            continue
        violations.extend(compare(fname, baseline, fresh[fname], keys,
                                  tolerance))
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-run", action="store_true",
                    help="compare the on-disk experiments/torch/*.json instead of "
                         "re-running the quick twins")
    ap.add_argument("--baseline-dir", type=Path, default=None,
                    help="read baselines from this directory instead of "
                         "`git show HEAD:experiments/torch/`")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    args = ap.parse_args(argv)

    if args.no_run:
        fresh = {f: json.loads((EXPERIMENTS / f).read_text())
                 for f in BASELINES if (EXPERIMENTS / f).exists()}
    else:
        fresh = run_fresh()
    violations = check_all(fresh, baseline_dir=args.baseline_dir,
                           tolerance=args.tolerance)
    n_keys = sum(len(k) for k in BASELINES.values())
    if violations:
        print(f"REGRESSION GATE FAILED — {len(violations)} violation(s) "
              f"across {n_keys} checked keys:")
        for v in violations:
            print(f"  ✗ {v}")
        return 1
    print(f"regression gate OK: {n_keys} keys across {len(BASELINES)} "
          f"baselines within ±{args.tolerance:.0%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
