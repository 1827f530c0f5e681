"""Run one cell of the benchmark on the card and print its result line.

    python3 aqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``src/repro_torch``).
The cell's configuration, traffic mix and metrics are found by name from
``BENCHMARK.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with a trace
``breakdown``, and last ``checks``: every number compared with its limit,
also printed as the last lines of standard error.

``--control unverified`` (restores install without checking the publish's
checksums, so the planted corrupt page is installed) or ``--control
nodedup`` (new versions published without the content-addressed stores)
run the program with one of its guarantees switched off: such a run must
come out not correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is banned (``repro_torch``
    is the port, and allowed)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def fail(msg: str, code: int = 2) -> None:
    print(f"aqbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("", "unverified", "nodedup"), default="")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port is not in this checkout ({ROOT / 'src' / 'repro_torch'} is missing)")
    # every cache the program or torch writes stays inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    import torch

    from aqbench import harness
    from aqbench.trace import percentile

    bench = harness.load_benchmark(ROOT)
    cell = harness.find(bench, "workloads", args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
    torch.set_num_threads(2)
    cfg = harness.load_config(bench, cell["config"], ROOT)
    mix = harness.load_mix(cell["traffic"])
    wanted = harness.cell_metrics(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: harness.load_reader(m["name"]) for m in wanted}

    rec = harness.run(cell["name"], cfg, mix, args.seed, args.seconds, bool(args.trace),
                      device="cuda", control=args.control, t_start=T_START)

    metrics = {}
    for m in wanted:
        value = readers[m["name"]](rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": harness.passed(rec["checks"]) and not rec["errors"],
           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "device": device}
    if args.trace:
        tr = rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = rec["checks"]
    for err in rec["errors"]:
        print(err, file=sys.stderr)
    found = banned_modules()
    if found:
        fail(f"modules of the JAX package or JAX are loaded: {found}", 3)
    for name, xs in rec["seconds"].items():
        if xs:
            print(f"span {name}: n={len(xs)} sum={sum(xs):.4f} s "
                  f"p50={percentile(xs, 50) * 1e3:.3f} ms p90={percentile(xs, 90) * 1e3:.3f} ms "
                  f"max={max(xs) * 1e3:.3f} ms", file=sys.stderr)
    print(f"done {rec['done']:.4f} in {rec['window_s']} s; counters {rec['counters']}",
          file=sys.stderr)
    print(f"host {json.dumps(rec['host'])}; setup {rec['setup_s']:.3f} s; "
          f"check {rec['check_s']:.3f} s", file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
