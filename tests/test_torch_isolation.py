"""The port stands alone: importing ``repro_torch`` (and the simulator's
scenario library, the bench twins and the training examples' twins) loads
neither ``jax`` nor the JAX package ``repro``, needs no card and no nvcc, and
no file of the port (nor ``chip_smoke.py`` and the scripts it imports)
imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "sim_scenarios.py",
    ROOT / "scripts" / "topology_phase.py", ROOT / "scripts" / "fleet_bench.py",
    ROOT / "scripts" / "fleet_phase.py"] + [
    ROOT / "scripts" / f"{name}.py"
    for name in ("workloads", "dedup_bench", "fault_bench", "adaptive_bench",
                 "concurrency_bench", "breakdown", "serving_bench", "benches_phase",
                 "quickstart", "train_e2e", "train_phase", "moe_phase", "coldstart_phase",
                 "families_phase", "time_flash_stages", "characterization", "runlength",
                 "scalability", "kernel_bench", "run", "check_regressions", "serve_coldstart",
                 "write_calibration", "elastic_restore", "sharding_phase")]


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.interop, repro_torch.kernels.build, repro_torch.configs, "
            "repro_torch.configs.base, repro_torch.configs.shapes, repro_torch.models, "
            "repro_torch.models.transformer, repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.encdec, "
            "repro_torch.models.attention, repro_torch.serve, "
            "repro_torch.kernels.flash_attention, repro_torch.core.failover, "
            "repro_torch.core.profiler, repro_torch.checkpoint, repro_torch.checkpoint.ckpt, "
            "repro_torch.serve.strategies, repro_torch.serve.coldstart, "
            "repro_torch.sim, repro_torch.sim.cluster, repro_torch.topology, "
            "repro_torch.fleet, repro_torch.fleet.driver, repro_torch.fleet.model, "
            "repro_torch.data, repro_torch.sharding, repro_torch.train, repro_torch.tree, "
            "repro_torch.launch.train, repro_torch.launch.serve, repro_torch.roofline, "
            "repro_torch.roofline.analysis, repro_torch.roofline.op_counter, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.sharding.partition, repro_torch.sharding.collectives; "
            "sys.path.insert(0, %r); import sim_scenarios, fleet_bench, workloads, dedup_bench, "
            "fault_bench, adaptive_bench, concurrency_bench, breakdown, serving_bench, "
            "quickstart, train_e2e, characterization, runlength, scalability, kernel_bench, "
            "run, check_regressions, serve_coldstart, elastic_restore, sharding_phase; "
            "repro_torch.configs.base.load_all(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad") % str(ROOT / "scripts")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
