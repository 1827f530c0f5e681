"""Port parity of ``serve/strategies``: with the JAX package's calibration
constants installed, every public function of the port returns exactly
(``==``) what the reference returns — the five restore strategies, batched
and per page, at concurrency 1, 8 and 32 on one workload spec, the
hot pre-install model, the reader-based concurrent and degraded restore
models on the same snapshot, and the dedup, keep-warm, re-curation,
inter-pod and migration economics.  The port's default calibration is its
own file under ``experiments/torch/``: the reference's TPU roofline file is
never read by default."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import TouchEvent as RefTouchEvent
from repro.core import HeatMap as RefHeatMap
from repro.core import plan_recuration as ref_plan
from repro.serve import strategies as ref_s
from repro_torch.core import HeatMap, SnapshotReader, TimeLedger, plan_recuration, TouchEvent
from repro_torch.serve import strategies as s
from test_torch_snapshot import publish_both

ROOT = Path(__file__).resolve().parents[1]
REF_CALIBRATION = ROOT / "experiments" / "kernel_calibration.json"


@pytest.fixture
def ref_calibration(monkeypatch):
    """The port's module constants set from the JAX package's calibration
    file, as the reference loads them at import."""
    cal = s.load_calibration(REF_CALIBRATION)
    for name, value in (("CALIBRATION", cal), ("CHECKSUM_BW", cal["checksum_bw_Bps"]),
                        ("CHECKSUM_PER_PAGE_S", 4096 / cal["checksum_bw_Bps"]),
                        ("PUBLISH_SWEEP_PAGE_S", cal["publish_sweep_page_s"]),
                        ("PREINSTALL_PAGE_S", cal["preinstall_page_s"])):
        monkeypatch.setattr(s, name, value)


@pytest.fixture(scope="module")
def both():
    """One snapshot published by each package and a workload spec over it:
    the profiled working set, and one invocation's touches (zero, hot and
    cold pages, duplicates included)."""
    (img_r, pool_r, reg_r), (img_g, pool_g, reg_g), ws = publish_both(seed=21)
    rng = np.random.default_rng(21)
    touched = rng.choice(img_g.total_pages, 120, replace=True)
    specs = (ref_s.WorkloadSpec("w", img_r, np.asarray(ws), touched, 0.25, scale=37.5),
             s.WorkloadSpec("w", img_g, np.asarray(ws), touched, 0.25, scale=37.5))
    readers = []
    for mod, pool, reg in ((ref_s, pool_r, reg_r), (s, pool_g, reg_g)):
        ledger = (mod.TimeLedger if mod is ref_s else TimeLedger)()
        view = pool.host_view("h", ledger)
        readers.append((mod.SnapshotReader if mod is ref_s else SnapshotReader)(
            reg, view, pool.rdma))
    return {"specs": specs, "readers": readers, "pools": (pool_r, pool_g),
            "regions": (reg_r, reg_g)}


def test_constants_equal_reference(ref_calibration):
    for name in ("HOT_CHUNK_PAGES", "FAULT_TRAP_S", "SNAPSHOT_API_S", "MACHINE_STATE_S",
                 "CXL_LAT_S", "CXL_BW", "RDMA_LAT_S", "RDMA_BW", "CXL_PAGE_READ_S",
                 "RDMA_PAGE_READ_S", "RDMA_INFLIGHT", "DEMAND_FAULT_STALL_S",
                 "PREFETCH_HIT_STALL_S", "INTER_POD_HOP_S", "INTER_POD_LAT_S",
                 "INTER_POD_BW", "INTER_POD_INFLIGHT", "CHECKSUM_BW", "CHECKSUM_PER_PAGE_S",
                 "PUBLISH_SWEEP_PAGE_S", "PREINSTALL_PAGE_S", "WARM_RESUME_S",
                 "KEEPWARM_DISPLACE_INTERVAL_S", "KEEPWARM_BYTE_S_COST"):
        assert getattr(s, name) == getattr(ref_s, name), name
    assert s.STRATEGIES == ref_s.STRATEGIES
    assert s.CALIBRATION == ref_s.CALIBRATION


@pytest.mark.parametrize("conc", [1, 8, 32])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("strategy", ref_s.STRATEGIES)
def test_run_strategy_equals_reference(both, strategy, batched, conc, ref_calibration):
    spec_r, spec_g = both["specs"]
    want = ref_s.run_strategy(strategy, spec_r, concurrency=conc, batched=batched)
    got = s.run_strategy(strategy, spec_g, concurrency=conc, batched=batched)
    assert got.breakdown() == want.breakdown()
    assert (got.strategy, got.setup_s, got.prefetch_s, got.exec_install_s, got.compute_s,
            got.total_s) == (want.strategy, want.setup_s, want.prefetch_s,
                             want.exec_install_s, want.compute_s, want.total_s)
    assert got.stats == want.stats


def test_unknown_strategy_raises(both):
    with pytest.raises(ValueError):
        s.run_strategy("nope", both["specs"][1])


@pytest.mark.parametrize("batched", [True, False])
def test_hot_preinstall_time_equals_reference(both, batched):
    spec_r, spec_g = both["specs"]
    assert s.hot_preinstall_time(spec_g, batched) == ref_s.hot_preinstall_time(spec_r, batched)


@pytest.mark.parametrize("conc", [1, 8, 32])
def test_reader_models_equal_reference(both, conc):
    rd_r, rd_g = both["readers"]
    for kw in ({}, {"max_extent_pages": 5}, {"chunk_pages": 7}):
        assert (s.modeled_concurrent_restore_s(rd_g, conc, **kw)
                == ref_s.modeled_concurrent_restore_s(rd_r, conc, **kw))
    for kw in ({}, {"max_extent_pages": 5}):
        assert (s.modeled_degraded_restore_s(rd_g, conc, **kw)
                == ref_s.modeled_degraded_restore_s(rd_r, conc, **kw))


def test_economics_equal_reference(both, ref_calibration):
    for args in ((0, 0), (3, 0), (0, 7), (120, 45)):
        assert s.residual_stall_s(*args) == ref_s.residual_stall_s(*args)
    for args in ((100, 50, 80, 40), (100, 50, 100, 50), (0, 0, 0, 0)):
        assert s.dedup_publish_cost_s(*args) == ref_s.dedup_publish_cost_s(*args)
        assert s.baseline_publish_cost_s(*args[:2]) == ref_s.baseline_publish_cost_s(*args[:2])
        for kw in ({}, {"n_extra_hot_extents": 3, "n_extra_cold_extents": 9,
                        "expected_restores": 7}):
            assert s.dedup_economics(*args, **kw) == ref_s.dedup_economics(*args, **kw)
    assert s.dedup_restore_penalty_s(4, -2) == ref_s.dedup_restore_penalty_s(4, -2)
    for args in ((0.2, 1.5, 1 << 30), (1e-4, 10.0, 4096), (0.3, 0.0, 0)):
        assert s.keepwarm_economics(*args) == ref_s.keepwarm_economics(*args)
    for args in ((0, 0, 64), (10, 5, 64), (1000, 0, 1), (7, 3, 0)):
        assert s.recuration_benefit_s(*args) == ref_s.recuration_benefit_s(*args)
    for args in ((0, 1), (1000, 8), (65536, 32)):
        assert s.interpod_bulk_read_s(*args) == ref_s.interpod_bulk_read_s(*args)
        assert s.interpod_hot_penalty_s(*args) == ref_s.interpod_hot_penalty_s(*args)
    for args in ((1 << 26, 1 << 28, 50), (4096, 0, 0), (1 << 20, 1 << 20, 3, 8)):
        assert s.migration_economics(*args) == ref_s.migration_economics(*args)


def test_recuration_cost_and_economics_equal_reference(both):
    reg_r, reg_g = both["regions"]
    pool_r, pool_g = both["pools"]
    assert s.recuration_cost_s(reg_g) == ref_s.recuration_cost_s(reg_r)
    hm_r, hm_g = RefHeatMap(reg_r.total_pages, 1e6), HeatMap(reg_g.total_pages, 1e6)
    cold = np.arange(150, 160)
    for hm, ev in ((hm_r, RefTouchEvent), (hm_g, TouchEvent)):
        for _ in range(2):
            hm.record(ev(pages=cold, kind="demand_fault", now=0.0))
            hm.note_restore()
    plan_r = ref_plan(pool_r, reg_r, hm_r)
    plan_g = plan_recuration(pool_g, reg_g, hm_g)
    for n in (1, 64, 100000):
        assert s.recuration_economics(reg_g, plan_g, n) == ref_s.recuration_economics(
            reg_r, plan_r, n)


def test_verify_restore_correctness_on_the_port(both):
    spec_g = both["specs"][1]
    _rd_r, rd_g = both["readers"]
    pool_g = both["pools"][1]
    assert s.verify_restore_correctness(pool_g, rd_g, spec_g) is True


def test_default_calibration_reads_no_reference_file(tmp_path):
    """Importing the port's strategies reads at most its own calibration
    file under experiments/torch/; a missing file leaves the hand-set
    defaults, and a given file's constants are what is loaded."""
    code = (
        "import builtins, io, json, pathlib, sys\n"
        "seen = []\n"
        "real_open, real_io_open = builtins.open, io.open\n"
        "def spy(file, *a, **k):\n"
        "    seen.append(str(file)); return real_open(file, *a, **k)\n"
        "builtins.open = io.open = spy\n"
        "from repro_torch.serve import strategies as s\n"
        "builtins.open, io.open = real_open, real_io_open\n"
        "print(json.dumps({'seen': seen, 'path': str(s.CALIBRATION_PATH),\n"
        "                  'cal': s.CALIBRATION, 'default': s.load_calibration(),\n"
        "                  'missing': s.load_calibration('/nonexistent/cal.json')}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, timeout=120)
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    path = Path(rep["path"])
    assert path == ROOT / "experiments" / "torch" / "kernel_calibration.json"
    for seen in rep["seen"]:
        p = Path(seen).resolve()
        if (ROOT / "experiments") in p.parents:
            assert (ROOT / "experiments" / "torch") in p.parents, seen
    assert rep["cal"] == rep["default"]
    assert rep["missing"] == {"checksum_bw_Bps": 20e9, "publish_sweep_page_s": 2 * 4096 / 20e9,
                              "preinstall_page_s": 2 * 4096 / 20e9}
    assert rep["default"] != s.load_calibration(REF_CALIBRATION)
    mine = tmp_path / "cal.json"
    mine.write_text(json.dumps({"constants": {"checksum_bw_Bps": 1e12}}))
    assert s.load_calibration(mine) == {**rep["missing"], "checksum_bw_Bps": 1e12}
