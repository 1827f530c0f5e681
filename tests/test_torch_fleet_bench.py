"""The port's fleet bench (``scripts/fleet_bench.py``) against the JAX
package's (``benchmarks/fleet_bench.py``) on the CPU: both quick runs, the
single-pod policies and the multi-pod tiers, run live through both packages
with every output directory redirected to ``tmp_path`` (no tracked file is
written), must agree key for key (``==``, floats included) with each other
and with the committed ``experiments/fleet_bench_quick.json`` and
``experiments/fleet_bench_multipod_quick.json``."""
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import fleet_bench as twin  # noqa: E402
from benchmarks import fleet_bench as ref_bench  # noqa: E402

CASES = {"single_pod": ("run", "fleet_bench_quick.json"),
         "multipod": ("run_multipod", "fleet_bench_multipod_quick.json")}


def _diff(a, b, path=""):
    """Paths where two JSON values differ (for the failure message)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b), key=str)
                for d in _diff(a.get(k), b.get(k), f"{path}/{k}")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_quick_bench_equals_reference_key_for_key(case, tmp_path, monkeypatch):
    fn, name = CASES[case]
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    walls = {}
    got = getattr(twin, fn)(quick=True, device="cpu", walls=walls)
    want = getattr(ref_bench, fn)(quick=True)
    committed = json.loads((REPO / "experiments" / name).read_text())
    written = json.loads((tmp_path / "port" / name).read_text())
    got = json.loads(json.dumps(got))
    assert got == written
    assert not _diff(got, json.loads(json.dumps(want))), _diff(got, want)
    assert not _diff(got, committed), _diff(got, committed)
    assert all(got["criteria"].values())
    assert {"build_pod", "profile_pod", "verify_restores"} <= set(walls)
    assert sum(k.startswith("drive_") for k in walls) == 4


def test_quick_pod_publishes_shares_and_frees(tmp_path, monkeypatch):
    """The pod itself: every variant resident, base pages shared, the
    sampled restores bit-identical; freeing it returns every pool byte."""
    fleet = twin.synthesize_fleet(24, 6, 500.0, seed=twin.SEED, compute_mean_s=0.25)
    pool, master, images, probes = twin.build_pod(fleet, 48, 24, 16, 4, device="cpu")
    assert len(probes) == 24 and probes[0] > probes[-1] > 0
    assert all(master.catalog.find(f.name).regions.dedup for f in fleet)
    assert twin.verify_restores(pool, master, images, fleet, 4) == (True, 4)
    profiles, err = twin.profile_pod(pool, master, fleet)
    assert err == 0.0 and sum(p.shared_base_bytes > 0 for p in profiles.values()) >= 18
    twin.free_pod(master)
    assert pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0
    assert pool.dedup_cxl.refcounts() == {} and pool.dedup_rdma.refcounts() == {}
