"""The port's fault bench (``scripts/fault_bench.py``) against the JAX
package's (``benchmarks/fault_bench.py``) on the CPU, at the quick and the
full configurations, run live through both packages with every output
directory redirected to ``tmp_path``: every key ``==`` (floats included)
but one, and the twin's output ``==`` its committed
``experiments/torch/fault_bench{,_quick}.json`` but for the same one.

That key is ``sweeps.brownout.total_injected``.  Its brownout rejections
count the CXL reads the pool's circuit breaker lets through, and the
breaker's 2 ms cooldown runs on the wall clock (``make_stack``'s pool takes
no clock, so ``TierHealth`` gets ``REAL_CLOCK``): a slower host half-opens
it more often.  ``test_brownout_rejections_follow_the_wall_clock`` shows it
with the wall clock replaced in both packages.  The count is held to
``chip_smoke.brownout_rejection_bounds``, as on the card.  Each run's kernel launches,
tallied on the CPU, are those ``chip_smoke.BENCH_LAUNCHES`` holds the card
to."""
import itertools
import json

import numpy as np
import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import chip_smoke  # noqa: E402
import fault_bench as twin  # noqa: E402
from benchmarks import fault_bench as ref_bench  # noqa: E402

WALL_CLOCK_KEYS = ("/sweeps/brownout/total_injected",)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_twin_equals_reference_key_for_key(quick, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    name = "fault_bench_quick.json" if quick else "fault_bench.json"
    with cpu_tally() as launches:
        got = jsonify(twin.run(quick=quick, device="cpu"))
    want = jsonify(ref_bench.run(quick=quick))
    assert got == json.loads((tmp_path / "port" / name).read_text())
    assert not unequal(got, want, skip=WALL_CLOCK_KEYS), unequal(got, want)
    committed = json.loads((REPO / "experiments" / "torch" / name).read_text())
    assert not unequal(got, committed, skip=WALL_CLOCK_KEYS), unequal(got, committed)
    assert all(got["criteria"].values()) and got["fault_free_overhead_pct"] == 0.0
    lo, hi = chip_smoke.brownout_rejection_bounds(got["workload"]["n_restores"],
                                                  got["workload"]["hot_pages"])
    for out in (got, want):
        assert lo <= out["sweeps"]["brownout"]["total_injected"] <= hi
    assert launches == bench_launches("fault_bench", quick)


def _fake_wall_clock(monkeypatch, step_s: float) -> None:
    """Both packages' wall clock made to advance ``step_s`` a reading."""
    from repro.core.clock import RealClock as RefRealClock
    from repro_torch.core.clock import RealClock

    for cls in (RealClock, RefRealClock):
        ticks = itertools.count()
        monkeypatch.setattr(cls, "monotonic", lambda self, _t=ticks: next(_t) * step_s)


@pytest.mark.parametrize("step_s", [0.0, 1e-3], ids=["frozen", "ticking"])
def test_brownout_rejections_follow_the_wall_clock(step_s, monkeypatch):
    """Frozen, the breaker never half-opens after its first trip: one
    rejection in the whole sweep.  Ticking half the 2 ms cooldown a reading,
    it half-opens again and again and each probe is rejected.  Both
    packages count alike under each clock, so only the host's speed
    separates their counts."""
    _fake_wall_clock(monkeypatch, step_s)
    counts = []
    for pkg in (twin, ref_bench):
        kw = {"device": "cpu"} if pkg is twin else {}
        img, ws = pkg.make_image(16, 8, 4, **kw)
        row = pkg.run_sweep("brownout", 3, img, ws)
        assert row["n_degraded"] == 3 and row["all_bit_identical"]
        counts.append(row["total_injected"])
    assert counts[0] == counts[1]
    assert counts[0] == 1 if step_s == 0.0 else counts[0] > 3
    if step_s:
        lo, hi = chip_smoke.brownout_rejection_bounds(3, 16)
        assert lo <= counts[0] <= hi


def test_sweep_verifies_every_page_and_frees_the_pool():
    """The twin's own bookkeeping: each restore verifies every hot and cold
    page (the brownout's degraded faults too), and the stack is freed."""
    img, ws = twin.make_image(24, 16, 8, device="cpu")
    for sweep in twin.SWEEPS:
        row = twin.run_sweep(sweep, 2, img, ws)
        assert row["_pages_verified"] == [24 + 16] * 2, sweep
        assert len(row["_wall_s"]) == 2 and row["all_bit_identical"]
    assert twin.strip(row).keys() == {k for k in row if not k.startswith("_")}
    model = twin.degraded_model_ms(img, ws)
    assert model["degraded_ms"] > model["healthy_ms"] > 0
    assert np.isfinite(list(model.values())).all()
