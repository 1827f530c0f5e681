"""The port's dedup bench (``scripts/dedup_bench.py``) against the JAX
package's (``benchmarks/dedup_bench.py``) on the CPU, at the quick and the
full configurations, run live through both packages with every output
directory redirected to ``tmp_path``.

With the reference's calibration installed, every key is ``==`` (floats
included).  With the port's own (the card's, which the twin reads at
import), the twin's output is ``==`` its committed
``experiments/torch/dedup_bench{,_quick}.json``, and differs from the
reference only in the keys priced by the checksum rate
(``CALIBRATION_KEYS``).  Each run's kernel launches, tallied on the CPU, are
those ``chip_smoke.BENCH_LAUNCHES`` holds the card to."""
import json

import pytest

from test_torch_bench_harness import (REPO, bench_launches, cpu_tally, jsonify, unequal,
                                      use_ref_calibration)

import dedup_bench as twin  # noqa: E402
from benchmarks import dedup_bench as ref_bench  # noqa: E402

# dedup_publish_cost_s hashes at the calibration's checksum rate
CALIBRATION_KEYS = ("/dedup/publish_modeled_s", "/dedup/economics/publish_delta_s",
                    "/dedup/economics/net_s", "/dedup/economics/worthwhile")


@pytest.fixture
def outs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    return tmp_path


def _name(quick):
    return "dedup_bench_quick.json" if quick else "dedup_bench.json"


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_twin_equals_its_committed_file_and_the_reference_but_the_calibration(quick, outs):
    with cpu_tally() as launches:
        got = jsonify(twin.run(quick=quick, device="cpu"))
    want = jsonify(ref_bench.run(quick=quick))
    assert got == json.loads((outs / "port" / _name(quick)).read_text())
    committed = json.loads((REPO / "experiments" / "torch" / _name(quick)).read_text())
    assert not unequal(got, committed), unequal(got, committed)
    assert not unequal(got, want, skip=CALIBRATION_KEYS), unequal(got, want)
    assert all(got["criteria"].values())
    assert launches == bench_launches("dedup_bench", quick)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_twin_equals_reference_key_for_key_under_its_calibration(quick, outs, monkeypatch):
    use_ref_calibration(monkeypatch)
    got = jsonify(twin.run(quick=quick, device="cpu"))
    want = jsonify(ref_bench.run(quick=quick))
    assert not unequal(got, want), unequal(got, want)


def test_fleet_shares_base_pages_and_i6_holds():
    """The dedup pod keeps every variant resident where the baseline
    demotes; its stores hold one copy of the base hot pages."""
    fleet = twin.make_fleet(6, 32, 8, 4, 2, device="cpu")
    ded = twin.run_pod(fleet, (6 // 3) * (2 + 32) * 4096, dedup=True)
    base = twin.run_pod(fleet, (6 // 3) * (2 + 32) * 4096, dedup=False)
    assert ded["resident_full_hot"] == 6 and base["resident_full_hot"] < 6
    assert ded["all_bit_identical"] and base["all_bit_identical"]
    assert ded["pool"].dedup_cxl.unique_pages() == 32 + 6 * 2     # the base once, each delta
    assert twin.i6_spot_check(ded["pool"], ded["master"])
