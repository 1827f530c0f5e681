"""The port's breakdown bench (``scripts/breakdown.py``: chameleon, 32
concurrent restores) against the JAX package's (``benchmarks/breakdown.py``)
on the CPU, run live through both packages with every output directory
redirected to ``tmp_path``.

The twin's chameleon is ``scripts/workloads.py``'s, on the port's own
seeded parameters (not bit-equal to JAX's): every modeled key depends only
on which pages are zero, hot or cold, and on their runs, so the output is
``==`` (floats included) the live reference run, the reference's committed
``experiments/breakdown.json`` and the twin's committed
``experiments/torch/breakdown.json``.  The real restore is bit-identical,
and its kernel launches, tallied on the CPU, are those
``chip_smoke.BENCH_LAUNCHES`` holds the card to."""
import json

import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import breakdown as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import breakdown as ref_bench  # noqa: E402


@pytest.fixture
def fresh_workloads():
    twin_workloads.clear_cache()
    yield
    twin_workloads.clear_cache()


def test_twin_equals_reference_and_both_committed_files(tmp_path, monkeypatch,
                                                       fresh_workloads):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    with cpu_tally() as launches:
        got = jsonify(twin.run(device="cpu"))
    want = jsonify(ref_bench.run())
    assert got == json.loads((tmp_path / "port" / "breakdown.json").read_text())
    assert not unequal(got, want), unequal(got, want)
    for committed in (REPO / "experiments" / "breakdown.json",
                      REPO / "experiments" / "torch" / "breakdown.json"):
        c = json.loads(committed.read_text())
        assert not unequal(got, c), (committed, unequal(got, c))
    assert got["restore_bit_identical"]
    assert got["speedup_vs_firecracker"] > got["speedup_vs_faasnap"] > 1.0
    assert launches == bench_launches("breakdown", False)
