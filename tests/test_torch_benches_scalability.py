"""The port's Fig. 7 twin (``scripts/scalability.py``) against the JAX
package's (``benchmarks/scalability.py``) on the nine workloads, on the
CPU, run live through both packages with both output directories
redirected.  The modeled invocation times follow only which pages are zero,
hot and cold and the invocation's touches, so the port's own parameters
give the reference's numbers; no key is priced by the checksum calibration
(the port's is the card's), so none needs the reference's installed.  Every
key ``==`` the live reference run, the committed reference file
``experiments/scalability.json`` and the committed
``experiments/torch/scalability.json``."""
import json

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import scalability as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import scalability as ref_bench  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402


def test_equals_the_live_reference_and_both_committed_files(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    twin_workloads.clear_cache()
    try:
        with cpu_tally() as launches:
            got = jsonify(twin.run(device="cpu"))
        want = jsonify(ref_bench.run())
    finally:
        twin_workloads.clear_cache()
        ref_workloads._cache.clear()
    assert got == json.loads((tmp_path / "port" / "scalability.json").read_text())
    assert twin.CONCURRENCY == ref_bench.CONCURRENCY == (1, 2, 4, 8, 12, 16, 24, 32)
    assert set(got["results"]["chameleon"]) == {"firecracker", "reap", "faasnap", "fctiered",
                                                "aquifer", "aquifer_perpage"}
    assert not unequal(got, want), unequal(got, want)
    for path in (REPO / "experiments" / "scalability.json",
                 REPO / "experiments" / "torch" / "scalability.json"):
        committed = json.loads(path.read_text())
        assert not unequal(got, committed), (path, unequal(got, committed))
    assert launches == bench_launches("scalability", False)
