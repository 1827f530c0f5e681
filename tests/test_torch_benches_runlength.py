"""The port's Fig. 4 twin (``scripts/runlength.py``) against the JAX
package's (``benchmarks/runlength.py``) on the nine workloads, on the CPU,
run live through both packages with both output directories redirected.
Run lengths follow only which pages are zero and hot, so the port's own
parameters give the reference's numbers: every key ``==`` the live run
and the committed ``experiments/torch/runlength.json``.

The committed reference file ``experiments/runlength.json`` is off a live
reference run in the last bits of 18 floats, its rows' ``mmap_install_s``
and ``mmap_over_uffd`` (a sum over runs added in another order when it was
written); it is held within 1e-12 relative, and those are the only keys
that differ."""
import json

import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import chip_smoke  # noqa: E402
import runlength as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import runlength as ref_bench  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(twin's run, tally, reference's run), each once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_bench, "OUT", tmp_path_factory.mktemp("ref"))
    out = tmp_path_factory.mktemp("port")
    mp.setattr(twin, "OUT", out)
    twin_workloads.clear_cache()
    try:
        with cpu_tally() as launches:
            got = jsonify(twin.run(device="cpu"))
        assert got == json.loads((out / "runlength.json").read_text())
        yield got, dict(launches), jsonify(ref_bench.run())
    finally:
        mp.undo()
        twin_workloads.clear_cache()
        ref_workloads._cache.clear()


def test_equals_the_live_reference_and_its_committed_file(runs):
    got, launches, want = runs
    assert not unequal(got, want), unequal(got, want)
    committed = json.loads((REPO / "experiments" / "torch" / "runlength.json").read_text())
    assert not unequal(got, committed), unequal(got, committed)
    assert launches == bench_launches("runlength", False)


def test_within_1e12_of_the_committed_reference_file_at_named_keys(runs):
    got, _, _ = runs
    want = json.loads((REPO / "experiments" / "runlength.json").read_text())
    diffs, _, _, inexact = chip_smoke.json_close(got, want)
    assert not diffs, diffs
    for entry in inexact:
        assert entry.split(":")[0].rsplit("/", 1)[1] in ("mmap_install_s", "mmap_over_uffd")
