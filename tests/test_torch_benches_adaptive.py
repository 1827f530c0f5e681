"""The port's adaptive bench (``scripts/adaptive_bench.py``) against the JAX
package's (``benchmarks/adaptive_bench.py``) on the CPU, at the quick and
the full configurations, run live through both packages with every output
directory redirected to ``tmp_path``: every key ``==`` (floats included),
the twin's output ``==`` its committed
``experiments/torch/adaptive_bench{,_quick}.json``, every criterion true,
and each run's kernel launches, tallied on the CPU, those
``chip_smoke.BENCH_LAUNCHES`` holds the card to."""
import json

import numpy as np
import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import adaptive_bench as twin  # noqa: E402
from benchmarks import adaptive_bench as ref_bench  # noqa: E402


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_twin_equals_reference_key_for_key(quick, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    name = "adaptive_bench_quick.json" if quick else "adaptive_bench.json"
    with cpu_tally() as launches:
        got = jsonify(twin.run(quick=quick, device="cpu"))
    want = jsonify(ref_bench.run(quick=quick))
    assert got == json.loads((tmp_path / "port" / name).read_text())
    assert not unequal(got, want), unequal(got, want)
    committed = json.loads((REPO / "experiments" / "torch" / name).read_text())
    assert not unequal(got, committed), unequal(got, committed)
    assert all(got["criteria"].values())
    assert launches == bench_launches("adaptive_bench", quick)


def test_drift_image_sets_are_the_references():
    """The drift image's page sets and offline working set, page for page."""
    img, ws, sets = twin.make_drift_image(scale=1, device="cpu")
    rimg, rws, rsets = ref_bench.make_drift_image(scale=1)
    assert np.array_equal(img.buf.numpy(), rimg.buf) and np.array_equal(ws, rws)
    assert sets.keys() == rsets.keys()
    assert all(np.array_equal(sets[k], rsets[k]) for k in sets)
