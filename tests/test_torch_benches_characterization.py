"""The port's Fig. 3 twin (``scripts/characterization.py``) against the JAX
package's (``benchmarks/characterization.py``) on the nine workloads, on
the CPU, run live through both packages with both output directories
redirected.  The images are built once for the module.

* On the port's own parameters, without ``zstandard`` (the twin's ``_zstd``
  None, as on the card's machine): every page-class key and the kernel's
  bitmap check ``==`` the reference's, ``cold_zstd_ratio`` absent from
  every row (the average counts 1.0 for it), and the run ``==`` the
  committed ``experiments/torch/characterization.json``.
* On the reference's own parameters (``workloads.build_workload(params=)``),
  with ``zstandard``: every key ``==``, ``cold_zstd_ratio`` included (the
  zstd ratio follows the cold bytes, and cold pages hold parameters)."""
import json

import jax
import numpy as np
import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify, unequal

import characterization as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import characterization as ref_bench  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402

PAGE_CLASS_KEYS = ("workload", "arch", "total_pages", "zero_frac", "hot_frac", "cold_frac",
                   "cold_frac_of_nonzero", "image_mb", "kernel_bitmap_match")


@pytest.fixture(scope="module")
def images():
    """Each workload on the port's own parameters and on the reference's."""
    own, carried = {}, {}
    for name in twin_workloads.all_workloads():
        own[(name, "cpu")] = twin_workloads.build_workload(name, device="cpu")
        cfg = ref_workloads.get_config(ref_workloads.WORKLOADS[name].arch).reduced()
        params = jax.tree.map(np.asarray, ref_workloads.build(cfg).init(jax.random.PRNGKey(0)))
        carried[(name, "cpu")] = twin_workloads.build_workload(name, device="cpu",
                                                               params=params)
    yield own, carried
    twin_workloads.clear_cache()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_bench, "OUT", tmp_path_factory.mktemp("ref"))
    try:
        yield jsonify(ref_bench.run())
    finally:
        mp.undo()
        ref_workloads._cache.clear()


@pytest.fixture
def port_out(tmp_path, monkeypatch):
    monkeypatch.setattr(twin, "OUT", tmp_path)
    return tmp_path


def test_own_parameters_without_zstd_page_classes_equal_the_reference(images, reference,
                                                                      port_out, monkeypatch):
    monkeypatch.setattr(twin, "_zstd", None)
    monkeypatch.setattr(twin_workloads, "_cache", dict(images[0]))
    with cpu_tally() as launches:
        got = jsonify(twin.run(device="cpu"))
    assert got == json.loads((port_out / "characterization.json").read_text())
    assert len(got["rows"]) == len(reference["rows"]) == 9
    for row, want in zip(got["rows"], reference["rows"]):
        assert "cold_zstd_ratio" not in row and "cold_zstd_ratio" in want
        assert {k: row[k] for k in PAGE_CLASS_KEYS} == {k: want[k] for k in PAGE_CLASS_KEYS}
        assert row["kernel_bitmap_match"] is True
    assert got["average"]["cold_zstd_ratio"] == 1.0
    assert not unequal(got["average"], reference["average"], skip=("cold_zstd_ratio",))
    assert got["paper"] == reference["paper"]
    committed = json.loads((REPO / "experiments" / "torch" /
                            "characterization.json").read_text())
    assert not unequal(got, committed), unequal(got, committed)
    assert launches == bench_launches("characterization", False)


def test_references_parameters_every_key_equals_it_zstd_ratio_included(images, reference,
                                                                      port_out, monkeypatch):
    pytest.importorskip("zstandard")
    monkeypatch.setattr(twin_workloads, "_cache", dict(images[1]))
    got = jsonify(twin.run(device="cpu"))
    assert all("cold_zstd_ratio" in r for r in got["rows"])
    assert not unequal(got, reference), unequal(got, reference)
