"""The port's serving bench (``scripts/serving_bench.py``) against the JAX
package's (``benchmarks/serving_bench.py``), on the CPU, run
live through both packages with every output directory redirected to
``tmp_path``.  ``wall_s`` (each restore's wall clock) is not compared.

* On the port's own parameters, without the compressed rows (the twin's
  ``_zstd`` set to None, as on a host without ``zstandard``, which the
  card's is): every key ``==`` the live
  reference run's uncompressed rows and the twin's committed
  ``experiments/torch/serving_bench.json`` (the nine workloads, chameleon
  first), with ``zstd_available`` False; on chameleon alone and on all
  nine, the twin's default.
* The compressed rows' modeled RDMA reads depend on the cold bytes (zstd's
  ratio), and cold pages hold parameters, so they are compared on the
  reference's own parameters (``workloads.build_workload(params=...)``):
  every key ``==``, compressed rows included."""
import json

import numpy as np
import pytest

from test_torch_bench_harness import (REPO, WRAPPERS, bench_launches, cpu_tally, jsonify,
                                      unequal)

import serving_bench as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import serving_bench as ref_bench  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402


@pytest.fixture
def outs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    twin_workloads.clear_cache()
    yield tmp_path
    twin_workloads.clear_cache()


def test_twin_on_its_own_parameters_equals_reference_and_its_committed_file(outs, monkeypatch):
    monkeypatch.setattr(twin, "_zstd", None)
    with cpu_tally() as launches:
        got = jsonify(twin.run(["chameleon"], device="cpu"))
    want = jsonify(ref_bench.run(["chameleon"]))
    assert got == json.loads((outs / "port" / "serving_bench.json").read_text())
    assert got["zstd_available"] is False and got["rows_compressed_cold"] == []
    assert not unequal(got["rows"], want["rows"], skip=("wall_s",))
    committed = json.loads((REPO / "experiments" / "torch" / "serving_bench.json").read_text())
    assert committed["rows"][0]["workload"] == "chameleon"
    assert not unequal(got, {**committed, "rows": committed["rows"][:1]}, skip=("wall_s",))
    assert got["all_bit_identical_and_not_slower"]
    assert launches == dict.fromkeys(WRAPPERS, 0) | {"fused_publish": 1, "page_scatter": 2}


def test_nine_workloads_by_default_equal_the_reference_and_the_committed_file(outs,
                                                                            monkeypatch):
    monkeypatch.setattr(twin, "_zstd", None)
    monkeypatch.setattr(ref_bench, "_zstd", None)
    with cpu_tally() as launches:
        got = jsonify(twin.run(device="cpu"))
    want = jsonify(ref_bench.run())
    ref_workloads._cache.clear()
    assert [r["workload"] for r in got["rows"]] == twin_workloads.all_workloads()
    assert not unequal(got, want, skip=("wall_s",)), unequal(got, want, skip=("wall_s",))
    committed = json.loads((REPO / "experiments" / "torch" / "serving_bench.json").read_text())
    assert not unequal(got, committed, skip=("wall_s",)), unequal(got, committed)
    assert got["all_bit_identical_and_not_slower"]
    assert launches == bench_launches("serving_bench", False)


def test_twin_on_the_references_parameters_equals_it_compressed_rows_included(outs):
    pytest.importorskip("zstandard")
    import jax

    cfg = ref_workloads.get_config("qwen2.5-14b").reduced()
    params = jax.tree.map(np.asarray, ref_workloads.build(cfg).init(jax.random.PRNGKey(0)))
    twin_workloads._cache[("chameleon", "cpu")] = twin_workloads.build_workload(
        "chameleon", device="cpu", params=params)
    got = jsonify(twin.run(["chameleon"], device="cpu"))
    want = jsonify(ref_bench.run(["chameleon"]))
    assert got["zstd_available"] and len(got["rows_compressed_cold"]) == 1
    assert not unequal(got, want, skip=("wall_s",)), unequal(got, want, skip=("wall_s",))
