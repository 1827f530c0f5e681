"""The port's serve_coldstart twin (``scripts/serve_coldstart.py``)
against the JAX package's example (``examples/serve_coldstart.py``) at
``--quick`` (pyaes: xlstm-125m, concurrency 8, 2 tokens), on the CPU.

* The strategy table (image, scale, the five modeled strategies, the
  speedups) is the reference's printout line for line, on the port's own
  parameters: it follows only the image's page classes.
* On the reference's parameters (``jax`` init of the same reduced config,
  carried by ``interop``), the warm restore pre-installs as many hot pages
  and takes as many async RDMA cold faults as the reference's, and serves
  the reference's tokens.  The times to hot and to full are wall clocks and
  are not compared."""
import importlib.util
import re

import jax
import numpy as np
import pytest

from test_torch_bench_harness import REPO

import serve_coldstart as twin  # noqa: E402
import workloads as twin_workloads  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402


def _reference_example():
    """``examples/serve_coldstart.py`` under a name of its own (the twin
    holds ``serve_coldstart``)."""
    spec = importlib.util.spec_from_file_location(
        "examples_serve_coldstart_reference", REPO / "examples" / "serve_coldstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_printout():
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _reference_example().main(["--quick"])
    finally:
        ref_workloads._cache.clear()
    return buf.getvalue().splitlines()


def _table(lines):
    start = next(i for i, line in enumerate(lines) if line.startswith("workload="))
    end = next(i for i, line in enumerate(lines) if line.startswith("Aquifer speedup"))
    return lines[start:end + 1]


def _restore(lines):
    warm = next(line for line in lines if line.startswith("warm restore:"))
    pre, rdma = re.search(r"pre-installed (\d+) hot pages, (\d+) async RDMA", warm).groups()
    tokens = next(line for line in lines if line.startswith("served tokens:"))
    return int(pre), int(rdma), tokens.split(":", 1)[1].strip()


def test_strategy_table_is_the_references_printout(reference_printout, capsys):
    try:
        assert twin.main(["--quick", "--device", "cpu"]) == 0
    finally:
        twin_workloads.clear_cache()
    lines = capsys.readouterr().out.splitlines()
    assert _table(lines) == _table(reference_printout)
    assert len(_table(lines)) == 11 and "served tokens:" in lines[-1]


def test_references_parameters_restore_and_serve_the_references_tokens(reference_printout):
    cfg = ref_get_config("xlstm-125m").reduced(vocab=512)
    params = jax.tree.map(np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))
    try:
        out = twin.run(quick=True, device="cpu", params=params)
    finally:
        twin_workloads.clear_cache()
    pre, rdma, tokens = _restore(reference_printout)
    inst = out["stats"]["instance"]
    assert (inst["pre_installed"], inst["fault_rdma"]) == (pre, rdma)
    assert str(out["tokens"][0].tolist()) == tokens
    assert (out["workload"], out["concurrency"], out["arch"]) == ("pyaes", 8, "xlstm-125m")
