"""The port's dry run and op counter against the JAX package's
``launch/dryrun.py``, ``roofline/hlo_analyzer.py`` and
``roofline/analysis.py``, on the CPU.

* the op counter on the reference's two fixtures (test_extensions.py's
  TestHLOAnalyzer): a loop of ten (64, 64) products and tanh counted as a
  Python loop and unrolled (the port runs every scan as a Python loop):
  within 5% of each other and within 20% of 10 · 2 · 64³; an all-reduce of
  f32[128, 128] on a 4-rank fake mesh: exactly 128 · 128 · 4 bytes;
* ``lower_cell`` on three reduced cells (a dense ``train_4k``, a MoE
  ``decode_32k``, a dense ``prefill_32k``) on a 2x2 mesh against the
  reference's on a 2x2 mesh of CPU devices (run in a subprocess by
  ``torch_dryrun_reference.py``): ``model_flops`` ``==``,
  ``flops_per_device`` within 10%, ``argument_bytes`` ``==`` but for the
  decode's position, which the reference passes as an int32 array (4 B) and
  the port as a Python int (ROADMAP §C);
* the depth weighting: a 3-layer trace equals the 1- and 2-layer traces
  extrapolated, the collective bytes exactly, the flops within 0.5%
  and the bytes within 5% (DTensor lays some stacked-layer buffers over a
  mesh dim, and rank 0 counts an uneven shard's larger part);
* ``main`` records a failing cell as ``"error"`` and returns 1.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro.roofline import analysis as janalysis
from repro.roofline.hlo_analyzer import analyze_hlo
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.roofline import analysis
from repro_torch.roofline.op_counter import OpCounter

ROOT = Path(__file__).resolve().parents[1]

# full widths cut to 2 layers and a 512-token vocabulary (the products then
# outweigh the elementwise work, whose count differs most between XLA's
# fused program and eager torch); the MoE cell narrowed further
CELLS = [
    ("phi4-mini-3.8b", "train_4k", {"n_layers": 2, "vocab": 512}),
    ("olmoe-1b-7b", "decode_32k", {"n_layers": 2, "d_model": 512, "n_heads": 4,
                                   "n_kv_heads": 4, "d_ff": 512, "d_ff_expert": 256,
                                   "n_experts": 8, "top_k": 2, "vocab": 512, "d_head": 128}),
    ("qwen2.5-14b", "prefill_32k", {"n_layers": 2, "vocab": 512}),
]


def test_counter_scan_equals_unroll():
    def body(c, w):
        return torch.tanh(c @ w)

    x = torch.zeros((64, 64))
    w = torch.zeros((64, 64))
    with OpCounter() as scan:
        c = x
        for _ in range(10):
            c = body(c, w)
    with OpCounter() as unroll:
        c = torch.tanh(x @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
        c = torch.tanh(c @ w)
    rs, ru = scan.record(), unroll.record()
    assert rs["flops"] == pytest.approx(ru["flops"], rel=0.05)
    # 10 x 2*64^3 matmul flops dominate
    assert ru["flops"] == pytest.approx(10 * 2 * 64**3, rel=0.2)
    assert set(analyze_hlo("").keys()) <= set(rs)


def test_counter_collective_bytes():
    """A Partial -> Replicate redistribution on a 4-rank fake mesh is one
    all-reduce of the local f32[128, 128]: its operand bytes, by kind."""
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
        t = DTensor.from_local(torch.empty(128, 128, device="meta"), mesh, [Partial()])
        with OpCounter(device="meta") as c:
            t.redistribute(mesh, [Replicate()])
    r = c.record()
    assert r["coll_all-reduce"] == 128 * 128 * 4
    assert r["collective_bytes"] == 128 * 128 * 4
    assert analysis.parse_collective_bytes(r) == {
        "all-reduce": 128 * 128 * 4, "all-gather": 0, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0}


def test_analyze_fills_the_reference_terms():
    """``analyze`` gives the reference's ``RooflineTerms`` fields from a
    counter record; the XLA cost-analysis fields stay 0."""
    rec = {"flops": 2e12, "bytes": 3e9, "collective_bytes": 4e8, "peak_live_bytes": 0.0,
           "ops": 1.0, **{f"coll_{k}": 1e8 for k in ("all-reduce", "all-gather",
                                                    "reduce-scatter", "all-to-all")},
           "coll_collective-permute": 0.0}
    t = analysis.analyze(rec, chips=4, model_flops=6e12)
    ref = janalysis.RooflineTerms(2e12, 3e9, 4e8, {}, 4, 0.0, 0.0, 0.0)
    assert set(t.to_dict()) == set(ref.to_dict())
    assert t.compute_s == 2e12 / analysis.PEAK_FLOPS and t.memory_s == 3e9 / analysis.HBM_BW
    assert t.collective_s == 4e8 / analysis.LINK_BW
    assert t.useful_flops_fraction == 6e12 / (2e12 * 4)
    assert t.xla_cost_analysis_flops == 0.0 and t.xla_cost_analysis_bytes == 0.0


@pytest.fixture(scope="module")
def cells():
    """``(reference, port)`` results by (arch, shape): the reference's
    subprocess runs while the port traces its cells."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dryrun_reference.py"),
                             json.dumps(CELLS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        with fake_world(4):
            mesh = make_host_mesh(2, 2, device="cpu")
            port = {(a, s): dryrun.lower_cell(a, s, False, verbose=False, overrides=o,
                                              mesh=mesh) for a, s, o in CELLS}
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = {(r["arch"], r["shape"]): r for r in json.loads(out.strip().splitlines()[-1])}
    return ref, port


@pytest.mark.parametrize("arch,shape_name", [(a, s) for a, s, _ in CELLS])
def test_lower_cell_matches_reference(arch, shape_name, cells):
    ref, port = cells[0][(arch, shape_name)], cells[1][(arch, shape_name)]
    assert ref["status"] == port["status"] == "ok"
    assert port["chips"] == ref["chips"] == 4
    assert set(port["memory"]) == set(ref["memory"])
    assert port["compile_s"] == 0.0 and port["lower_s"] > 0
    assert port["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert port["roofline"]["flops_per_device"] == pytest.approx(
        ref["roofline"]["flops_per_device"], rel=0.10)
    pos_bytes = jnp.dtype(jnp.int32).itemsize if shape_name.startswith("decode") else 0
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"] - pos_bytes
    assert port["memory"]["peak_bytes"] == (port["memory"]["argument_bytes"]
                                            + port["memory"]["temp_bytes"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_depth_weighting_matches_deeper_traces(kind):
    """A 3-layer trace against the 1- and 2-layer ones extrapolated:
    collective bytes ``==``, flops within 0.5%, bytes within 5%."""
    cfg = get_config("qwen2.5-14b").reduced(vocab=512)
    shape = ShapeSpec("tiny", 64, 4, kind)
    with fake_world(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        r = {d: dryrun.trace(dryrun.at_depth(cfg, d), shape, mesh)[0] for d in (1, 2, 3)}
    ex = dryrun._extrapolate(r[1], r[2], 3)
    assert ex["collective_bytes"] == r[3]["collective_bytes"]
    assert ex["flops"] == pytest.approx(r[3]["flops"], rel=0.005)
    assert ex["bytes"] == pytest.approx(r[3]["bytes"], rel=0.05)
    assert dryrun.depth_units(dataclasses.replace(cfg, n_layers=7)) == 7


def test_main_records_each_cell(monkeypatch, tmp_path):
    """``main`` writes one JSON per cell; a cell that raises is recorded as
    ``"error"`` with its exception and makes ``main`` return 1; ``--list``
    prints the grid."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    real = dryrun.lower_cell

    def lower_cell(arch, shape, multi_pod, **kw):
        if shape == "prefill_32k":
            raise RuntimeError("no sharding rule")
        return real(arch, shape, multi_pod, **kw)

    monkeypatch.setattr(dryrun, "lower_cell", lower_cell)
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k"]) == 0
    ok = json.loads((tmp_path / "phi4-mini-3.8b__decode_32k__pod.json").read_text())
    assert ok["status"] == "ok" and ok["chips"] == 256
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert ok["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "prefill_32k",
                        "--multipod"]) == 1
    err = json.loads((tmp_path / "phi4-mini-3.8b__prefill_32k__multipod.json").read_text())
    assert err["status"] == "error" and err["error"] == "RuntimeError: no sharding rule"
    assert dryrun.main(["--list"]) == 0
