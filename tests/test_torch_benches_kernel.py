"""The port's kernel bench (``scripts/kernel_bench.py``) and roofline
(``repro_torch.roofline.analysis``) against the JAX package's
(``benchmarks/kernel_bench.py``, ``repro.roofline.analysis``), on the CPU.

* The roofline holds the H100's rates, ``chip_smoke.py`` takes its roof
  from it with the bounds unchanged, ``movement_roofline`` gives the
  reference's keys, and the two XLA-HLO readers raise naming ROADMAP A12.
* The modeled section: the piecemeal bytes are the reference's, the fused
  bytes are what the port's kernels move (``chip_smoke.publish_bound`` and
  ``restore_rows_bytes``), which differ from the TPU kernels' by the flags,
  addresses and counts the module's ``FUSED_TRAFFIC_VS_TPU`` names; both
  fused forms stay 2x under their piecemeal sequences at the H100's roof.
* The calibration derived here is the committed
  ``experiments/torch/kernel_calibration.json`` byte for byte, and
  ``calibration_in_sync`` holds against ``serve/strategies.py``.
* The measured section runs the plain versions on the CPU: fused and
  piecemeal agree bit for bit, and the CPU tally of the launches is
  ``chip_smoke.BENCH_LAUNCHES``' for both tiers."""
import json

import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify

import chip_smoke  # noqa: E402
import kernel_bench as twin  # noqa: E402
from benchmarks import kernel_bench as ref_bench  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

CALIBRATION = REPO / "experiments" / "torch" / "kernel_calibration.json"
PAGE = 4096


@pytest.fixture
def outs(tmp_path, monkeypatch):
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    return tmp_path


def test_roofline_holds_the_h100_rates_and_the_smoke_takes_them():
    assert (analysis.HBM_BW, analysis.PEAK_FLOPS, analysis.PEAK_32BIT_OPS) == \
        (3.35e12, 989e12, 67e12)
    assert chip_smoke.HBM_BYTES_PER_S is analysis.HBM_BW
    assert chip_smoke.BF16_FLOPS_PER_S is analysis.PEAK_FLOPS
    assert chip_smoke.F32_FLOPS_PER_S is chip_smoke.INT32_OPS_PER_S is analysis.PEAK_32BIT_OPS
    # the bounds keep their values
    assert chip_smoke.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert chip_smoke.bound_ms(0, 67e9) == (1.0, "operations")
    assert chip_smoke.publish_bound(393216, 157286)[:2] == chip_smoke.bound_ms(
        chip_smoke.publish_bound(393216, 157286)[2], 3 * 393216 * 1024)


def test_flash_bounds_keep_their_values():
    import torch

    q = torch.zeros(1, 24, 8192, 128, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 8, 8192, 128, dtype=torch.bfloat16)
    pairs = chip_smoke.flash_pairs(1, 24, 8192, 8192, True)
    t, by, ops, nbytes = chip_smoke.flash_bound_ms(q, k, v, True)
    assert (by, ops) == ("operations", 2 * 256 * pairs) and t == ops / 989e12 * 1e3
    t, by, ops, _ = chip_smoke.flash_bwd_bound_ms(q.float(), k.float(), v.float(), True)
    assert (by, ops) == ("operations", (6 * 128 + 4 * 128) * pairs) and t == ops / 67e12 * 1e3


@pytest.mark.parametrize("flops", [0.0, 1e9])
def test_movement_roofline_has_the_references_keys(flops):
    got = analysis.movement_roofline("x", 4096.0 * 1000, 4.0 * 1000, flops=flops)
    want = ref_analysis.movement_roofline("x", 4096.0 * 1000, 4.0 * 1000, flops=flops)
    assert list(got) == list(want)
    assert got["memory_s"] == (4096.0 + 4.0) * 1000 / 3.35e12
    assert got["compute_s"] == flops / 67e12
    same_bw = analysis.movement_roofline("x", 4096.0, 4.0, bw=ref_analysis.HBM_BW)
    assert same_bw == ref_analysis.movement_roofline("x", 4096.0, 4.0)


def test_hlo_readers_raise_naming_a12():
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        analysis.parse_collective_bytes("")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        analysis.analyze(None, 1)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_model_flops_for_is_the_references(arch):
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.shapes import SHAPES as REF_SHAPES

    cfg, ref_cfg = port_base.get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        assert analysis.model_flops_for(cfg, shape) == \
            ref_analysis.model_flops_for(ref_cfg, REF_SHAPES[name])
    terms = analysis.RooflineTerms(1e12, 1e9, 0.0, {}, 1, 1.0, 2.0, 0.0, model_flops=5e11)
    ref_terms = ref_analysis.RooflineTerms(1e12, 1e9, 0.0, {}, 1, 1.0, 2.0, 0.0,
                                           model_flops=5e11)
    assert terms.to_dict() == ref_terms.to_dict() and terms.dominant == "memory"


def test_piecemeal_bytes_are_the_references_and_fused_bytes_the_ports_kernels():
    n, hot, cold, m = twin.MODEL_N, twin.MODEL_HOT, twin.MODEL_COLD, twin.MODEL_CHUNK
    pm, fused = twin.publish_traffic(n, hot, cold)
    rpm, rfused = ref_bench.publish_traffic(n, hot, cold)
    assert pm == rpm
    assert sum(fused) == chip_smoke.publish_bound(n, hot + cold)[2]
    # the port's publish reads a working-set flag a page and the poly32
    # weights, and writes a zero flag and a checksum a page and two counts,
    # where the TPU kernel's count is 8 bytes written a page
    assert (fused[0] - rfused[0], fused[1] - rfused[1]) == (n + PAGE, 5 * n + 8 - 8 * n)
    pm, fused = twin.restore_traffic(m)
    rpm, rfused = ref_bench.restore_traffic(m)
    assert pm == rpm
    assert sum(fused) == chip_smoke.restore_rows_bytes(m)
    # a row's address, destination and expected checksum read, its bad flag
    # written, and the mismatch count
    assert (fused[0] - rfused[0], fused[1] - rfused[1]) == (20 * m, m + 4)
    modeled = twin.modeled_section()
    assert set(modeled["fused_traffic_vs_tpu"]) == {"publish", "restore"}


def test_modeled_section_at_the_h100_roof():
    got = twin.modeled_section()
    want = ref_bench.modeled_section()
    assert got["workload"] == {**want["workload"], "hbm_bw_Bps": 3.35e12}
    for op in ("publish", "restore"):
        assert got[op]["speedup_ge_2"] is True and got[op]["speedup"] >= 2.0
        assert list(got[op]) == list(want[op])
        for g, w in zip(got[op]["piecemeal_ops"], want[op]["piecemeal_ops"]):
            assert (g["name"], g["bytes_read"], g["bytes_written"]) == \
                (w["name"], w["bytes_read"], w["bytes_written"])
            assert g["bound_s"] == g["bytes_total"] / 3.35e12


def test_calibration_is_the_committed_file_byte_for_byte():
    text = CALIBRATION.read_text()
    cal = twin.calibration_section(twin.modeled_section(), json.loads(text)["card"])
    assert json.dumps(cal, indent=2) + "\n" == text
    assert twin.calibration_in_sync(cal)


def test_calibration_in_sync_flips_when_the_traffic_changes(monkeypatch):
    from repro_torch.serve import strategies

    cal = twin.calibration_section(twin.modeled_section())
    monkeypatch.setattr(strategies, "PREINSTALL_PAGE_S", strategies.PREINSTALL_PAGE_S * 1.01)
    assert not twin.calibration_in_sync(cal)


@pytest.mark.parametrize("quick", [True, False])
def test_run_on_the_cpu_criteria_launches_and_committed_file(outs, quick):
    with cpu_tally() as launches:
        got = jsonify(twin.run(quick=quick, device="cpu"))
    assert got == json.loads((outs / "port" / "kernel_bench.json").read_text())
    assert got["config"] == {"tier": "quick" if quick else "full", "backend": "cpu"}
    assert got["criteria"] == {"bit_identical": True, "calibration_in_sync": True,
                               "publish_speedup_ge_2": True, "restore_speedup_ge_2": True}
    assert launches == bench_launches("kernel_bench", quick)
    me = got["measured"]
    assert (me["n_pages"], me["chunk_pages"], me["reps"]) == ((64, 16, 2) if quick
                                                              else (8192, 2048, 5))
    assert [r["kernel"] for r in me["per_kernel"]] == [
        "zero_detect", "page_checksum", "page_gather", "page_scatter", "publish_piecemeal",
        "publish_fused", "restore_piecemeal", "restore_fused"]
    assert all(r["modeled_s"] == r["bytes"] / 3.35e12 for r in me["per_kernel"])
    committed = json.loads((REPO / "experiments" / "torch" / "kernel_bench.json").read_text())
    assert committed["config"] == {"tier": "full", "backend": "cpu"}
    assert got["modeled"] == committed["modeled"] and got["criteria"] == committed["criteria"]
