"""The port's benchmark-regression gate (``scripts/check_regressions.py``),
the twin of ``tests/test_regression_gate.py`` over the committed CPU runs in
``experiments/torch/``: it passes on untouched baselines and within
tolerance, and fails on a key perturbed beyond it, a flipped boolean or a
missing key, without re-running a bench; the CLI's exit codes follow; a
baseline comes from git or from a directory.  Also: every gated file is a
committed twin output and every key resolves in it, the fresh run covers
every gated file with the twins' output redirected, and the bench driver
(``scripts/run.py``) chains its five twins and sums them up."""
import json

import pytest

from test_torch_bench_harness import REPO

import check_regressions as gate  # noqa: E402
from check_regressions import (  # noqa: E402
    BASELINES,
    check_all,
    compare,
    get_path,
    load_baseline,
    main,
)

EXPERIMENTS = REPO / "experiments" / "torch"


def _key_path(k):
    return k if isinstance(k, str) else k[0]


@pytest.fixture()
def disk_results():
    """The committed experiments/torch/*.json of every gated twin."""
    return {fname: json.loads((EXPERIMENTS / fname).read_text()) for fname in BASELINES}


def _set_path(obj, path, value):
    parts = path.split(".")
    cur = obj
    for part in parts[:-1]:
        cur = cur[int(part)] if isinstance(cur, list) else cur[part]
    last = parts[-1]
    if isinstance(cur, list):
        cur[int(last)] = value
    else:
        cur[last] = value


def _first_float_key(fname, data):
    return next(_key_path(k) for k in BASELINES[fname]
                if isinstance(get_path(data, _key_path(k)), float))


def test_gates_the_ports_files_and_the_new_twins_keys(disk_results):
    assert gate.EXPERIMENTS == EXPERIMENTS
    assert {"characterization.json", "runlength.json", "scalability.json",
            "kernel_bench.json", "serving_bench.json"} <= set(BASELINES)
    for fname, keys in BASELINES.items():
        for k in keys:
            get_path(disk_results[fname], _key_path(k))     # every key resolves


def test_get_path_traverses_dicts_and_lists():
    obj = {"rows": [{"a": 1.0}, {"a": 2.0}], "flat": True}
    assert get_path(obj, "rows.1.a") == 2.0
    assert get_path(obj, "flat") is True


def test_gate_passes_on_identical_baselines(disk_results, tmp_path):
    for fname, data in disk_results.items():
        (tmp_path / fname).write_text(json.dumps(data))
    fresh = {f: json.loads(json.dumps(d)) for f, d in disk_results.items()}
    assert check_all(fresh, baseline_dir=tmp_path) == []


def test_gate_passes_within_tolerance(disk_results):
    for fname, data in disk_results.items():
        key = _first_float_key(fname, data)
        baseline = json.loads(json.dumps(data))
        _set_path(baseline, key, get_path(data, key) * 1.05)   # +5% < ±10%
        assert compare(fname, baseline, data, BASELINES[fname]) == []


@pytest.mark.parametrize("factor", [1.2, 0.8])
def test_gate_fails_on_perturbed_numeric_key(disk_results, factor):
    for fname, data in disk_results.items():
        key = _first_float_key(fname, data)
        baseline = json.loads(json.dumps(data))
        _set_path(baseline, key, get_path(data, key) * factor)
        violations = compare(fname, baseline, data, BASELINES[fname])
        assert violations, f"{fname}:{key} perturbed x{factor} must fail"
        assert key in violations[0]


def test_gate_fails_on_flipped_boolean(disk_results):
    flipped = 0
    for fname, data in disk_results.items():
        for k in BASELINES[fname]:
            key = _key_path(k)
            if not isinstance(get_path(data, key), bool):
                continue
            fresh = json.loads(json.dumps(data))
            _set_path(fresh, key, not get_path(data, key))
            violations = compare(fname, data, fresh, BASELINES[fname])
            assert violations and key in violations[0]
            flipped += 1
    assert flipped >= 9 + 4     # characterization's nine bitmaps, kernel_bench's criteria


def test_gate_fails_on_missing_key(disk_results):
    for fname, data in disk_results.items():
        assert compare(fname, data, {}, BASELINES[fname])
        assert compare(fname, {}, data, BASELINES[fname])


def test_cli_no_run_exit_codes(disk_results, tmp_path, monkeypatch):
    """The CLI without re-running a bench: exit 0 on clean baselines, 1
    after a perturbation beyond tolerance."""
    for fname, data in disk_results.items():
        (tmp_path / fname).write_text(json.dumps(data))
    assert main(["--no-run", "--baseline-dir", str(tmp_path)]) == 0
    for fname in ("scalability.json", "kernel_bench.json"):
        data = disk_results[fname]
        key = _first_float_key(fname, data)
        perturbed = json.loads(json.dumps(data))
        _set_path(perturbed, key, get_path(data, key) * 2.0)
        (tmp_path / fname).write_text(json.dumps(perturbed))
        assert main(["--no-run", "--baseline-dir", str(tmp_path)]) == 1
        (tmp_path / fname).write_text(json.dumps(data))


def test_load_baseline_from_git_or_dir(tmp_path):
    (tmp_path / "x.json").write_text('{"a": 1}')
    assert load_baseline("x.json", tmp_path) == {"a": 1}
    # committed files resolve through git show HEAD:experiments/torch/
    committed = load_baseline("breakdown.json")
    assert "breakdown" in committed


def test_run_fresh_covers_every_gated_file_and_redirects_the_twins(monkeypatch, tmp_path,
                                                                   disk_results):
    """Each twin's ``run`` replaced by its committed output: the fresh
    results are keyed like ``BASELINES``, every twin asked for the CPU, and
    every twin's output directory is the one given."""
    import importlib

    names = ("adaptive_bench", "breakdown", "characterization", "concurrency_bench",
             "dedup_bench", "fault_bench", "fleet_bench", "kernel_bench", "runlength",
             "scalability", "serving_bench")
    calls = []
    for name in names:
        mod = importlib.import_module(name)
        for fn in ("run", "run_multipod") if name == "fleet_bench" else ("run",):
            fname = {("fleet_bench", "run_multipod"): "fleet_bench_multipod_quick.json",
                     ("breakdown", "run"): "breakdown.json",
                     ("serving_bench", "run"): "serving_bench.json",
                     ("kernel_bench", "run"): "kernel_bench.json",
                     ("characterization", "run"): "characterization.json",
                     ("runlength", "run"): "runlength.json",
                     ("scalability", "run"): "scalability.json"}.get(
                (name, fn), f"{name}_quick.json")

            def fake(*args, _f=fname, _n=name, **kw):
                calls.append((_n, kw.get("device")))
                return disk_results[_f]

            monkeypatch.setattr(mod, fn, fake)
        monkeypatch.setattr(mod, "OUT", mod.OUT)
    fresh = gate.run_fresh(tmp_path)
    assert set(fresh) == set(BASELINES)
    assert all(dev == "cpu" for _, dev in calls) and len(calls) == len(BASELINES)
    assert all(importlib.import_module(n).OUT == tmp_path for n in names)
    assert check_all(fresh, baseline_dir=EXPERIMENTS) == []


def test_bench_driver_runs_its_five_twins_in_order_and_sums_them_up(monkeypatch, tmp_path,
                                                                   capsys):
    """``scripts/run.py``: each twin's ``main`` on the device given, in the
    paper's order, its file read back into ``bench_summary.json``.  Each
    twin's ``run`` is replaced by its committed CPU output (written where
    the twin writes), so only the driver and the twins' printing run."""
    import importlib

    import run as driver

    order = []
    for name in ("characterization", "runlength", "breakdown", "scalability", "kernel_bench"):
        mod = importlib.import_module(name)
        committed = json.loads((EXPERIMENTS / f"{name}.json").read_text())

        def fake(*args, _mod=mod, _name=name, _data=committed, **kw):
            order.append((_name, kw["device"]))
            (_mod.OUT / f"{_name}.json").write_text(json.dumps(_data))
            return _data

        monkeypatch.setattr(mod, "run", fake)
        monkeypatch.setattr(mod, "OUT", tmp_path)
    assert driver.main(["--device", "cpu"]) == 0
    assert order == [(n, "cpu") for n in ("characterization", "runlength", "breakdown",
                                          "scalability", "kernel_bench")]
    summary = json.loads((tmp_path / "bench_summary.json").read_text())
    assert set(summary) == {"device", "characterization", "runlength", "breakdown",
                            "scalability", "exit_codes", "wall_s"}
    assert summary["exit_codes"] == dict.fromkeys(
        ("characterization", "runlength", "breakdown", "scalability", "kernel_bench"), 0)
    assert summary["scalability"] == json.loads(
        (EXPERIMENTS / "scalability.json").read_text())["geomean_speedups_at_32"]
    assert summary["breakdown"]["restore_bit_identical"] is True
    assert "Fig 7 analogue" in capsys.readouterr().out
