"""The benchmark's harness at a tiny size on the CPU: every file found by
name, every cell correct, every planted fault and both controls caught, the
rooflines' byte counts, and no JAX in what ``run.py`` loads."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aqbench import harness, reference, roofline
from aqbench.tests.conftest import ROOT, load_kept_config, run_tiny, tiny_cell

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAFFIC = sorted(p.stem for p in (ROOT / "aqbench" / "traffic").glob("*.json"))


# the mixes kept for later cells whose operation no cell runs, each on the
# configuration kept for it (``configs/``, not in ``BENCHMARK.json``)
KEPT = {"deploy": "fleet24-dedup"}
# the readers kept with them: the end-to-end one first, then the per-layer
KEPT_READERS = {"deploy": ["publishes_per_s", "publish_ms.p50", "decide_share",
                           "cxl_bytes_per_image_byte.deploy", "pool_bytes_per_image_byte.deploy",
                           "fused_publish_roofline", "device_idle.deploy"]}


def _cell_for(traffic: str) -> str:
    """A cell whose configuration the mix runs on: its own, or the first
    with the same operation, or else the configuration kept for the mix."""
    op = harness.load_mix(traffic)["op"]
    for w in BENCH["workloads"]:
        if w["traffic"] == traffic:
            return w["name"]
    return next((w["name"] for w in BENCH["workloads"]
                 if harness.load_mix(w["traffic"])["op"] == op), KEPT.get(traffic))


# every mix on a configuration: the cells, and the mixes kept for later cells
RUNS = [(_cell_for(t), t) for t in TRAFFIC]
RESTORES = [(c, t) for c, t in RUNS if harness.load_mix(t)["op"] == "coldstart"]
DEPLOY, DEPLOY_MIX = next((c, t) for c, t in RUNS if harness.load_mix(t)["op"] == "deploy")


def test_every_file_is_found_by_name():
    for cfg in BENCH["configs"]:
        got = harness.load_config(BENCH, cfg["name"])
        assert got["name"] == cfg["name"]
        assert cfg["file"].startswith(BENCH["paths"][0] + "/")
        assert hasattr(harness.load_module("images", got["images"]), "Images")
    for name in KEPT.values():
        got = load_kept_config(name)
        assert got["name"] == name
        assert hasattr(harness.load_module("images", got["images"]), "Images")
    for t in TRAFFIC:
        assert hasattr(harness.load_module("ops", harness.load_mix(t)["op"]), "Op")
    for w in BENCH["workloads"]:
        names = [m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)]
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    assert harness.reader_file("device_idle.deploy") == "device_idle"
    assert harness.reader_file("attach_ms.p50") == "attach_ms.p50"
    with pytest.raises(FileNotFoundError):
        harness.reader_file("no_such_metric.p50")


def test_a_config_with_other_pages_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    cfg = dict(harness.load_config(BENCH, bench["configs"][0]["name"]), page_bytes=8192)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    bench["configs"][0]["file"] = "c.json"
    with pytest.raises(ValueError):
        harness.load_config(bench, cfg["name"], root=tmp_path)


@pytest.mark.parametrize("cell,traffic", RUNS)
def test_mix_is_correct(cell, traffic):
    rec = run_tiny(cell, trace=True, traffic=traffic)
    assert rec["failed"] == 0 and not rec["errors"], rec["errors"]
    assert rec["done"] > 0
    assert harness.passed(rec["checks"]), rec["checks"]
    # every metric of the cell reads; the device's wait for a card
    for m in harness.cell_metrics(BENCH, cell, False):
        assert harness.load_reader(m["name"])(rec) > 0
    for m in harness.cell_metrics(BENCH, cell, True):
        v = harness.load_reader(m["name"])(rec)
        assert v is None or v >= 0
    kept = KEPT_READERS.get(traffic, []) if cell == KEPT.get(traffic) else []
    for i, name in enumerate(kept):
        v = harness.load_reader(name)(rec)
        assert (v > 0) if i == 0 else (v is None or v >= 0)


def test_the_seed_draws_layouts_bytes_and_targets():
    cfg, mix = tiny_cell(CELLS[0])
    from aqbench import gen

    a = gen.make_image(2048, cfg["page_mix"], 12345, "cpu")
    b = gen.make_image(2048, cfg["page_mix"], 12345, "cpu")
    c = gen.make_image(2048, cfg["page_mix"], 12346, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])          # another layout
    picks = [[gen.Picks(16, "zipf", 1.1, s, 0).next() for _ in range(50)] for s in (1, 1, 2)]
    assert picks[0] == picks[1] != picks[2]


def test_the_page_mix_is_read():
    from aqbench import gen

    mix = {"zero_region_mean_pages": 96, "cold_region_mean_pages": 55,
           "hot_run_mean_pages": 5, "hot_share": 0.057}
    buf, hot = gen.make_image(16384, mix, 7, "cpu")
    zero = ~buf.view(-1, 4096).any(dim=1).bool()
    assert 0.5 < float(zero.float().mean()) < 0.7
    buf, hot = gen.make_image(16384, dict(mix, zero_region_mean_pages=10, hot_share=0.2), 7, "cpu")
    zero = ~buf.view(-1, 4096).any(dim=1).bool()
    assert float(zero.float().mean()) < 0.3 and float(hot.float().mean()) > 0.12


def test_same_seed_same_images():
    cfg, _ = tiny_cell(DEPLOY, DEPLOY_MIX)
    a = harness.Deployment(cfg, 12345, "cpu")
    b = harness.Deployment(cfg, 12345, "cpu")
    for f in range(a.n_fn):
        assert torch.equal(a.image(f, 3)[0], b.image(f, 3)[0])
    assert not torch.equal(a.image(0, 1)[0], a.image(0, 2)[0])


def _corrupt_after(monkeypatch, cls, method, corrupt):
    orig = getattr(cls, method)

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        corrupt(self)
        return out

    monkeypatch.setattr(cls, method, wrapped)


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_flipped_byte_in_a_restored_page_fails(cell, traffic, monkeypatch):
    from repro_torch.core import RestoreEngine

    def flip(engine):
        page = int(engine.reader.hot_page_indices()[0])
        engine.instance.image.pages_matrix()[page, 7] += 1

    _corrupt_after(monkeypatch, RestoreEngine, "pre_install_hot", flip)
    rec = run_tiny(cell, traffic=traffic)
    assert rec["checks"]["restored_bytes"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_a_fault_late_in_the_window_fails(cell, traffic, monkeypatch):
    """Every start of the window is compared, not its first few: a byte
    flipped from the fourth pre-install of the run on."""
    from repro_torch.core import RestoreEngine

    calls = []

    def flip(engine):
        calls.append(1)
        if len(calls) > 3 + 2:     # the warm-up's two, then three sound starts
            page = int(engine.reader.hot_page_indices()[-1])
            engine.instance.image.pages_matrix()[page, 9] += 1

    _corrupt_after(monkeypatch, RestoreEngine, "pre_install_hot", flip)
    rec = run_tiny(cell, traffic=traffic, seconds=2.0)
    assert rec["attempted"] > 5
    assert rec["checks"]["restored_bytes"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_dropped_zero_page_fails(cell, traffic, monkeypatch):
    """A zero run installed without its last page."""
    from repro_torch.core import Instance

    orig = Instance.uffd_zeropage_range

    def short(self, start, n):
        return orig(self, start, n - 1) if n > 1 else 0

    monkeypatch.setattr(Instance, "uffd_zeropage_range", short)
    rec = run_tiny(cell, traffic=traffic)
    assert rec["checks"]["restored_missing"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_zero_pages_not_zero_filled_fail(cell, traffic, monkeypatch):
    """Instances on recycled memory: a zero page marked present but never
    zeroed reads what was there before."""
    from repro_torch.core import StateImage

    orig = StateImage.empty_like

    def dirty(manifest, device="cuda"):
        img = orig(manifest, device=device)
        img.buf.fill_(0xA5)
        return img

    monkeypatch.setattr(StateImage, "empty_like", staticmethod(dirty))
    rec = run_tiny(cell, traffic=traffic)
    assert rec["checks"]["restored_bytes"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_restore_that_leaves_the_state_unchanged_fails(cell, traffic, monkeypatch):
    """Restores that install nothing: no hot pre-install and no cold walk."""
    from repro_torch.core import RestoreEngine

    monkeypatch.setattr(RestoreEngine, "pre_install_hot", lambda self, *a, **k: 0)
    monkeypatch.setattr(RestoreEngine, "install_all_sync", lambda self, use_batch=True: None)
    rec = run_tiny(cell, traffic=traffic)
    assert rec["checks"]["restored_missing"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic", RESTORES)
def test_half_of_each_batch_left_out_fails(cell, traffic, monkeypatch):
    from repro_torch.core import Instance

    orig = Instance.uffd_copy_batch

    def half(self, pages, mat, rows=None):
        pages = np.asarray(pages, dtype=np.int64).reshape(-1)
        keep = (pages.size + 1) // 2
        if rows is None:
            rows = np.arange(pages.size, dtype=np.int64)
            mat = mat.reshape(pages.size, -1)
        return orig(self, pages[:keep], mat, np.asarray(rows)[:keep])

    monkeypatch.setattr(Instance, "uffd_copy_batch", half)
    rec = run_tiny(cell, traffic=traffic)
    assert rec["checks"]["restored_missing"]["value"] > 0
    assert not harness.passed(rec["checks"])


def test_deploy_that_leaves_the_state_unchanged_fails(monkeypatch):
    """A publish of a new version that stores the live version's bytes."""
    from repro_torch.core import PoolMaster, reconstruct_image

    orig = PoolMaster.publish

    def stale(self, name, image, ws, **kw):
        fn, version = name.rsplit(".", 1)
        if version != "0":
            live = self.catalog.find(f"{fn}.{int(version) - 1}")
            image = reconstruct_image(self.pool, live.regions)
        return orig(self, name, image, ws, **kw)

    monkeypatch.setattr(PoolMaster, "publish", stale)
    rec = run_tiny(DEPLOY, traffic=DEPLOY_MIX)
    assert rec["checks"]["format_stored_bytes"]["value"] > 0
    assert not harness.passed(rec["checks"])


def test_deploy_with_half_the_working_set_left_out_fails(monkeypatch):
    from repro_torch.core import PoolMaster

    orig = PoolMaster.publish
    monkeypatch.setattr(PoolMaster, "publish",
                        lambda self, name, image, ws, **kw: orig(self, name, image, ws[::2], **kw))
    rec = run_tiny(DEPLOY, traffic=DEPLOY_MIX)
    assert rec["checks"]["format_slots"]["value"] > 0
    assert not harness.passed(rec["checks"])


@pytest.mark.parametrize("cell,traffic,control,number",
                         [(c, t, "unverified", "tamper_undetected") for c, t in RESTORES]
                         + [(DEPLOY, DEPLOY_MIX, "nodedup", "excess_pages")])
def test_control_is_not_correct(cell, traffic, control, number):
    """The program with one guarantee switched off: restores that install
    without the publish-time checksums (the planted corrupt page goes in),
    or versions published without the stores."""
    rec = run_tiny(cell, control=control, traffic=traffic)
    assert rec["checks"][number]["value"] > 0
    assert not harness.passed(rec["checks"])


def test_page_fingerprints_by_hand():
    pages = torch.zeros(3 * 4096, dtype=torch.uint8)
    pages[4096 + 100] = 1                  # page 1 differs from page 0 in one byte
    pages[2 * 4096 + 8] = 1                # page 2 differs from both
    fp = reference.page_fps(pages)
    assert int(fp[0]) == 0
    assert len({int(x) for x in fp}) == 3
    # one word w of page 1 set to 1 at byte 100: its weight times 256**4
    w = int(reference.FP_WEIGHTS[100 // 8])
    want = (w * (1 << 32)) & ((1 << 64) - 1)
    assert int(fp[1]) & ((1 << 64) - 1) == want


def test_roofline_bytes_by_hand():
    # one page installed: 4096 read + 4096 written + 4 checksum bytes read
    assert roofline.restore_bytes(1) == 8196
    assert roofline.restore_bytes(1000) == 8_196_000
    # 10 pages, 4 non-zero: 40960 read, 16384 written, 10 flag bytes, 40 checksum bytes
    assert roofline.publish_bytes(10, 4) == 40960 + 16384 + 10 + 40
    # the paper's instance: 393,216 pages, 159,606 of them non-zero
    assert roofline.publish_bytes(393216, 159606) == (393216 + 159606) * 4096 + 5 * 393216
    # 3.35e12 bytes in one second is the whole roof
    assert roofline.share(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share(1e9, 0.0) is None
    assert roofline.matches("fused_restore", "void aq::rows_kernel<true>(aq::RowArgs)")
    assert not roofline.matches("fused_restore", "void aq::rows_kernel<false>(aq::RowArgs)")


def test_reference_checksum_by_hand():
    row = torch.zeros((1, 4096), dtype=torch.uint8)
    row[0, -4:] = torch.tensor([1, 0, 0, 0], dtype=torch.uint8)      # last lane = 1
    assert int(reference.poly32(row)[0]) == 1
    row[0, -8:-4] = torch.tensor([1, 0, 0, 0], dtype=torch.uint8)    # + P * 1
    assert int(reference.poly32(row)[0]) == 1 + reference.POLY_P


def test_run_imports_no_jax():
    """What a run loads (run.py, the harness, the reference, every metric
    reader, and the port's modules it drives) has no top-level module named
    jax, jaxlib, flax or repro, compared whole."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import runpy; runpy.run_path('aqbench/run.py', run_name='not_main')\n"
        "from aqbench import harness, reference, gen, trace, roofline\n"
        "[harness.load_module('ops', o) for o in ('coldstart', 'deploy')]\n"
        "[harness.load_module('images', i) for i in ('independent', 'variants_of_one_base')]\n"
        "import repro_torch.core, repro_torch.kernels\n"
        "b = harness.load_benchmark()\n"
        "[harness.load_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "import importlib; run = importlib.import_module('aqbench.run')\n"
        "print(run.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    from aqbench import run

    monkeypatch.setitem(sys.modules, "repro_torch", object())
    monkeypatch.setitem(sys.modules, "reprox.core", object())
    assert not {"repro_torch", "reprox"} & set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in run.banned_modules()


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "aqbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "aqbench", tmp_path / "aqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control", [("fn1g5.eager", "unverified")])
def test_control_on_the_card(card, cell, control):
    """The control at the cell's own size on the card: not correct."""
    out = subprocess.run([sys.executable, "aqbench/run.py", "--workload", cell, "--seed", "7",
                          "--seconds", "3", "--trace", "0", "--control", control],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
