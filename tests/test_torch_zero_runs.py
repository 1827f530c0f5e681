"""Port parity: a restore's zero runs under one lock.

``Instance.uffd_zeropage_runs`` marks a whole run table present by array
arithmetic.  It is held to the JAX package's per-run loop of
``uffd_zeropage_range`` exactly, in ``present``, ``stats``, the ledger
(key by key, ``==``) and the pages it returns, over the zero runs of a
private and a dedup image and any prior state of ``present``: none, single
pages a fault installed (which split runs into ranges), whole runs already
present.  ``install_zero_runs`` and ``install_all_sync`` through it stay
exact against the reference on an image of many short zero runs, and a
thread waiting on a zero page is woken.  The benchmark's planted dropped
zero page is planted at the one call and still fails its check."""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro import core as ref
from repro_torch import core as port
from test_torch_snapshot import CXL, RDMA, publish_both

PAGE = 4096
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _many_zero_runs_image():
    """670 pages: a runtime segment of 1–3-page zero runs between 1–3 pages
    of data, so the image has some 150 zero runs."""
    rng = np.random.default_rng(7)
    pages = []
    while len(pages) < 600:
        pages += [0] * int(rng.integers(1, 4)) + [1] * int(rng.integers(1, 4))
    data = rng.integers(1, 256, (len(pages), PAGE), dtype=np.uint8)
    data[np.array(pages) == 0] = 0
    arrays = {"params": rng.standard_normal((30 * 1024,)).astype(np.float32),
              "runtime": data.reshape(-1),
              "arena": np.zeros((40, 1024), np.float32)}
    ws = sorted({*range(0, 10), *range(50, 58), *range(300, 340), 611, 612})
    return arrays, ws


def _publish_pair(dedup: bool = False):
    """``(image, reader, instance, engine)`` of each package, restoring the
    image of many zero runs from the same publish; the reader charges the
    instance's ledger."""
    arrays, ws = _many_zero_runs_image()
    out = []
    for mod, kw in ((ref, {}), (port, {"device": "cpu"})):
        img = mod.StateImage.build(arrays, **kw)
        pool = mod.HierarchicalPool(CXL, RDMA, **kw)
        reg = mod.build_snapshot(pool, img, ws, "z", version=1, dedup=dedup)
        ledger = mod.TimeLedger()
        reader = mod.SnapshotReader(reg, pool.host_view("h", ledger), pool.rdma)
        reader.invalidate_cxl()
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **kw), ledger)
        out.append((img, reader, inst, mod.RestoreEngine(reader, inst)))
    return out


def _private():
    """``(reference image, port image, zero runs)`` of a private snapshot."""
    (img_r, _, _), (img, pool, reg), _ws = publish_both(seed=3, fused=False)
    reader = port.SnapshotReader(reg, pool.host_view("h"), pool.rdma)
    return (img_r, img), reader.zero_runs()


def _dedup():
    """The same of a dedup snapshot of many short zero runs."""
    (img_r, _, _, _), (img, reader, _, _) = _publish_pair(dedup=True)
    return (img_r, img), reader.zero_runs()


IMAGES = {"private": _private, "dedup": _dedup}


def _prior(kind: str, runs: np.ndarray, n_pages: int) -> np.ndarray:
    """The pages present before the zero runs are installed."""
    rng = np.random.default_rng(11)
    present = np.zeros(n_pages, dtype=bool)
    zero = np.concatenate([np.arange(s, s + n) for s, n in runs.tolist()])
    if kind in ("scattered", "whole"):
        present[rng.choice(zero, max(1, zero.size // 5), replace=False)] = True
        present[rng.choice(n_pages, 7, replace=False)] = True      # pages of no run
    if kind == "whole":
        for s, n in runs[rng.choice(len(runs), max(1, len(runs) // 3), replace=False)]:
            present[s : s + n] = True
    return present


def _pair(imgs, present: np.ndarray):
    """A reference instance and a port instance of ``imgs`` with ``present``."""
    out = []
    for mod, img, kw in ((ref, imgs[0], {}), (port, imgs[1], {"device": "cpu"})):
        inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **kw), mod.TimeLedger())
        inst.present[:] = present
        inst.ledger.add("uffd_zeropage", 1e-3)      # a prior charge the terms add to
        out.append(inst)
    return out


def _assert_same(r, g):
    np.testing.assert_array_equal(r.present, g.present)
    assert r.stats == g.stats
    assert r.ledger.seconds == g.ledger.seconds


TABLES = ["all", "empty", "one", "halves"]


def _halves(runs: np.ndarray) -> np.ndarray:
    """Each run split in two adjacent runs (a one-page run keeps an empty
    second half), the table reversed: any order, runs that touch."""
    first = runs[:, 1] // 2 + 1
    out = np.stack([runs[:, 0], first, runs[:, 0] + first, runs[:, 1] - first], 1)
    return out.reshape(-1, 2)[::-1]


@pytest.mark.parametrize("image", list(IMAGES))
@pytest.mark.parametrize("prior", ["none", "scattered", "whole"])
@pytest.mark.parametrize("table", TABLES)
def test_runs_equal_the_reference_loop(image, prior, table):
    imgs, zero_runs = IMAGES[image]()
    assert len(zero_runs) > 3
    present = _prior(prior, zero_runs, imgs[1].total_pages)
    runs = {"all": zero_runs, "empty": zero_runs[:0],
            "one": zero_runs[np.argmax(zero_runs[:, 1])][None],
            "halves": _halves(zero_runs)}[table]
    r, g = _pair(imgs, present)
    want = sum(r.uffd_zeropage_range(int(s), int(n)) for s, n in runs)
    got = g.uffd_zeropage_runs(runs)
    assert got == want
    _assert_same(r, g)
    if table != "empty":
        marked = np.concatenate([np.arange(s, s + n) for s, n in runs.tolist()])
        assert g.present[marked].all()
        assert got == int((~present[marked]).sum())
    if prior == "scattered" and table == "all":
        # the prior state splits some run into more than one range
        inside = [present[s : s + n] for s, n in runs.tolist()]
        assert any(np.count_nonzero(np.diff(p.astype(np.int8)) == 1) for p in inside)
    if prior == "whole" and table == "all":
        assert g.stats["uffd_batches"] < len(runs)      # whole runs take no batch


def test_one_run_form_is_the_table_of_one():
    imgs, runs = _private()
    n_pages = imgs[1].total_pages
    r, g = _pair(imgs, _prior("scattered", runs, n_pages))
    for s, n in runs.tolist() + [[0, 0], [n_pages - 2, 9]]:
        assert g.uffd_zeropage_range(s, n) == r.uffd_zeropage_range(s, n)
        _assert_same(r, g)
    assert g.uffd_zeropage_runs(runs) == 0            # a second pass marks nothing
    assert g.stats == r.stats


def test_overlapping_runs_raise_and_change_nothing():
    imgs, runs = _private()
    _, g = _pair(imgs, np.zeros(imgs[1].total_pages, dtype=bool))
    s, n = runs[-1].tolist()
    with pytest.raises(ValueError):
        g.uffd_zeropage_runs([[s, n], [0, 3], [s + n - 1, 2]])
    assert not g.present.any() and g.stats["uffd_batches"] == 0


# ------------------------------------------------------------------ through the engine

def _assert_engines_same(r, g):
    np.testing.assert_array_equal(r[2].image.buf, g[2].image.buf.numpy())
    np.testing.assert_array_equal(r[2].present, g[2].present)
    assert r[2].ledger.seconds == g[2].ledger.seconds
    assert r[2].stats == g[2].stats
    assert r[1].view.stats == g[1].view.stats


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("path", ["install_zero_runs", "install_all_sync", "after_faults"])
def test_engine_paths_equal_the_reference(path, dedup):
    r, g = _publish_pair(dedup)
    runs = g[1].zero_runs()
    assert len(runs) > 100
    if path == "after_faults":
        # zero pages a demand fault installed first, and a hot pre-install
        zero = g[1].zero_page_indices()
        for side in (r, g):
            side[3].pre_install_hot()
            for p in zero[::7].tolist():
                side[3].access(p)
    n = [side[3].install_zero_runs() if path != "install_all_sync"
         else side[3].install_all_sync() for side in (r, g)]
    assert n[0] == n[1]
    _assert_engines_same(r, g)
    if path == "install_all_sync":
        assert g[2].all_present()
        np.testing.assert_array_equal(g[2].image.buf.numpy(), g[0].buf.numpy())
    else:
        assert g[2].present[g[1].zero_page_indices()].all()
        assert g[2].stats["uffd_zeropages"] == runs[:, 1].sum()


def test_a_waiter_on_a_zero_page_is_woken():
    imgs, runs = _private()
    _, g = _pair(imgs, np.zeros(imgs[1].total_pages, dtype=bool))
    page = int(runs[-1, 0] + runs[-1, 1] - 1)
    got = []
    t = threading.Thread(target=lambda: got.append(g.wait_present(page, timeout_s=60.0)),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while not g._cv._waiters and time.monotonic() < deadline:
        time.sleep(0.001)
    assert g._cv._waiters, "the waiter never blocked"
    g.uffd_zeropage_runs(runs)
    t.join(timeout=5.0)          # woken by the call, not by its own timeout
    assert not t.is_alive() and got == [True]


@pytest.mark.parametrize("traffic", ["eager", "lazy"])
def test_a_dropped_zero_page_fails_the_benchmarks_check(traffic, monkeypatch):
    """The benchmark's planted control at the call every restore now makes:
    each zero run installed without its last page reads above 0."""
    from aqbench import harness
    from aqbench.tests.conftest import run_tiny

    runs_of = port.Instance.uffd_zeropage_runs

    def short(self, runs):
        runs = np.array(runs, dtype=np.int64).reshape(-1, 2)
        runs[:, 1] -= 1
        return runs_of(self, runs)

    monkeypatch.setattr(port.Instance, "uffd_zeropage_runs", short)
    rec = run_tiny("fn1g5.eager", traffic=traffic)
    assert rec["checks"]["restored_missing"]["value"] > 0
    assert not harness.passed(rec["checks"])
