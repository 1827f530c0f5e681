"""The port's concurrency bench (``scripts/concurrency_bench.py``) against
the JAX package's (``benchmarks/concurrency_bench.py``) on the CPU, at the
quick and the full configurations, run live through both packages with
every output directory redirected to ``tmp_path``.

Each point's restores run on threads; every key other than ``wall_s`` (each
point's wall clock) is modeled, ledger charges through the link arbiters'
fair-share model.  Integers, booleans and strings come out ``==``; so do
the floats on a quiet host, but not always: a session's ``TimeLedger`` adds
its ``uffd_copy`` charges in the order they are made, by the restore's own
thread (hot chunks) and by the host's completion worker (prefetched cold
extents), and float addition is not associative.  On a loaded host two runs
of the reference itself can differ in their last bits (seen:
``gain_at_conc_ge_8`` 2.6358191698069655 against 2.635819169806965).
``test_charges_are_the_references_and_only_their_order_varies`` shows it.
So the floats are held as ``chip_smoke.json_close`` holds the card's run:
``==`` or within 1e-12 relative, and ``model_err_max``, a relative error of
two times, within 1e-12 of their scale.  The same holds against the twin's
committed ``experiments/torch/concurrency_bench{,_quick}.json``; every
criterion is true, and each run's kernel launches, tallied on the CPU, are
those ``chip_smoke.BENCH_LAUNCHES`` holds the card to."""
import collections
import json

import numpy as np
import pytest

from test_torch_bench_harness import REPO, bench_launches, cpu_tally, jsonify

import chip_smoke  # noqa: E402
import concurrency_bench as twin  # noqa: E402
from benchmarks import concurrency_bench as ref_bench  # noqa: E402


def _diffs(got, want) -> list:
    """json_close's diffs: what differs beyond the order of a ledger's sums."""
    return chip_smoke.json_close(got, want, skip=("wall_s",))[0]


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_twin_equals_reference_key_for_key(quick, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "OUT", tmp_path / "ref")
    monkeypatch.setattr(twin, "OUT", tmp_path / "port")
    name = "concurrency_bench_quick.json" if quick else "concurrency_bench.json"
    with cpu_tally() as launches:
        got = jsonify(twin.run(quick=quick, device="cpu"))
    want = jsonify(ref_bench.run(quick=quick))
    assert got == json.loads((tmp_path / "port" / name).read_text())
    assert not _diffs(got, want), _diffs(got, want)
    committed = json.loads((REPO / "experiments" / "torch" / name).read_text())
    assert not _diffs(got, committed), _diffs(got, committed)
    c = got["criteria"]
    assert c["gain_ok"] and c["model_within_15pct"] and c["all_bit_identical"]
    assert all(r["wall_s"] > 0 for r in got["rows"])
    assert launches == bench_launches("concurrency_bench", quick)


def _charges(monkeypatch, pkg, ledger_cls, images) -> list:
    """Each session's ledger charges at 8 shared same-snapshot restores, in
    the order they were added (each term of an ``add_each`` a charge)."""
    log = collections.defaultdict(list)
    add = ledger_cls.add
    add_each = getattr(ledger_cls, "add_each", None)

    def logged(self, key, t):
        log[id(self)].append((key, t))
        add(self, key, t)

    def logged_each(self, key, ts):
        log[id(self)].extend((key, t) for t in np.asarray(ts, dtype=np.float64).tolist())
        add_each(self, key, ts)

    monkeypatch.setattr(ledger_cls, "add", logged)
    if add_each is not None:
        monkeypatch.setattr(ledger_cls, "add_each", logged_each)
    row = pkg.run_point(8, True, True, images)
    monkeypatch.setattr(ledger_cls, "add", add)
    if add_each is not None:
        monkeypatch.setattr(ledger_cls, "add_each", add_each)
    assert row["bit_identical"]
    return [seq for seq in log.values() if any(k == "uffd_copy" for k, _ in seq)]


def test_charges_are_the_references_and_only_their_order_varies(monkeypatch):
    """Both packages charge each session the same amounts; summed in
    another order, the same ``uffd_copy`` charges give another total."""
    from repro.core.pool import TimeLedger as RefLedger
    from repro_torch.core.pool import TimeLedger

    kw = dict(hot_pages=256, cold_pages=512, zero_pages=768)
    port = _charges(monkeypatch, twin, TimeLedger,
                    [twin.make_restore_image(seed=0, device="cpu", **kw)])
    ref = _charges(monkeypatch, ref_bench, RefLedger, [ref_bench.make_restore_image(seed=0, **kw)])
    assert len(port) == len(ref) == 8
    assert sorted(sorted(s) for s in port) == sorted(sorted(s) for s in ref)
    copies = sorted(t for k, t in max(ref, key=len) if k == "uffd_copy")
    totals = set()
    for order in (copies, copies[::-1]):
        ledger = RefLedger()
        for t in order:
            ledger.add("uffd_copy", t)
        totals.add(ledger.total())
    assert len(copies) > 20 and len(totals) == 2


def test_restore_image_and_working_set_are_the_references():
    import numpy as np

    img, ws = twin.make_restore_image(seed=3, hot_pages=16, cold_pages=64, zero_pages=8,
                                      device="cpu")
    rimg, rws = ref_bench.make_restore_image(seed=3, hot_pages=16, cold_pages=64, zero_pages=8)
    assert np.array_equal(img.buf.numpy(), rimg.buf) and np.array_equal(ws, rws)
