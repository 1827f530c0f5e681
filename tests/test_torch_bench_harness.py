"""What the bench twins' tests share: a CPU tally of the port's kernel
launches, exact JSON comparison, and the reference's calibration.

On a CPU tensor each data-plane wrapper runs its plain version and counts
nothing.  :func:`cpu_tally` counts, per wrapper, the calls that would launch
its kernel on a card: every call of the plain version with at least one row
(the CUDA branches launch nothing for zero rows).  The bench tests hold the
tally of each twin's run to ``chip_smoke.BENCH_LAUNCHES``, the counts the
smoke asserts on the card."""
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "src", REPO / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

REF_CALIBRATION = REPO / "experiments" / "kernel_calibration.json"


def jsonify(out):
    """A bench's return value as its JSON file holds it."""
    return json.loads(json.dumps(out))


def unequal(got, want, skip=()) -> list:
    """The paths where two JSON values are not ``==`` (floats included),
    by ``chip_smoke.json_close``: its diffs and its inexact floats."""
    import chip_smoke

    diffs, _, _, inexact = chip_smoke.json_close(got, want, skip=skip)
    return diffs + inexact


def use_ref_calibration(monkeypatch) -> None:
    """Set the port's strategies constants from the JAX package's
    calibration file, as the reference loads them at import (the port's
    own are the card's, ``experiments/torch/kernel_calibration.json``)."""
    from repro_torch.serve import strategies as s

    cal = s.load_calibration(REF_CALIBRATION)
    for name, value in (("CALIBRATION", cal), ("CHECKSUM_BW", cal["checksum_bw_Bps"]),
                        ("CHECKSUM_PER_PAGE_S", 4096 / cal["checksum_bw_Bps"]),
                        ("PUBLISH_SWEEP_PAGE_S", cal["publish_sweep_page_s"]),
                        ("PREINSTALL_PAGE_S", cal["preinstall_page_s"])):
        monkeypatch.setattr(s, name, value)


def bench_launches(name: str, quick: bool) -> dict:
    """``chip_smoke.BENCH_LAUNCHES`` for one run, every wrapper named."""
    import chip_smoke

    table = chip_smoke.BENCH_LAUNCHES[name]
    return dict.fromkeys(WRAPPERS, 0) | table["quick" if quick and "quick" in table else "full"]

WRAPPERS = ("fused_publish", "fused_restore", "zero_detect", "page_checksum", "page_gather",
            "page_scatter")


def _segment_rows(_dest, segs) -> bool:
    return sum(len(d) for _t, _r, d in segs) > 0


@contextlib.contextmanager
def cpu_tally():
    """Yields ``{wrapper: launches}``, counting inside the block."""
    from repro_torch.kernels.page_checksum import ops as pc
    from repro_torch.kernels.page_gather import ops as pg
    from repro_torch.kernels.page_scatter import ops as ps
    from repro_torch.kernels.snapshot_fuse import ops as sf
    from repro_torch.kernels.zero_detect import ops as zd

    counts = dict.fromkeys(WRAPPERS, 0)
    plain = [(zd, "zero_detect_ref", "zero_detect", lambda p: p.shape[0] > 0),
             (pg, "page_gather_ref", "page_gather", lambda p, i: i.shape[0] > 0),
             (pc, "page_checksum_ref", "page_checksum", lambda p: p.shape[0] > 0),
             (ps, "page_scatter_rows_ref", "page_scatter", _segment_rows),
             (sf, "fused_publish_ref", "fused_publish", lambda p, w: p.shape[0] > 0),
             (sf, "fused_restore_rows_ref", "fused_restore", _segment_rows)]
    saved = []
    for mod, attr, name, launches in plain:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def counted(*args, _fn=fn, _name=name, _launches=launches):
            if _launches(*args):
                counts[_name] += 1
            return _fn(*args)

        setattr(mod, attr, counted)
    try:
        yield counts
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def test_tally_counts_the_main_paths_launches():
    """The private main path: one publish, and per walk one verify-only and
    one install launch of the fused restore (the smoke's card count)."""
    from repro_torch.core import (HierarchicalPool, Instance, RestoreEngine, SnapshotReader,
                                  StateImage, build_snapshot)
    from repro_torch.kernels import FusedScatter, make_fused_publish_fn

    rng = np.random.default_rng(0)
    img = StateImage.build({"w": rng.integers(1, 255, 64 * 4096).astype(np.uint8),
                            "c": rng.integers(1, 255, 32 * 4096).astype(np.uint8),
                            "z": np.zeros(16 * 4096, np.uint8)}, device="cpu")
    pool = HierarchicalPool(cxl_capacity=8 << 20, rdma_capacity=8 << 20, device="cpu")
    with cpu_tally() as n:
        regions = build_snapshot(pool, img, list(range(64)), "s",
                                 publish_fn=make_fused_publish_fn())
        reader = SnapshotReader(regions, pool.host_view("h"), pool.rdma)
        inst = Instance(StateImage.empty_like(img.manifest, device="cpu"))
        eng = RestoreEngine(reader, inst, scatter_fn=FusedScatter())
        eng.pre_install_hot()
        eng.install_all_sync()
    assert torch.equal(inst.image.buf, img.buf)
    assert eng.walk_routes["batched"] == 2
    assert n == dict.fromkeys(WRAPPERS, 0) | {"fused_publish": 1, "fused_restore": 4}


def test_tally_ignores_empty_calls_and_restores_the_wrappers():
    from repro_torch.kernels import page_gather, zero_detect
    from repro_torch.kernels.zero_detect import ops as zd

    before = zd.zero_detect_ref
    with cpu_tally() as n:
        zero_detect(torch.zeros((0, 1024), dtype=torch.int32))
        zero_detect(torch.zeros((3, 1024), dtype=torch.int32))
        page_gather(torch.zeros((3, 1024), dtype=torch.int32), np.zeros(0, np.int64))
    assert n["zero_detect"] == 1 and n["page_gather"] == 0
    assert zd.zero_detect_ref is before


def test_json_close_names_paths_and_skips():
    import chip_smoke

    a = {"x": 1, "rows": [{"wall_s": 0.1, "v": 1.0, "e": 1e-4, "model_err_max": 1e-4}],
         "t": True}
    b = {"x": 1, "rows": [{"wall_s": 0.2, "v": 1.0 + 2**-52, "e": 1e-4 + 1e-16,
                           "model_err_max": 1e-4 + 1e-16}], "t": 1}
    diffs, floats, equal, inexact = chip_smoke.json_close(a, b)
    assert diffs == [f"/rows[0]/e: {1e-4!r} != {1e-4 + 1e-16!r}",
                     "/rows[0]/wall_s: 0.1 != 0.2", "/t: True != 1"]
    assert (floats, equal, len(inexact)) == (4, 0, 2)
    assert inexact[1] == "/rows[0]/v: 1.0 vs 1.0000000000000002"
    diffs, floats, equal, inexact = chip_smoke.json_close(a, b, skip=("wall_s", "/t", "e"))
    assert (diffs, floats, len(inexact)) == ([], 2, 2)
    assert unequal(a, a) == [] and len(unequal(a, b, skip=("wall_s", "/t", "e"))) == 2
