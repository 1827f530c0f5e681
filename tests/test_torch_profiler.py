"""Port parity of offline hotness profiling: ``AccessRecorder``,
``WorkloadProfile`` and ``profile_invocations`` on one manifest, through
both packages, give the same page sets, working sets, run lengths and
fragment statistics; ``touch_rows`` equals ``extent.row_pages`` row by row.
Also the serving module's ``RestoreSession`` alias and ``mmap_install_cost``,
and the manifest of an image built from tensors (bfloat16 included)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import profiler as ref_prof
from repro.core import serving as ref_serving
from repro.core.pagestore import StateImage as RefImage
from repro_torch.core import (
    AccessRecorder,
    RestoreEngine,
    RestoreSession,
    StateImage,
    WorkloadProfile,
    mmap_install_cost,
    profile_invocations,
)


def _arrays():
    return {
        "emb": np.arange(300 * 7, dtype=np.float32).reshape(300, 7),     # rows < 1 page
        "kv": np.arange(8 * 2048, dtype=np.float32).reshape(8, 2048),    # rows = 2 pages
        "wide": np.arange(5 * 3072, dtype=np.float32).reshape(5, 3072),  # 3 pages a row
        "vec1d": np.arange(5000, dtype=np.float64),                      # 1-D array
        "bytes1d": np.arange(256, dtype=np.uint8),                       # sub-page 1-D
    }


@pytest.fixture(scope="module")
def manifests():
    arrays = _arrays()
    ref_m = RefImage.build(arrays).manifest
    port_m = StateImage.build(arrays, device="cpu").manifest
    assert port_m.to_dict() == ref_m.to_dict()
    return ref_m, port_m


def _row_pages(manifest, name, rows):
    e = manifest.by_name()[name]
    row_elems = int(np.prod(e.shape[1:])) if len(e.shape) > 1 else 1
    pages = set()
    for r in rows:
        pages.update(e.row_pages(int(r), row_elems))
    return pages


@pytest.mark.parametrize("name,rows", [
    ("emb", [0, 1, 2]),
    ("emb", [0, 150, 299]),               # rows crossing page boundaries
    ("emb", np.asarray([5, 5, 9, 5])),    # duplicates, an array
    ("kv", [0, 3, 7]),                    # multi-page rows
    ("wide", range(5)),
    ("vec1d", [0, 511, 512, 4999]),       # 1-D: a row is an element
    ("bytes1d", [0, 255]),                # 1-D sub-page: all land on page 0
    ("kv", []),                           # empty: no page
])
def test_touch_rows_matches_reference(manifests, name, rows):
    ref_m, port_m = manifests
    r, g = ref_prof.AccessRecorder(ref_m), AccessRecorder(port_m)
    r.touch_rows(name, rows)
    g.touch_rows(name, rows)
    assert g.pages == r.pages == _row_pages(port_m, name, rows)


def test_every_touch_and_result_matches_reference(manifests):
    ref_m, port_m = manifests
    r, g = ref_prof.AccessRecorder(ref_m), AccessRecorder(port_m)
    for rec in (r, g):
        rec.touch_array("kv")
        rec.touch_rows("wide", [1, 3])
        rec.touch_elements("vec1d", 100, 1700)
        rec.touch_elements("emb", 7, 8)
        rec.touch_pages([0, np.int64(2), 40, 41])
    assert g.pages == r.pages
    np.testing.assert_array_equal(g.working_set(), r.working_set())
    assert g.working_set().dtype == np.int64
    assert g.run_lengths() == r.run_lengths()


@pytest.mark.parametrize("pages", [[], [3], [0, 1, 2, 9, 10, 30], list(range(0, 40, 3))])
def test_fragment_stats_match_reference(pages):
    ws = np.asarray(pages, dtype=np.int64)
    got = WorkloadProfile("w", 4, ws).fragment_stats()
    assert got == ref_prof.WorkloadProfile("w", 4, ws).fragment_stats()


def test_profile_invocations_matches_reference(manifests):
    """Seeded invocations of the serving workloads' shape: every array whole
    but the table, Zipf rows of the table."""
    ref_m, port_m = manifests

    def invocation(rec, i):
        r = np.random.default_rng((7, i))
        toks = np.minimum(r.zipf(1.4, size=24) - 1, 299)
        rec.touch_rows("emb", np.unique(toks))
        rec.touch_array("kv")
        if i % 3 == 0:
            rec.touch_elements("vec1d", 1000 * (i % 5), 1000 * (i % 5) + 64)

    want = ref_prof.profile_invocations(ref_m, invocation, 16, name="w")
    got = profile_invocations(port_m, invocation, 16, name="w")
    assert (got.name, got.invocations) == (want.name, want.invocations) == ("w", 16)
    np.testing.assert_array_equal(got.working_set, want.working_set)
    assert got.fragment_stats() == want.fragment_stats()


def test_restore_session_alias_and_mmap_install_cost():
    assert RestoreSession is RestoreEngine
    rng = np.random.default_rng(3)
    for pages in ([], [5], list(range(10)), rng.choice(4096, 700, replace=False).tolist()):
        assert mmap_install_cost(pages) == ref_serving.mmap_install_cost(pages)


def test_image_of_tensors_has_the_reference_manifest_and_bytes():
    """Tensors (bfloat16 among them) lay out as the same numpy arrays do in
    the JAX package; ``read_tensor`` views the bytes in their dtype."""
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((33, 70)).astype(np.float32)
    bf = rng.standard_normal(1500).astype(ml_dtypes.bfloat16)
    i32 = rng.integers(-9, 9, (4, 3)).astype(np.int32)
    want = RefImage.build({"a/f32": f32, "b/bf16": bf, "c/i32": i32, "d/scalar": np.int32(7)})
    tensors = {"a/f32": torch.from_numpy(f32),
               "b/bf16": torch.from_numpy(bf.view(np.uint16)).view(torch.bfloat16),
               "c/i32": torch.from_numpy(i32), "d/scalar": torch.tensor(7, dtype=torch.int32)}
    got = StateImage.build(tensors, device="cpu")
    assert StateImage.layout(tensors).to_dict() == got.manifest.to_dict()
    assert got.manifest.to_dict() == want.manifest.to_dict()
    assert got.manifest.by_name()["b/bf16"].dtype == "bfloat16"
    np.testing.assert_array_equal(got.buf.numpy(), want.buf)
    for name, t in tensors.items():
        view = got.read_tensor(name)
        assert view.dtype == t.dtype and view.shape == (t.shape or (1,))
        assert torch.equal(view.reshape(t.shape), t)
        assert view.untyped_storage().data_ptr() == got.buf.untyped_storage().data_ptr()
