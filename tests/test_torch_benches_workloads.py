"""The port's workloads (``scripts/workloads.py``) against the JAX package's
(``benchmarks/workloads.py``) on the CPU, for all nine: the four dense
workloads, ``recognition`` (DeepSeek-V3: an invocation touches only its
routed experts' pages, found by ``flatten_state``'s ``"/moe/w"`` names),
``image`` (Qwen2-VL), ``pyaes`` (xLSTM), ``pagerank`` (Zamba2) and
``ffmpeg`` (SeamlessM4T).

On the port's own seeded parameters (not bit-equal to JAX's), everything a
bench models is the reference's: the manifest, the zero, hot and cold page
sets, the profiled working set, the measured invocation's touches, the
scale, and the region layout of a publish.  On the reference's parameters
(carried across as numpy arrays) the image is byte-identical."""
import dataclasses

import jax
import numpy as np
import pytest

import test_torch_bench_harness  # noqa: F401  (puts src/ and scripts/ on sys.path)

import workloads as twin  # noqa: E402
from benchmarks import workloads as ref  # noqa: E402
from repro.core import HierarchicalPool as RefPool  # noqa: E402
from repro.core import build_snapshot as ref_build_snapshot  # noqa: E402
from repro_torch.core import HierarchicalPool, build_snapshot  # noqa: E402

PORTED = ("chameleon", "compression", "json", "matmul", "recognition", "image", "pyaes",
          "pagerank", "ffmpeg")


@pytest.fixture(scope="module")
def built():
    """Each ported workload through the reference and the twin (own params)."""
    return {n: (ref.build_workload(n), twin.build_workload(n, device="cpu")) for n in PORTED}


def _classes(zero, ws):
    hot = np.zeros(zero.size, bool)
    hot[ws] = True
    return zero, hot & ~zero, ~hot & ~zero


@pytest.mark.parametrize("name", PORTED)
def test_page_classes_touches_and_scale_are_the_references(name, built):
    r, p = built[name]
    assert p.image.manifest.to_dict() == r.image.manifest.to_dict()
    assert np.array_equal(p.profile.working_set, r.profile.working_set)
    assert np.array_equal(p.invocation_touched, r.invocation_touched)
    assert p.scale == r.scale and p.wdef == twin.WORKLOADS[name]
    assert dataclasses.asdict(p.wdef) == dataclasses.asdict(r.wdef)
    zp = p.image.zero_page_bitmap()
    zr = r.image.zero_page_bitmap()
    for a, b in zip(_classes(zp, p.profile.working_set), _classes(zr, r.profile.working_set)):
        assert np.array_equal(a, b)
    spec, rspec = p.spec(), r.spec()
    assert spec.compute_s == rspec.compute_s and spec.scale == rspec.scale


@pytest.mark.parametrize("name", PORTED)
def test_publish_lays_out_the_references_regions(name, built):
    r, p = built[name]
    cap = dict(cxl_capacity=256 << 20, rdma_capacity=512 << 20)
    got = build_snapshot(HierarchicalPool(device="cpu", **cap), p.image,
                         p.profile.working_set, name)
    want = ref_build_snapshot(RefPool(**cap), r.image, r.profile.working_set, name)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("name", PORTED)
def test_reference_parameters_give_a_byte_identical_image(name, built):
    r, _ = built[name]
    cfg = ref.get_config(ref.WORKLOADS[name].arch).reduced()
    params = jax.tree.map(np.asarray, ref.build(cfg).init(jax.random.PRNGKey(0)))
    p = twin.build_workload(name, device="cpu", params=params)
    assert np.array_equal(p.image.buf.numpy(), r.image.buf)
    assert np.array_equal(p.profile.working_set, r.profile.working_set)


def test_twin_ports_what_its_tuple_says():
    assert twin.PORTED == PORTED and set(twin.DENSE) < set(twin.PORTED)
    assert sorted(twin.PORTED) == sorted(twin.all_workloads())


def test_all_workloads_lists_all_nine_and_get_workload_builds_once():
    assert twin.all_workloads() == ref.all_workloads() and len(twin.all_workloads()) == 9
    twin.clear_cache()
    a = twin.get_workload("matmul", device="cpu")
    assert twin.get_workload("matmul", device="cpu") is a
    twin.clear_cache()
    assert twin.get_workload("matmul", device="cpu") is not a
    twin.clear_cache()
