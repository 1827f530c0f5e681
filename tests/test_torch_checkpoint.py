"""Port parity of Aquifer-backed checkpointing on reduced ``phi4-mini-3.8b``
and ``qwen2.5-14b`` (each reduced config under its own name; the JAX
parameters carried across by ``interop.params_from_numpy``):
``flatten_state`` names and orders leaves as ``jax.tree_util`` does, the
``StateImage`` of a state tree is byte-identical to the JAX package's,
``save_checkpoint`` publishes the same regions and stats (all but the wall
time), and ``restore_checkpoint`` gives bit-equal state, equal ledgers (key
by key, ``==``) and equal instance stats, with the cold prefetch off and
on.  With the prefetch on, the touch loop waits for the prefetcher before
its first demand fault in both packages, so the two runs take the same
schedule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs.base import get_config as jax_get_config
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro.models.model_zoo import build as jax_build
from repro_torch import core as port
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import make_fused_publish_fn

ARCHS = ["phi4-mini-3.8b", "qwen2.5-14b"]
PROMPT = 24        # Zipf prompt tokens an invocation embeds


def _model(arch):
    kw = dict(name=f"{arch}-ckpt-port-parity")
    jcfg, tcfg = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _model(arch)
        return cache[arch]
    return get


def serving_invocation(vocab: int, seed: int = 0):
    """One serving invocation's touches: every array whole but the token
    table, whose Zipf(1.4) prompt rows alone are touched."""
    def invocation(rec, i):
        r = np.random.default_rng((seed, i))
        toks = np.minimum(r.zipf(1.4, size=PROMPT) - 1, vocab - 1)
        rec.touch_rows("params/embed/table", np.unique(toks))
        for e in rec.manifest.extents:
            if e.name != "params/embed/table":
                rec.touch_array(e.name)
    return invocation


def _pod(mod):
    if mod is ref:
        pool = ref.HierarchicalPool(16 << 20, 32 << 20)
        return pool, ref.PoolMaster(pool, publish_fn=ref_publish_fn(
            block_pages=64, use_pallas=True, interpret=True))
    pool = port.HierarchicalPool(16 << 20, 32 << 20, device="cpu")
    return pool, port.PoolMaster(pool, publish_fn=make_fused_publish_fn())


def test_flatten_state_names_and_order_match_jax_tree_util():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(5)]
    ref_tree = {"z": [jnp.asarray(leaves[0]), {"b": jnp.asarray(leaves[1]),
                                                "a": jnp.asarray(leaves[2])}],
                "a": (jnp.asarray(leaves[3]), None), "m": {"10": jnp.asarray(leaves[4]),
                                                        "9": np.int32(4)}}
    port_tree = {"z": [torch.from_numpy(leaves[0]), {"b": torch.from_numpy(leaves[1]),
                                                      "a": torch.from_numpy(leaves[2])}],
                 "a": (torch.from_numpy(leaves[3]), None),
                 "m": {"10": torch.from_numpy(leaves[4]), "9": np.int32(4)}}
    want = ref_ckpt.flatten_state(ref_tree)
    got = ckpt.flatten_state(port_tree)
    assert list(got) == list(want) == ["a/0", "m/10", "m/9", "z/0", "z/1/a", "z/1/b"]
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]), want[name])
    back = ckpt.unflatten_state(port_tree, got)
    assert back["a"][1] is None and isinstance(back["a"], tuple)
    assert torch.equal(back["z"][1]["a"], port_tree["z"][1]["a"])
    assert back["m"]["9"].shape == () and int(back["m"]["9"]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_state_image_of_params_is_byte_identical(models, arch):
    _jcfg, _tcfg, tree = models(arch)
    want_arrays = ref_ckpt.flatten_state({"params": jax.tree.map(jnp.asarray, tree)})
    got_arrays = ckpt.flatten_state({"params": params_from_numpy(tree, device="cpu")})
    assert list(got_arrays) == list(want_arrays)
    assert all(isinstance(t, torch.Tensor) for t in got_arrays.values())
    want = ref.StateImage.build(want_arrays)
    got = port.StateImage.build(got_arrays, device="cpu")
    assert got.manifest.to_dict() == want.manifest.to_dict()
    np.testing.assert_array_equal(got.buf.numpy(), want.buf)


def test_default_train_hotness_matches_reference():
    rng = np.random.default_rng(2)
    arrays = {name: rng.standard_normal(n).astype(np.float32) for name, n in (
        ("params/w", 3000), ("opt/m/w", 3000), ("opt/v/w", 3000), ("1/m/x", 700),
        ("step", 1), ("layers/v/k", 1200), ("mv/weights", 900))}
    want = ref_ckpt.default_train_hotness(ref.StateImage.build(arrays).manifest)
    got = ckpt.default_train_hotness(port.StateImage.build(arrays, device="cpu").manifest)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def saved(models):
    """Both packages' pods with one reduced model published through
    ``save_checkpoint`` on the same profiled working set."""
    out = {}

    def get(arch):
        if arch in out:
            return out[arch]
        jcfg, _tcfg, tree = models(arch)
        state = {"params": jax.tree.map(jnp.asarray, tree)}
        manifest = ref.StateImage.build(ref_ckpt.flatten_state(state)).manifest
        ws = ref.profile_invocations(manifest, serving_invocation(jcfg.vocab), 16).working_set
        sides = {}
        for mod, st, save in ((ref, state, ref_ckpt.save_checkpoint),
                              (port, {"params": params_from_numpy(tree, device="cpu")},
                               ckpt.save_checkpoint)):
            pool, master = _pod(mod)
            image, stats = save(master, "model", st, step=3, working_set=ws,
                                metadata={"arch": arch})
            sides[mod] = (pool, master, image, stats)
        out[arch] = (sides, tree, ws)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_save_checkpoint_regions_and_stats_match(saved, arch):
    sides, _tree, ws = saved(arch)
    (pr, mr, img_r, st_r), (pg, mg, img_g, st_g) = sides[ref], sides[port]
    assert st_r.pop("publish_s") >= 0.0 and st_g.pop("publish_s") >= 0.0
    assert st_g == st_r
    assert st_g["hot"] > 0 and st_g["cold"] > 0
    np.testing.assert_array_equal(img_g.buf.numpy(), img_r.buf)
    er, eg = mr.catalog.find("model"), mg.catalog.find("model")
    assert eg.regions.to_dict() == er.regions.to_dict()
    for t in ("cxl", "rdma"):
        np.testing.assert_array_equal(getattr(pg, t).buf.numpy(), getattr(pr, t).buf)
        assert getattr(pg, t).free_list() == getattr(pr, t)._free


@pytest.mark.parametrize("prefetch_cold", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_restore_checkpoint_matches_reference(saved, arch, prefetch_cold, monkeypatch):
    sides, tree, _ws = saved(arch)
    if prefetch_cold:
        for mod in (ref, port):
            access = mod.RestoreEngine.access

            def after_prefetch(self, page, timeout_s=30.0, _access=access):
                assert self.wait_prefetch_idle(60.0)
                return _access(self, page, timeout_s)

            monkeypatch.setattr(mod.RestoreEngine, "access", after_prefetch)
    got = {}
    for mod, fn, template in ((ref, ref_ckpt.restore_checkpoint,
                               {"params": jax.tree.map(jnp.asarray, tree)}),
                              (port, ckpt.restore_checkpoint,
                               {"params": params_from_numpy(tree, device="cpu")})):
        pool, master, _image, _stats = sides[mod]
        orch = mod.Orchestrator("h0", pool, master.catalog, prefetch_cold=prefetch_cold)
        got[mod] = fn(orch, "model", template)
        orch.close()
    (state_r, st_r), (state_g, st_g) = got[ref], got[port]
    flat_r, flat_g = ref_ckpt.flatten_state(state_r), ckpt.flatten_state(state_g)
    assert list(flat_g) == list(flat_r)
    for name, want in flat_r.items():
        assert isinstance(flat_g[name], torch.Tensor)
        np.testing.assert_array_equal(flat_g[name].numpy(), want)
        np.testing.assert_array_equal(flat_g[name].numpy(),
                                      ref_ckpt.flatten_state({"params": tree})[name])
    assert st_g["modeled"] == st_r["modeled"]
    assert list(st_g["modeled"]) == list(st_r["modeled"])
    assert st_g["instance"] == st_r["instance"]
    assert st_g["meta"] == st_r["meta"] == {"step": 3, "arch": arch}
    assert st_g["time_to_full_s"] >= st_g["time_to_hot_s"] > 0.0
    if not prefetch_cold:
        assert st_g["instance"]["fault_rdma"] == sides[port][3]["cold"]


def test_restore_checkpoint_of_a_missing_name_raises():
    pool, master = _pod(port)
    orch = port.Orchestrator("h0", pool, master.catalog)
    with pytest.raises(FileNotFoundError, match="nope"):
        ckpt.restore_checkpoint(orch, "nope", {})
