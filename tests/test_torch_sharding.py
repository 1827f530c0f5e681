"""The port's sharding rules, meshes, compressed all-reduce and reshard
against the JAX package's ``sharding/``, ``launch/mesh.py`` and
``checkpoint/ckpt.reshard``, on the CPU.

* specs: the port's ``param_specs`` on meta parameters (``build(cfg,
  "meta")``, which draws nothing) equal the reference's on
  ``jax.eval_shape(model.init)`` leaf by leaf for all ten archs, and the
  meta tree's shapes and dtypes equal the reference's; ``cache_specs`` over
  test_sharding.py's (arch, shape) grid and ``batch_specs`` likewise; every
  spec divides the production axes (the twins of test_sharding.py's checks);
* ``compressed_psum`` in four gloo processes equals the reference under
  ``jax.vmap(axis_name=...)`` bit for bit, an all-zero rank included;
* ``reshard`` onto a CPU (1, 1) mesh keeps every byte and lays each leaf out
  as ``named`` says; ``constrain`` is the identity without a mesh and
  redistributes a DTensor under one.
"""
import multiprocessing
import queue as queue_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs.base import all_arch_names, get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES, cell_supported as jcell_supported
from repro.models.model_zoo import build as jbuild
from repro.sharding import partition as jpart
from repro.sharding.collectives import compressed_psum as jcompressed_psum
from repro_torch.checkpoint.ckpt import _leaves, reshard
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import fake_world, host_mesh, make_host_mesh, make_production_mesh
from repro_torch.models.model_zoo import build
from repro_torch.sharding import partition
from repro_torch.sharding.partition import P

AXES = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMultiPodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _spec_leaves(tree):
    """The port's specs in ``jax.tree`` leaf order."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for v in tree for s in _spec_leaves(v)]


def _jax_spec_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _check_divisible(specs, leaves, what):
    problems = []
    for spec, leaf in zip(specs, leaves):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            n = int(np.prod([AXES[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
            if dim >= len(leaf.shape) or leaf.shape[dim] % n:
                problems.append(f"{what}: {tuple(leaf.shape)} dim{dim} % {n} != 0 ({ax})")
    return problems


@pytest.mark.parametrize("arch", all_arch_names())
def test_param_specs_and_meta_init_match_reference(arch):
    """Specs ``==`` leaf by leaf (``tuple(PartitionSpec) == P``); the meta
    init's leaves have the reference's names, shapes and dtypes; nothing is
    allocated; every spec divides the production axes."""
    sds = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    params = build(get_config(arch), device="meta").init(0)
    ref_leaves = jax.tree_util.tree_leaves_with_path(sds)
    port_leaves = list(_leaves(params))
    assert [jax.tree_util.keystr(p, simple=True, separator="/") for p, _ in ref_leaves] == \
        [name for name, _ in port_leaves]
    for (_, a), (name, b) in zip(ref_leaves, port_leaves):
        assert b.device.type == "meta"
        assert (tuple(a.shape), str(a.dtype)) == (tuple(b.shape), str(b.dtype).split(".")[1]), name
    ref_specs = _jax_spec_leaves(jpart.param_specs(sds))
    port_specs = _spec_leaves(partition.param_specs(params))
    assert [tuple(s) for s in ref_specs] == port_specs
    assert all(isinstance(s, P) for s in port_specs)
    problems = _check_divisible(port_specs, [b for _, b in port_leaves], arch)
    assert not problems, problems[:5]


CACHE_GRID = [(a, s) for a in ("qwen2.5-14b", "deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m",
                               "seamless-m4t-medium")
              for s in ("decode_32k", "long_500k")
              if jcell_supported(jget(a), JSHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape_name", CACHE_GRID)
def test_cache_specs_match_reference(arch, shape_name):
    """``cache_specs`` on the port's meta caches ``==`` the reference's on
    ``jax.eval_shape``'s, leaf by leaf, on the 16x16 axes; each divides."""
    shape = SHAPES[shape_name]
    jmodel = jbuild(jget(arch))
    ref_caches = jax.eval_shape(lambda: jmodel.init_caches(None, shape.global_batch,
                                                           shape.seq_len))
    caches = build(get_config(arch), device="meta").init_caches(None, shape.global_batch,
                                                                 shape.seq_len)
    ref_specs = _jax_spec_leaves(jpart.cache_specs(ref_caches, jget(arch), FakeMesh(),
                                                   shape.global_batch))
    port_specs = _spec_leaves(partition.cache_specs(caches, get_config(arch), FakeMesh(),
                                                    shape.global_batch))
    assert [tuple(s) for s in ref_specs] == port_specs
    leaves = [leaf for _, leaf in _leaves(caches)]
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(ref_caches)]
    problems = _check_divisible(port_specs, leaves, f"{arch}/{shape_name}")
    assert not problems, problems[:5]


@pytest.mark.parametrize("mesh", [FakeMesh(), FakeMultiPodMesh()], ids=["pod", "multipod"])
def test_batch_specs_match_reference(mesh):
    """The leading dim over the DP axes where it divides, over 'data' alone
    where only that divides, else replicated, as the reference's."""
    shapes = {"tokens": (256, 4096), "odd": (7, 3), "sixteen": (16, 8), "scalar": ()}
    ref = jpart.batch_specs({k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in shapes.items()},
                            mesh)
    port = partition.batch_specs({k: torch.empty(v, device="meta") for k, v in shapes.items()},
                                 mesh)
    assert {k: tuple(v) for k, v in ref.items()} == port
    if len(mesh.axis_names) == 3:
        assert port["tokens"] == P(("pod", "data"), None) and port["odd"] == P(None, None)


def test_placements_follow_jax_axis_order():
    """A dim over ("pod", "data") is ``Shard(d)`` on both mesh dims (DTensor
    splits in mesh order: pod major, as JAX); axes out of the mesh's order,
    an axis that shards two dims, or one the mesh lacks are refused."""
    mesh = FakeMultiPodMesh()
    assert partition.placements(mesh, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert partition.placements(mesh, P()) == (Replicate(),) * 3
    assert partition.named(mesh, {"a": P("data"), "b": [P(None, "model")]}) == \
        {"a": (Replicate(), Shard(0), Replicate()), "b": [(Replicate(), Replicate(), Shard(1))]}
    with pytest.raises(ValueError, match="order"):
        partition.placements(mesh, P(("data", "pod")))
    with pytest.raises(ValueError, match="two dims"):
        partition.placements(mesh, P("data", "data"))
    with pytest.raises(ValueError):
        partition.placements(FakeMesh(), P("pod"))


def test_constrain_identity_without_mesh_and_redistributes_under_one():
    """Without an active mesh (and on plain tensors) ``constrain`` and
    ``cache_constrain`` return their input; under ``use_mesh`` a DTensor is
    laid out as the reference's ``with_sharding_constraint`` would pin it,
    axes absent from the mesh or not dividing their dim left replicated."""
    x = torch.zeros(4, 6)
    assert partition.constrain(x, ("pod", "data"), "model") is x
    assert partition.cache_constrain(x) is x
    with fake_world(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        with partition.use_mesh(mesh):
            assert partition.constrain(x, ("pod", "data"), None) is x
            d = DTensor.from_local(torch.zeros(4, 6, 8, 2, device="meta"), mesh,
                                   [Replicate(), Replicate()])
            y = partition.constrain(d, ("pod", "data"), None, "model")
            assert tuple(y.placements) == (Shard(0), Shard(2))
            c = partition.cache_constrain(d)         # (B, H, S, dh): heads over model
            assert tuple(c.placements) == (Shard(0), Shard(1))
            odd = DTensor.from_local(torch.zeros(3, 5, device="meta"), mesh,
                                     [Replicate(), Replicate()])
            assert partition.constrain(odd, "data", "model") is odd
        assert partition.active_mesh() is None


CASES = [
    ("float32, rank 2 all zero", 0, np.float32),
    ("float32 wide range, rank 0 all zero", 1, np.float32),
    ("bfloat16, rank 3 all zero", 2, jnp.bfloat16),
]


def _case_input(seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 1031)) * rng.choice([1e-3, 1.0, 50.0], (4, 1))).astype(np.float32)
    x[[2, 0, 3][seed]] = 0.0
    return x


def test_compressed_psum_matches_reference_in_four_gloo_ranks(tmp_path):
    """Four gloo processes (a ``FileStore`` under ``tmp_path``, a 60 s
    timeout on the group, 120 s on each join): every rank's result equals
    the reference's ``compressed_psum`` under ``jax.vmap(axis_name="i")`` bit
    for bit, for float32 and bfloat16 inputs, each with an all-zero rank."""
    from torch_gloo_worker import compressed_psum_rank

    inputs = [_case_input(seed) for _, seed, _ in CASES]
    want = []
    for x, (_, _, dtype) in zip(inputs, CASES):
        out = jax.vmap(lambda v: jcompressed_psum(v, "i"), axis_name="i")(jnp.asarray(x, dtype))
        want.append(np.asarray(out))
    torch_dtypes = [torch.float32, torch.float32, torch.bfloat16]
    cases = [(x, dt) for x, dt in zip(inputs, torch_dtypes)]
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=compressed_psum_rank,
                         args=(r, 4, str(tmp_path / "store"), cases, q)) for r in range(4)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = q.get(timeout=120)
            got[rank] = out
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    assert sorted(got) == [0, 1, 2, 3]
    for i, (name, _, _) in enumerate(CASES):
        for rank in range(4):
            assert got[rank][i].dtype == np.float32, name
            np.testing.assert_array_equal(got[rank][i], want[i][rank],
                                          err_msg=f"{name}, rank {rank}")


def test_reshard_on_a_cpu_mesh_keeps_every_byte():
    """``reshard`` onto a CPU (1, 1) mesh: DTensors laid out as ``named``
    says, their local tensors ``==`` the input; the group ``host_mesh``
    started is destroyed at the block's end."""
    import torch.distributed as dist

    cfg = get_config("qwen2.5-14b").reduced(vocab=512)
    params = build(cfg, device="cpu").init(0)
    specs = partition.param_specs(params)
    assert not dist.is_initialized()
    with host_mesh(1, 1, device="cpu") as mesh:
        assert dist.get_backend() == "gloo" and tuple(mesh.shape) == (1, 1)
        placed = reshard(params, mesh, specs)
        want = [partition.placements(mesh, s) for s in _spec_leaves(specs)]
        for (name, x), (_, y), lay in zip(_leaves(params), _leaves(placed), want):
            assert isinstance(y, DTensor) and tuple(y.placements) == lay, name
            local = y.to_local()
            assert local.dtype == x.dtype and torch.equal(local.view(torch.uint8),
                                                          x.view(torch.uint8)), name
    assert not dist.is_initialized()


def test_meshes_need_their_ranks():
    """``make_production_mesh`` needs a default group of 256 (512) ranks and
    builds (16, 16) ("data", "model") or (2, 16, 16) over a fake one;
    ``make_host_mesh`` clips to the ranks that exist; ``host_mesh`` leaves
    an existing group alone; ``fake_world`` refuses to stack."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="default process group"):
        make_production_mesh()
    with fake_world(512):
        pod = make_production_mesh()
        assert (tuple(pod.shape), pod.mesh_dim_names) == ((16, 16), ("data", "model"))
        multi = make_production_mesh(multi_pod=True)
        assert (tuple(multi.shape), multi.mesh_dim_names) == ((2, 16, 16),
                                                              ("pod", "data", "model"))
        assert tuple(make_host_mesh(4, 1024, device="cpu").shape) == (4, 128)
        with host_mesh(2, 2, device="cpu"):
            pass
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_world(4):
                pass
    with fake_world(8):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh()
    assert not dist.is_initialized()
