"""The elastic-restore twin (``scripts/elastic_restore.py --quick``) against
the JAX package's ``examples/elastic_restore.py`` flow, on the CPU.

Both start from the reference's parameters (``init_train_state`` with key 0,
carried across by ``interop.train_state_from_numpy``) and run the example's
quick configuration: xLSTM-125M reduced (vocab 512), 32 tokens, batch 4,
2 steps, publish, restore through a new ``Orchestrator``, ``reshard`` onto
a (1, 1) mesh, 2 more steps.  The config computes in float32 here (its own
bf16 compute is held within 3e-2 by test_torch_ssm.py), so that the losses
of both phases are held to the train tests' float32 limit, 1e-5 relative.
The port's re-sharded parameters are ``==`` the ones it checkpointed, as
the reference's are.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.ckpt import reshard as jreshard
from repro.checkpoint.ckpt import restore_checkpoint as jrestore
from repro.checkpoint.ckpt import save_checkpoint as jsave
from repro.configs.base import get_config as jget
from repro.core import HierarchicalPool as JPool
from repro.core import Orchestrator as JOrchestrator
from repro.core import PoolMaster as JMaster
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models.model_zoo import build as jbuild
from repro.sharding.partition import param_specs as jparam_specs
from repro.train.trainstep import TrainState as JTrainState
from repro.train.trainstep import init_train_state as jinit_train_state
from repro.train.trainstep import make_train_step as jmake_train_step
from repro_torch.configs.base import get_config
from repro_torch.interop import train_state_from_numpy
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import elastic_restore  # noqa: E402

SEQ, BATCH, STEPS = 32, 4, 2


def _reference(cfg):
    """The example's flow, returning its losses and restored parameters."""
    model = jbuild(cfg)
    data = JData(JDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    step = jax.jit(jmake_train_step(model))
    state = jinit_train_state(model, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    losses1, losses2 = [], []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        losses1.append(float(m["loss"]))
    pool = JPool(1 << 30, 2 << 30)
    master = JMaster(pool)
    jsave(master, "elastic", {"params": state.params, "opt": state.opt}, step=STEPS)
    orch = JOrchestrator("new-fleet-host", pool, master.catalog)
    restored, _ = jrestore(orch, "elastic", {"params": state.params, "opt": state.opt})
    placed = jreshard(restored["params"], jmake_host_mesh(1, 1),
                      jparam_specs(restored["params"]))
    checkpointed = jax.tree.map(np.asarray, state.params)
    state2 = JTrainState(placed, restored["opt"])
    for i in range(STEPS, 2 * STEPS):
        state2, m = step(state2, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        losses2.append(float(m["loss"]))
    return start, losses1, losses2, checkpointed, jax.tree.map(np.asarray, placed)


@pytest.fixture(scope="module")
def both():
    f32 = {"compute_dtype": "float32"}
    start, l1, l2, ckpt, placed = _reference(
        dataclasses.replace(jget("xlstm-125m").reduced(vocab=512), **f32))
    port = elastic_restore.run(
        dataclasses.replace(get_config("xlstm-125m").reduced(vocab=512), **f32), SEQ, BATCH,
        STEPS, device="cpu", state=train_state_from_numpy(start, device="cpu"))
    return {"losses1": l1, "losses2": l2, "checkpointed": ckpt, "placed": placed}, port


def test_losses_match_reference(both):
    ref, port = both
    assert len(port["losses1"]) == len(port["losses2"]) == STEPS
    np.testing.assert_allclose(port["losses1"], ref["losses1"], rtol=1e-5)
    np.testing.assert_allclose(port["losses2"], ref["losses2"], rtol=1e-5)
    assert all(np.isfinite(port["losses1"] + port["losses2"]))


def test_resharded_params_equal_the_checkpointed_ones(both):
    """Bit for bit within each package; the two packages' checkpointed
    parameters agree within the float32 limit."""
    ref, port = both
    assert port["reshard_bit_equal"]
    assert all(type(p).__name__ == "DTensor" for p in tree_leaves(port["placed"]))
    for a, b in zip(jax.tree.leaves(ref["checkpointed"]), jax.tree.leaves(ref["placed"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(ref["checkpointed"]), tree_leaves(port["checkpointed"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6)
    stats = port["restore_stats"]
    assert stats["meta"]["step"] == STEPS and stats["time_to_hot_s"] <= stats["time_to_full_s"]
