"""What the model-family parity tests share: a reduced config built in both
packages on the same parameters (the JAX package's, carried across by
``params_from_numpy``) with the same seeded inputs, and the comparisons.

Each pair's config gets its own ``name``: the JAX serving engine caches its
jitted decode step by ``cfg.name``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.model_zoo import build as jax_build
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.tree import tree_leaves

B = 2


def rel(a, b) -> float:
    """Relative max error of ``a`` against ``b`` (max |a - b| / max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def make_pair(arch: str, dtype: str, seq: int, **extra) -> dict:
    """Both packages' reduced ``arch`` at compute ``dtype`` (QKV biases made
    non-zero so that they count), the JAX parameters as numpy (``tree``) and
    on both sides, and inputs from ``default_rng(1)``: ``tokens`` (B, seq),
    ``frames`` (B, seq, D) for the encoder-decoder, ``vision`` (B,
    vision_prefix, D) for the VLM."""
    tag = "-".join(f"{k}{v}" for k, v in sorted(extra.items()))
    kw = dict(compute_dtype=dtype, name=f"{arch}-{dtype}-{tag}-family-parity", **extra)
    jcfg, tcfg = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    attn = tree.get("layers", {}).get("attn", {})
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    m = {"jcfg": jcfg, "tcfg": tcfg, "jm": jm, "tm": tm, "tree": tree,
         "jp": jax.tree.map(jnp.asarray, tree), "tp": params_from_numpy(tree, device="cpu"),
         "tokens": rng.integers(0, jcfg.vocab, (B, seq)).astype(np.int32)}
    if jcfg.is_encdec:
        m["frames"] = rng.standard_normal((B, seq, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        m["vision"] = rng.standard_normal((B, jcfg.vision_prefix, jcfg.d_model)).astype(np.float32)
    return m


def batches(m: dict):
    """The forward's batch for each package: (JAX, port)."""
    jb, tb = {"tokens": jnp.asarray(m["tokens"])}, {"tokens": torch.from_numpy(m["tokens"])}
    for key, name in (("frames", "frames"), ("vision", "vision_embeds")):
        if key in m:
            jb[name], tb[name] = jnp.asarray(m[key]), torch.from_numpy(m[key])
    return jb, tb


def forward_pair(m: dict):
    """(port logits as numpy float32, reference logits as numpy)."""
    jb, tb = batches(m)
    want, _ = m["jm"].forward(m["jp"], jb)
    got, aux = m["tm"].forward(m["tp"], tb)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert tuple(got.shape) == (*m["tokens"].shape, m["tcfg"].padded_vocab)
    return got.numpy(), np.asarray(want)


def decode_pair(m: dict, jc, tc, steps: int):
    """``steps`` decode steps of ``m["tokens"]`` from the given caches in
    both packages: the worst relative logits error and the final caches."""
    worst = 0.0
    for t in range(steps):
        tok = m["tokens"][:, t:t + 1]
        want, jc = m["jm"].decode_step(m["jp"], {"tokens": jnp.asarray(tok),
                                                 "pos": jnp.asarray(t, jnp.int32)}, jc)
        got, tc = m["tm"].decode_step(m["tp"], {"tokens": torch.from_numpy(tok), "pos": t}, tc)
        assert tuple(got.shape) == (B, 1, m["tcfg"].padded_vocab)
        worst = max(worst, rel(got.numpy(), want))
    return worst, jc, tc


def assert_caches_close(tc, jc, tol: float = 1e-5) -> None:
    """Same tree, shapes and dtypes; every leaf within ``tol`` (rtol = atol)."""
    assert jax.tree.structure(jax.tree.map(lambda t: 0, jc)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, tc))
    for g, w in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32), rtol=tol, atol=tol)


def port_decode_logits(model, params, tokens: torch.Tensor, caches) -> torch.Tensor:
    """The port's token-by-token decode logits (B, S, V) from ``caches``."""
    out = []
    for t in range(tokens.shape[1]):
        lg, caches = model.decode_step(params, {"tokens": tokens[:, t:t + 1], "pos": t}, caches)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)
