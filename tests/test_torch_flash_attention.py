"""The port's flash attention (its CPU dispatch and both plain versions)
against the JAX package: ``flash_attention_pallas`` in interpret mode with
128-blocks and its oracles, on numpy inputs from a seed.

Tolerances: float32 2e-5 (summation order only); bfloat16 2e-2 against the
Pallas kernel (the JAX package's own ``test_bf16`` bound), and one bf16
rounding, 2^-8 |want| + 1e-4, against the float32 oracle on the upcast inputs
(the limit ``chip_smoke.py`` and the card tests hold the CUDA kernel to).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.ref import chunked_attention_ref as jax_chunked_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import CHUNKED_THRESHOLD, attention_ref, chunked_attention_ref
from repro_torch.kernels.flash_attention.ops import _check_cuda

SWEEP = [
    (1, 4, 4, 128, 128, 64, 64),      # MHA
    (2, 8, 2, 256, 256, 64, 64),      # GQA 4:1
    (1, 4, 1, 128, 256, 64, 64),      # MQA, chunked-prefill (Sq<Skv)
    (1, 2, 2, 128, 128, 192, 128),    # MLA-style dk != dv
]


def _qkv(seed, b, hq, hkv, sq, skv, dk, dv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dk)).astype(dtype),
            rng.standard_normal((b, hkv, skv, dk)).astype(dtype),
            rng.standard_normal((b, hkv, skv, dv)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _share_of_bf16_limit(got, want):
    """Worst |got - want| / (2^-8 |want| + 1e-4): at most 1 for a float32
    ``want`` rounded once to bf16 (half an ulp is at most 2^-8 of the value)."""
    want = torch.as_tensor(np.array(want, np.float32))
    return float(((got.float() - want).abs() / (2.0 ** -8 * want.abs() + 1e-4)).max())


@pytest.mark.parametrize("shape", SWEEP, ids=["mha", "gqa4", "mqa-sq<skv", "dk192-dv128"])
@pytest.mark.parametrize("causal", [True, False])
def test_sweep_matches_pallas_kernel(shape, causal):
    q, k, v = _qkv(4, *shape)
    want = np.asarray(flash_attention_pallas(q, k, v, causal=causal, interpret=True,
                                             block_q=128, block_k=128))
    tq, tk, tv = _t(q, k, v)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before          # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for fn in (attention_ref, lambda *a, **kw: chunked_attention_ref(*a, block_k=128, **kw)):
        np.testing.assert_allclose(fn(tq, tk, tv, causal=causal).numpy(), want,
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SWEEP[1:3], ids=["gqa4", "mqa-sq<skv"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_jax_oracles(shape, causal):
    q, k, v = _qkv(7, *shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(attention_ref(tq, tk, tv, causal=causal).numpy(),
                               np.asarray(jax_attention_ref(jq, jk, jv, causal=causal)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        chunked_attention_ref(tq, tk, tv, causal=causal, block_k=96).numpy(),
        np.asarray(jax_chunked_ref(jq, jk, jv, causal=causal, block_k=96)),
        rtol=2e-5, atol=2e-5)


def test_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 4, 128, 64)), jnp.bfloat16) for _ in range(3))
    want = np.asarray(flash_attention_pallas(q, k, v, causal=True, interpret=True,
                                             block_q=128, block_k=128).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
    exact = jax_attention_ref(*(a.astype(jnp.float32) for a in (q, k, v)), causal=True)
    assert _share_of_bf16_limit(got, exact) <= 1


@pytest.mark.parametrize("fault", ["truncate", "bf16-compute", "tile-loss-1pct"])
def test_bf16_limit_rejects_what_one_rounding_does_not_explain(fault):
    """The one-rounding limit passes the float32 result rounded to nearest
    and fails an output truncated to bf16, attention computed in bf16, and
    one 64-row tile scaled by 0.99; the 2e-2 bound passes all of them."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(17, 1, 8, 2, 512, 512, 128, 128))
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    assert _share_of_bf16_limit(want.to(torch.bfloat16), want) <= 1
    if fault == "truncate":
        bad = (want.view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)
    elif fault == "bf16-compute":
        kk, vv = k.repeat_interleave(4, 1), v.repeat_interleave(4, 1)
        s = (q @ kk.transpose(-1, -2)) * 128 ** -0.5
        s = s.masked_fill(torch.ones(512, 512, dtype=torch.bool).triu(1), float("-inf"))
        bad = torch.softmax(s, -1) @ vv
    else:
        bad = want.clone()
        bad[:, :, 128:192] *= 0.99
        bad = bad.to(torch.bfloat16)
    assert _share_of_bf16_limit(bad, want) > 1
    assert torch.allclose(bad.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_oracle(causal):
    """Lengths no block divides (the Pallas kernel refuses them; the port's
    kernel masks them), against the JAX oracle."""
    q, k, v = _qkv(9, 1, 6, 2, 100, 300, 48, 40)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(flash_attention(tq, tk, tv, causal=causal).numpy(), want,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(chunked_attention_ref(tq, tk, tv, causal=causal, block_k=64)
                               .numpy(), want, rtol=2e-5, atol=2e-5)


def test_above_chunked_threshold_takes_chunked_path():
    skv = CHUNKED_THRESHOLD + 256
    q, k, v = _qkv(11, 1, 4, 2, 64, skv, 32, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk, tv, causal=True).numpy()
    np.testing.assert_array_equal(got, chunked_attention_ref(tq, tk, tv, causal=True).numpy())
    np.testing.assert_allclose(got, np.asarray(jax_chunked_ref(jq, jk, jv, causal=True)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_attention_ref(jq, jk, jv, causal=True)),
                               rtol=2e-5, atol=2e-5)


def test_explicit_scale():
    q, k, v = _qkv(13, 1, 2, 2, 32, 32, 16, 16)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True, scale=0.3))
    np.testing.assert_allclose(flash_attention(*_t(q, k, v), scale=0.3).numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["dtype", "mixed-dtype", "group", "head-dim", "causal-sq>skv",
                                  "dk-mismatch"])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(case):
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q, k, v, causal = z(1, 4, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), True
    if case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed-dtype":
        k = k.bfloat16()
    elif case == "group":
        q = z(1, 3, 8, 16)
    elif case == "head-dim":
        q, k = z(1, 4, 8, 320), z(1, 2, 8, 320)
    elif case == "causal-sq>skv":
        q = z(1, 4, 9, 16)
    else:
        k = z(1, 2, 8, 8)
    with pytest.raises(ValueError):
        _check_cuda(q, k, v, causal)
    _check_cuda(z(1, 4, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 24), True)   # Dv != Dk is fine
