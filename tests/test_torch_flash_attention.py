"""The port's flash attention (its CPU dispatch and both plain versions)
against the JAX package: ``flash_attention_pallas`` in interpret mode with
128-blocks and its oracles, on numpy inputs from a seed.

Tolerances: float32 2e-5 (summation order only); bfloat16 2e-2 against the
Pallas kernel (the JAX package's own ``test_bf16`` bound), and one bf16
rounding, 2^-8 |want| + 1e-4, against the float32 oracle on the upcast inputs
(the limit ``chip_smoke.py`` and the card tests hold the CUDA kernels to).

The tensor-core kernel (``csrc/flash_attention_sm90.cu``) cannot run here;
``_sm90_arithmetic`` repeats its arithmetic in plain torch (128-key tiles in
order, online base-2 softmax in float32, P split into bf16 hi + lo against
bf16 V, output rounded to bf16) so that its numerical design is held to the same
limit, and ``route``, the rule that picks a kernel, is a pure function of
dtypes, shapes and strides that runs without a card.
"""
import contextlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.ref import chunked_attention_ref as jax_chunked_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import CHUNKED_THRESHOLD, attention_ref, chunked_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import _check_cuda, route

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


def _round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _sm90_arithmetic(q, k, v, causal, p_as="split", block=128):
    """The sm90 kernel's arithmetic on bf16 q, k, v: scores in float32 times
    scale * log2(e) after the product, 128-key tiles in order with the online
    softmax in base 2 (mask -1e30), P fed to the P.V product as ``p_as`` says
    ("split": bf16(P) + bf16(P - bf16(P)), the kernel's; "bf16" or "tf32": P
    rounded), products of bf16 values summed in float32, output rounded to
    bf16."""
    b, hq, sq, _ = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    kk, vv = k.repeat_interleave(group, 1).float(), v.repeat_interleave(group, 1).float()
    scale_log2 = torch.tensor(q.shape[3] ** -0.5 * np.log2(np.e), dtype=torch.float32)
    qpos = torch.arange(sq) + (skv - sq)
    m = torch.full((b, hq, sq), -1e30)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, v.shape[3]))
    for k0 in range(0, skv, block):
        s = (q.float() @ kk[:, :, k0:k0 + block].transpose(-1, -2)) * scale_log2
        if causal:
            kpos = torch.arange(k0, min(k0 + block, skv))
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        vt = vv[:, :, k0:k0 + block]
        if p_as == "split":
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt + (p - hi).to(torch.bfloat16).float() @ vt
        elif p_as == "bf16":
            pv = p.to(torch.bfloat16).float() @ vt
        else:
            pv = _round_tf32(p) @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)[..., None]).to(torch.bfloat16)


def _bf16_qkv(seed, *shape):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(seed, *shape)]


@pytest.mark.parametrize("shape,causal", [
    ((1, 4, 2, 256, 256, 128, 128), True),     # causal, GQA 2:1, two tiles
    ((1, 4, 1, 128, 384, 128, 128), True),     # ragged: Sq < Skv, suffix-aligned, MQA
    ((1, 4, 4, 128, 256, 64, 64), False),      # non-causal, D = 64
], ids=["causal", "ragged-sq<skv", "non-causal-d64"])
def test_sm90_arithmetic_matches_pallas_kernel(shape, causal):
    """The split-P design is within one bf16 rounding of the Pallas kernel's
    float32 result on the upcast inputs (interpret mode, 128-blocks)."""
    q, k, v = _bf16_qkv(21, *shape)
    want = flash_attention_pallas(*(a.float().numpy() for a in (q, k, v)), causal=causal,
                                  interpret=True, block_q=128, block_k=128)
    got = _sm90_arithmetic(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _share_of_bf16_limit(got, want) <= 1


@pytest.mark.parametrize("causal", [True, False])
def test_sm90_arithmetic_ragged_tiles_match_oracle(causal):
    """Key and query counts no tile divides (the kernel masks the zero-filled
    keys past Skv), against the JAX oracle in float32."""
    q, k, v = _bf16_qkv(23, 1, 6, 2, 100, 300, 64, 64)
    want = jax_attention_ref(*(jnp.asarray(a.float().numpy()) for a in (q, k, v)), causal=causal)
    assert _share_of_bf16_limit(_sm90_arithmetic(q, k, v, causal), want) <= 1


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


@pytest.mark.parametrize("fault", ["truncate", "bf16-compute", "tile-loss-1pct", "bf16-P",
                                   "tf32-P"])
def test_bf16_limit_rejects_what_one_rounding_does_not_explain(fault):
    """The one-rounding limit passes the float32 result rounded to nearest
    and the sm90 kernel's split-P arithmetic, and fails an output truncated
    to bf16, attention computed in bf16, one 64-row tile scaled by 0.99, and
    the kernel's arithmetic with P rounded to bf16 or to TF32 for the P.V
    product (what forces the split); the 2e-2 bound passes all of them."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(17, 1, 8, 2, 512, 512, 128, 128))
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    assert _share_of_bf16_limit(want.to(torch.bfloat16), want) <= 1
    assert _share_of_bf16_limit(_sm90_arithmetic(q, k, v, True), want) <= 1
    if fault in ("bf16-P", "tf32-P"):
        bad = _sm90_arithmetic(q, k, v, True, p_as=fault[:4])
    elif fault == "truncate":
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


def _route_case(case):
    """(q, k, v) for one case of the route rule, on the CPU (the rule reads
    dtypes, shapes, base addresses and strides only)."""
    bf = torch.bfloat16

    def z(*shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype)

    q, k, v = z(1, 4, 300, 128), z(1, 2, 300, 128), z(1, 2, 300, 128)
    if case == "d64":
        q, k, v = z(2, 3, 70, 64), z(2, 1, 90, 64), z(2, 1, 90, 64)
    elif case == "model-views":      # (B, S, H, D) projections viewed as (B, H, S, D)
        q, k, v = (z(2, 300, h, 128).transpose(1, 2) for h in (6, 2, 2))
    elif case == "float32":
        q, k, v = (t.float() for t in (q, k, v))
    elif case == "dk!=dv":
        v = z(1, 2, 300, 64)
    elif case == "d256":
        q, k, v = z(1, 4, 8, 256), z(1, 2, 8, 256), z(1, 2, 8, 256)
    elif case == "d96":
        q, k, v = z(1, 4, 8, 96), z(1, 2, 8, 96), z(1, 2, 8, 96)
    elif case == "unaligned-base":   # 2 bytes past a 16-byte boundary
        k = z(1 * 2 * 300 * 128 + 1)[1:].view(1, 2, 300, 128)
    elif case == "unaligned-stride":  # rows of 68 bf16 = 136 bytes
        q = z(1, 4, 300, 68)[..., :64]
        k, v = z(1, 2, 300, 64), z(1, 2, 300, 64)
    elif case == "expanded-kv":      # stride 0 over the heads
        k = z(1, 1, 300, 128).expand(1, 2, 300, 128)
    elif case == "last-dim-strided":
        v = z(1, 2, 128, 300).transpose(2, 3)
    elif case == "skv=0":
        q, k, v = z(1, 4, 8, 128), z(1, 2, 0, 128), z(1, 2, 0, 128)
    return q, k, v


ROUTE_CASES = {"bf16-d128": "sm90", "d64": "sm90", "model-views": "sm90", "float32": "simt",
               "dk!=dv": "simt", "d256": "simt", "d96": "simt", "unaligned-base": "simt",
               "unaligned-stride": "simt", "expanded-kv": "simt", "last-dim-strided": "simt",
               "skv=0": "simt"}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_rule(case):
    """bf16 with Dk == Dv in {64, 128} and TMA-legal bases and strides go to
    the tensor-core kernel, whatever the order of the strides (the model's
    transposed views take no copy); everything else to the SIMT kernel."""
    q, k, v = _route_case(case)
    assert route(q, k, v) == ROUTE_CASES[case]


def test_launch_counters_by_route(monkeypatch):
    """The wrapper launches the kernel ``route`` names, counts it under that
    route and in the sum, and never tries the other one.  Meta tensors stand
    in for CUDA tensors (the dispatch reads metadata only); the bindings are
    replaced by recorders."""
    calls = []
    monkeypatch.setattr(ops.kernel, "flash_attention_sm90", lambda *a: calls.append("sm90"))
    monkeypatch.setattr(ops.kernel, "flash_attention", lambda *a: calls.append("simt"))
    monkeypatch.setattr(ops.torch.cuda, "device", lambda d: contextlib.nullcontext())
    saved = (flash_attention.launches, ops.launches_by_route())
    try:
        ops.reset_launches()
        for case in ("bf16-d128", "model-views", "float32", "dk!=dv", "d64"):
            q, k, v = (t.to("meta") for t in _route_case(case))
            out = flash_attention(q, k, v, causal=True)
            assert out.shape == (*q.shape[:3], v.shape[3]) and out.dtype == q.dtype
        assert calls == ["sm90", "sm90", "simt", "simt", "sm90"]
        assert ops.launches_by_route() == {"sm90": 3, "simt": 2}
        assert flash_attention.launches == 5
        ops.reset_launches()
        assert flash_attention.launches == 0 and ops.launches_by_route() == {"sm90": 0, "simt": 0}
    finally:
        flash_attention.launches = saved[0]
        for name, n in saved[1].items():
            setattr(flash_attention, f"launches_{name}", n)
