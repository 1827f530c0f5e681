"""The port's flash attention (its CPU dispatch and both plain versions)
against the JAX package: ``flash_attention_pallas`` in interpret mode with
128-blocks and its oracles, on numpy inputs from a seed.

Tolerances: float32 2e-5 (summation order only); bfloat16 2e-2 against the
Pallas kernel (the JAX package's own ``test_bf16`` bound), and one bf16
rounding, 2^-8 |want| + 1e-4, against the float32 oracle on the upcast inputs
(the limit ``chip_smoke.py`` and the card tests hold the CUDA kernels to).

The backward (``FlashAttentionFn``): on CPU tensors its plain version
``flash_attention_bwd_ref`` against autograd through ``attention_ref``
(float32, within 1e-5 max|want|) and the dispatch's gradients against
``jax.grad`` through the JAX reference (float32 within 1e-4 max|want| + 1e-6,
bf16 within 2^-6 max|want| + 1e-4, per gradient tensor); the CUDA kernel is
held to the same limits on the card (``tests/test_torch_gpu.py``).

The tensor-core kernel (``csrc/flash_attention_sm90.cu``) cannot run here;
``_sm90_arithmetic`` repeats its arithmetic in plain torch (128-key tiles in
order, online base-2 softmax in float32, P split into bf16 hi + lo against
bf16 V, output rounded to bf16) so that its numerical design is held to the same
limit, and ``route``, the rule that picks a kernel, is a pure function of
dtypes, shapes and strides that runs without a card.  The same for the
tensor-core backward (``csrc/flash_attention_bwd_sm90.cu``):
``_sm90_bwd_arithmetic`` repeats its tile order and roundings (float32
scores, P and dS rounded to bf16 into float32 accumulators, the query heads
of a group in order, lse converted to log2 units once a row) against
``jax.grad`` within the bf16 limit, and ``bwd_route`` picks its kernel.
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
    (1, 4, 2, 256, 256, 80, 80),      # Zamba2's 80-wide heads, GQA 2:1
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
    """The sm90 kernel's arithmetic on bf16 q, k (Dk wide), v (Dv wide):
    scores in float32 times scale * log2(e) after the product (scale Dk^-0.5,
    ``flash_attention``'s default and the 192^-0.5 MLA passes),
    128-key tiles in order with the online softmax in base 2 (mask -1e30), P
    fed to the P.V product as ``p_as`` says ("split": bf16(P) + bf16(P -
    bf16(P)), the kernel's; "bf16" or "tf32": P rounded), products of bf16
    values summed in float32, output rounded to bf16."""
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
    ((1, 4, 2, 256, 256, 192, 128), True),     # MLA's Dk = 192, Dv = 128: causal, GQA 2:1
    ((1, 4, 1, 128, 384, 192, 128), True),     # MLA's widths, ragged Sq < Skv, MQA
    ((1, 4, 2, 256, 256, 80, 80), True),       # Zamba2's D = 80: causal, GQA 2:1
    ((1, 4, 1, 128, 384, 80, 80), True),       # D = 80, ragged Sq < Skv, MQA
    ((1, 4, 4, 128, 256, 80, 80), False),      # D = 80, non-causal
], ids=["causal", "ragged-sq<skv", "non-causal-d64", "mla-causal-gqa", "mla-ragged-sq<skv",
        "d80-causal-gqa", "d80-ragged-sq<skv", "d80-non-causal"])
def test_sm90_arithmetic_matches_pallas_kernel(shape, causal):
    """The split-P design is within one bf16 rounding of the Pallas kernel's
    float32 result on the upcast inputs (interpret mode, 128-blocks), at
    Dk == Dv (Zamba2's 80 included) and at MLA's Dk = 192, Dv = 128 (all at
    the default scale Dk^-0.5, the one MLA passes)."""
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


@pytest.mark.parametrize("shape", [(1, 6, 2, 200, 330, 80, 80), (2, 4, 4, 130, 131, 80, 80),
                                   (1, 4, 1, 1, 160, 80, 80)],
                         ids=["gqa3-sq<skv", "past-one-tile", "one-row"])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_arithmetic_d80_ragged_tiles_match_oracle(shape, causal):
    """At Zamba2's D = 80: Sq and Skv past a 128-row tile and no tile divides
    (GQA 3:1, Sq < Skv), one key past a tile, and one query row over 160
    keys, against the JAX oracle in float32 within one bf16 rounding."""
    q, k, v = _bf16_qkv(29, *shape)
    want = jax_attention_ref(*(jnp.asarray(a.float().numpy()) for a in (q, k, v)), causal=causal)
    assert _share_of_bf16_limit(_sm90_arithmetic(q, k, v, causal), want) <= 1


@pytest.mark.parametrize("shape", SWEEP, ids=["mha", "gqa4", "mqa-sq<skv", "dk192-dv128",
                                              "d80-gqa"])
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
    elif case == "mla":              # DeepSeek-V3's Dk = 128 + 64, Dv = 128
        q, k, v = z(1, 4, 300, 192), z(1, 4, 300, 192), z(1, 4, 300, 128)
    elif case == "mla-model-views":  # as models/attention.py's _mla_qkv makes them
        kvu = z(2, 300, 4, 256).transpose(1, 2)            # the up-projection (B, h, S, 128 + 128)
        rope = z(2, 1, 300, 64).expand(2, 4, 300, 64)
        q = torch.cat([z(2, 300, 4, 192).transpose(1, 2)[..., :128], rope], dim=-1)
        k = torch.cat([kvu[..., :128], rope], dim=-1)
        v = kvu[..., 128:]                                 # 256 bytes into each row
    elif case == "dk192-dv192":
        q, k, v = z(1, 4, 300, 192), z(1, 2, 300, 192), z(1, 2, 300, 192)
    elif case == "d80":              # Zamba2's shared attention: rows of 160 bytes
        q, k, v = z(1, 4, 300, 80), z(1, 2, 300, 80), z(1, 2, 300, 80)
    elif case == "d80-model-views":  # as models/attention.py hands them over
        q, k, v = (z(2, 300, h, 80).transpose(1, 2) for h in (6, 2, 2))
    elif case == "d80-float32":
        q, k, v = z(1, 4, 300, 80, dtype=torch.float32), z(1, 2, 300, 80, dtype=torch.float32), \
            z(1, 2, 300, 80, dtype=torch.float32)
    elif case == "d80-dv64":
        q, k, v = z(1, 4, 300, 80), z(1, 2, 300, 80), z(1, 2, 300, 64)
    elif case == "d32":              # the quickstart twin's heads
        q, k, v = z(1, 4, 300, 32), z(1, 2, 300, 32), z(1, 2, 300, 32)
    elif case == "d80-unaligned-base":   # 2 bytes past a 16-byte boundary
        q, v = z(1, 4, 300, 80), z(1, 2, 300, 80)
        k = z(1 * 2 * 300 * 80 + 1)[1:].view(1, 2, 300, 80)
    return q, k, v


ROUTE_CASES = {"bf16-d128": "sm90", "d64": "sm90", "model-views": "sm90", "float32": "simt",
               "dk!=dv": "simt", "d256": "simt", "d96": "simt", "unaligned-base": "simt",
               "unaligned-stride": "simt", "expanded-kv": "simt", "last-dim-strided": "simt",
               "skv=0": "simt", "mla": "sm90", "mla-model-views": "sm90", "dk192-dv192": "simt",
               "d80": "sm90", "d80-model-views": "sm90", "d80-float32": "simt",
               "d80-dv64": "simt", "d32": "simt", "d80-unaligned-base": "simt"}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_rule(case):
    """bf16 with (Dk, Dv) in {(64, 64), (80, 80), (128, 128), (192, 128)} and
    TMA-legal bases and strides go to the tensor-core kernel, whatever the
    order of the strides (the model's transposed views, and MLA's v 256 bytes
    into the up-projection's rows, take no copy); everything else to the SIMT
    kernel: float32, other pairs ((128, 64), (80, 64), (96, 96), (32, 32),
    (192, 192)), unaligned views."""
    q, k, v = _route_case(case)
    assert route(q, k, v) == ROUTE_CASES[case]


def test_launch_counters_by_route(monkeypatch):
    """The wrapper launches the kernel ``route`` names, counts it under that
    route and in the sum, and never tries the other one.  Meta tensors stand
    in for CUDA tensors (the dispatch reads metadata only; the plain-version
    devices are narrowed to the CPU, since the dry run sends meta tensors to
    the plain versions); the bindings are replaced by recorders."""
    calls = []
    monkeypatch.setattr(ops, "_PLAIN_DEVICES", ("cpu",))
    monkeypatch.setattr(ops.kernel, "flash_attention_sm90", lambda *a: calls.append("sm90"))
    monkeypatch.setattr(ops.kernel, "flash_attention", lambda *a: calls.append("simt"))
    monkeypatch.setattr(ops.torch.cuda, "device", lambda d: contextlib.nullcontext())
    saved = (flash_attention.launches, ops.launches_by_route())
    try:
        ops.reset_launches()
        for case in ("bf16-d128", "model-views", "float32", "dk!=dv", "d64", "mla"):
            q, k, v = (t.to("meta") for t in _route_case(case))
            out = flash_attention(q, k, v, causal=True)
            assert out.shape == (*q.shape[:3], v.shape[3]) and out.dtype == q.dtype
        assert calls == ["sm90", "sm90", "simt", "simt", "sm90", "sm90"]
        assert ops.launches_by_route() == {"sm90": 4, "simt": 2}
        assert flash_attention.launches == 6
        ops.reset_launches()
        assert flash_attention.launches == 0 and ops.launches_by_route() == {"sm90": 0, "simt": 0}
    finally:
        flash_attention.launches = saved[0]
        for name, n in saved[1].items():
            setattr(flash_attention, f"launches_{name}", n)


# -- the backward ----------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D): GQA, MHA, ragged Sq < Skv, and keys above
# CHUNKED_THRESHOLD (the CPU forward takes the chunked form there)
BWD_SHAPES = {"gqa": (1, 4, 2, 48, 48, 16), "mha": (2, 3, 3, 40, 40, 16),
              "sq<skv": (1, 4, 1, 30, 70, 16),
              "above-threshold": (1, 2, 1, 8, CHUNKED_THRESHOLD + 100, 16)}
# float32 within 1e-4 max|want| + 1e-6, bf16 within 2^-6 max|want| + 1e-4,
# per gradient tensor, against the float32 gradient of the upcast inputs (the
# limits the card holds the CUDA backward to)
BWD_TOL = {np.float32: (1e-4, 1e-6), "bf16": (2.0 ** -6, 1e-4)}


def _bwd_case(shape, dtype, seed=31):
    """q, k, v, dO of ``shape`` (B, Hq, Hkv, Sq, Skv, D) or (..., Dk, Dv)."""
    dk, dv = shape[5], shape[-1]
    q, k, v = _qkv(seed, *shape[:5], dk, dv)
    do = np.random.default_rng(seed + 1).standard_normal((*q.shape[:3], dv)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    if dtype == "bf16":
        ts = [t.to(torch.bfloat16) for t in ts]
    return ts


def _within(got, want, dtype) -> bool:
    rtol, atol = BWD_TOL[dtype]
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got.float(), np.float64) - want).max()
    return err <= rtol * np.abs(want).max() + atol


@pytest.mark.parametrize("shape", list(BWD_SHAPES), ids=list(BWD_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd(shape, causal):
    """``flash_attention_bwd_ref`` (FA2's formulas by key chunks) against
    autograd through ``attention_ref``, float32: within 1e-5 max|want|."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    q, k, v, do = _bwd_case(BWD_SHAPES[shape], np.float32)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_ref(qg, kg, vg, causal=causal), (qg, kg, vg), do)
    out, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, block_k=32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("shape", list(BWD_SHAPES), ids=list(BWD_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_autograd_function_matches_jax_grad(shape, causal, dtype):
    """``flash_attention`` under autograd on CPU tensors (``FlashAttentionFn``:
    the plain forward with its log-sum-exp, the plain backward) against
    ``jax.grad`` through the JAX reference attention on the float32 inputs;
    the CPU path launches nothing."""
    import jax

    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, do = _bwd_case(BWD_SHAPES[shape], dtype)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(qg, kg, vg, causal=causal)
    assert isinstance(out.grad_fn, ops.FlashAttentionFn._backward_cls)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    want = jax.grad(lambda a, b, c: jnp.sum(jax_attention_ref(a, b, c, causal=causal) * jdo),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _within(g, w, dtype)


# (B, Hq, Hkv, Sq, Skv, Dk, Dv): MLA's Dk > Dv (reduced DeepSeek-V3's 48 and
# 32, and 192 and 128), GQA with ragged Sq < Skv, and Dk < Dv
BWD_DK_DV_SHAPES = {"mla-reduced": (1, 4, 4, 24, 24, 48, 32),
                    "mla-192-128": (1, 2, 2, 20, 20, 192, 128),
                    "gqa-sq<skv": (2, 4, 2, 9, 30, 48, 32), "dk<dv": (1, 4, 2, 17, 17, 16, 40)}


@pytest.mark.parametrize("shape", list(BWD_DK_DV_SHAPES), ids=list(BWD_DK_DV_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_plain_backward_dk_ne_dv_matches_jax_grad(shape, causal, dtype):
    """``flash_attention_bwd_ref`` with Dk != Dv (MLA) against ``jax.grad``
    of the JAX package's reference attention on the float32 inputs (the
    limits of ``BWD_TOL``); dq, dk Dk wide, dv Dv wide; through the dispatch
    under autograd the same gradients."""
    import jax

    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    b, hq, hkv, sq, skv, dk, dv = BWD_DK_DV_SHAPES[shape]
    q, k, v = _qkv(37, b, hq, hkv, sq, skv, dk, dv)
    do = np.random.default_rng(38).standard_normal((b, hq, sq, dv)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    if dtype == "bf16":
        ts = [t.to(torch.bfloat16) for t in ts]
    q, k, v, do = ts
    scale = dk ** -0.5
    out, lse = attention_ref(q, k, v, causal=causal, scale=scale, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, scale=scale, block_k=8)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    via = torch.autograd.grad(flash_attention(qg, kg, vg, causal=causal), (qg, kg, vg), do)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    want = jax.grad(lambda a, b_, c: jnp.sum(jax_attention_ref(a, b_, c, causal=causal) * jdo),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for g, d, w, t in zip(got, via, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape == d.shape
        assert _within(g, w, dtype) and _within(d, w, dtype)


def test_forward_under_autograd_equals_the_plain_forward():
    """Under grad the forward gives the bits it gives without, and its
    log-sum-exp is ``logsumexp`` of the scaled scores."""
    q, k, v, _ = _bwd_case((1, 4, 2, 33, 50, 8), np.float32)
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    graded = flash_attention(q.clone().requires_grad_(True), k, v)
    assert torch.equal(plain, graded.detach())
    _, lse = attention_ref(q, k, v, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1)) * 8 ** -0.5
    s = s.masked_fill(torch.arange(50)[None, :] > torch.arange(33)[:, None] + 17, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    _, lse_chunked = chunked_attention_ref(q, k, v, block_k=16, return_lse=True)
    torch.testing.assert_close(lse_chunked, lse, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_counts_launches_and_refuses(monkeypatch):
    """On CUDA tensors the backward launches its kernel once (meta tensors
    stand in, the plain-version devices narrowed to the CPU; the bindings
    are recorders), takes Dk != Dv on the SIMT kernel (dO and the output at
    Dv) and refuses a dO at Dk; without keys it returns zeros and launches
    nothing."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    calls = []
    monkeypatch.setattr(ops, "_PLAIN_DEVICES", ("cpu",))
    monkeypatch.setattr(ops.kernel, "flash_attention_bwd", lambda *a: calls.append(a))
    monkeypatch.setattr(ops.kernel, "flash_attention_bwd_sm90", lambda *a: calls.append(a))
    monkeypatch.setattr(ops.torch.cuda, "device", lambda d: contextlib.nullcontext())
    before = flash_attention_bwd.launches

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    q, k, v = z(1, 4, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64)
    dq, dk, dv = flash_attention_bwd(q, k, v, z(1, 4, 8, 64), z(1, 4, 8, dtype=torch.float32),
                                     z(1, 4, 8, 64))
    assert len(calls) == 1 and flash_attention_bwd.launches == before + 1
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    simt = flash_attention_bwd.launches_simt
    dq, dk, dv = flash_attention_bwd(q, k, z(1, 2, 8, 32), z(1, 4, 8, 32),
                                     z(1, 4, 8, dtype=torch.float32), z(1, 4, 8, 32))
    assert len(calls) == 2 and flash_attention_bwd.launches_simt == simt + 1
    assert len(calls[1]) == 12 and calls[1][9].shape == (1, 2, 8, 32)       # dv at Dv
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, (1, 2, 8, 32))
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, z(1, 2, 8, 32), z(1, 4, 8, 32),
                            z(1, 4, 8, dtype=torch.float32), z(1, 4, 8, 64))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, z(1, 4, 8, 64), z(1, 4, 9, dtype=torch.float32),
                            z(1, 4, 8, 64))
    assert len(calls) == 2 and flash_attention_bwd.launches == before + 2
    flash_attention_bwd.launches = before
    flash_attention_bwd.launches_simt = simt - 1


def test_cpu_path_still_differentiates():
    """On CPU tensors the gradients through the dispatch (the plain backward)
    agree with autograd through the chunked plain form."""
    rng = np.random.default_rng(5)
    base = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 4, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8))]
    grads = []
    for fn in (lambda q, k, v: flash_attention(q, k, v, causal=True),
               lambda q, k, v: chunked_attention_ref(q, k, v, causal=True, scale=8 ** -0.5,
                                                     block_k=4)):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        fn(q, k, v).square().sum().backward()
        assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))
        grads.append([t.grad for t in (q, k, v)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# -- the tensor-core backward ----------------------------------------------------------

LOG2E = np.float32(np.log2(np.e))


def _sm90_bwd_arithmetic(q, k, v, out, lse, do, causal, scale, fault=None):
    """The sm90 backward's arithmetic on bf16 q, k (Dk wide), v, ``do`` (Dv
    wide) (``out`` the forward's bf16 output, ``lse`` its float32 log-sum-exp
    in natural units; ``scale`` the caller's): D =
    rowsum(dO * O) and lse2 = lse * log2(e) in float32 once a row; the dK/dV
    kernel by 128-key tiles, the query heads of each group in order and query
    tiles in order (64 queries, 32 at Dk = 192): S^T = K Q^T in float32, P^T =
    2^(S^T * scale * log2(e) - lse2), 0 where the causal mask drops a key,
    dP^T = V dO^T, dS^T = P^T (dP^T - D), then dV += bf16(P^T) dO and dK +=
    bf16(dS^T) Q in float32; the dQ kernel by 64-key tiles: S, dP, dS again
    and dQ += bf16(dS) K.  dK and dQ times scale, all three rounded to bf16.
    ``fault`` (for the limit's own test): "no-delta" drops the - D of dS,
    "lse-units" takes lse as if it were in log2 units."""
    b, hq, sq, d = q.shape
    hkv, skv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    group = hq // hkv
    q_tile = 32 if d > 128 else 64
    scale = torch.tensor(scale, dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    lse2 = lse if fault == "lse-units" else lse * torch.tensor(LOG2E)
    delta = (gf * out.float()).sum(-1)
    if fault == "no-delta":
        delta = torch.zeros_like(delta)
    off = skv - sq

    def bf(x):
        return x.to(torch.bfloat16).float()

    def masked(p, rows, keys):          # p (..., rows, keys)
        if not causal:
            return p
        return p.masked_fill(keys[None, :] > rows[:, None] + off, 0.0)

    dk = torch.zeros(b, hkv, skv, d)
    dv = torch.zeros(b, hkv, skv, dv_)
    for k0 in range(0, skv, 128):
        keys = torch.arange(k0, min(k0 + 128, skv))
        kt, vt = kf[:, :, k0:k0 + 128], vf[:, :, k0:k0 + 128]
        for g in range(group):
            heads = torch.arange(hkv) * group + g
            for q0 in range(0, sq, q_tile):
                q1 = q0 + q_tile
                rows = torch.arange(q0, min(q1, sq))
                qt, gt = qf[:, heads, q0:q1], gf[:, heads, q0:q1]
                st = kt @ qt.transpose(-1, -2)                         # (b, hkv, keys, rows)
                pt = torch.exp2(st * scale_log2 - lse2[:, heads, q0:q1][..., None, :])
                pt = masked(pt.transpose(-1, -2), rows, keys).transpose(-1, -2)
                dpt = vt @ gt.transpose(-1, -2)
                dst = pt * (dpt - delta[:, heads, q0:q1][..., None, :])
                dv[:, :, k0:k0 + 128] += bf(pt) @ gt
                dk[:, :, k0:k0 + 128] += bf(dst) @ qt
    kx, vx = kf.repeat_interleave(group, 1), vf.repeat_interleave(group, 1)
    rows = torch.arange(sq)
    dq = torch.zeros(b, hq, sq, d)
    for k0 in range(0, skv, 64):
        keys = torch.arange(k0, min(k0 + 64, skv))
        kt, vt = kx[:, :, k0:k0 + 64], vx[:, :, k0:k0 + 64]
        p = masked(torch.exp2(qf @ kt.transpose(-1, -2) * scale_log2 - lse2[..., None]), rows,
                   keys)
        ds = p * (gf @ vt.transpose(-1, -2) - delta[..., None])
        dq += bf(ds) @ kt
    return ((dq * scale).to(torch.bfloat16), (dk * scale).to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _sm90_bwd_case(shape, causal, seed=41):
    """bf16 q, k, v, dO of ``shape`` (B, Hq, Hkv, Sq, Skv, D or Dk, Dv), the sm90
    forward's output (``_sm90_arithmetic``) and the float32 log-sum-exp, and
    ``jax.grad`` through the JAX reference attention on the upcast inputs."""
    import jax

    q, k, v, do = _bwd_case(shape, "bf16", seed)
    out = _sm90_arithmetic(q, k, v, causal)
    _, lse = attention_ref(q.float(), k.float(), v.float(), causal=causal, return_lse=True)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    want = jax.grad(lambda a, b, c: jnp.sum(jax_attention_ref(a, b, c, causal=causal) * jdo),
                    argnums=(0, 1, 2))(jq, jk, jv)
    return (q, k, v, out, lse, do), want


# BWD_SHAPES plus GQA 3:1 at D = 128 with ragged tiles (Sq = 100 fills no
# 64-query tile, Skv = 300 no 128-key tile), MLA's Dk = 192, Dv = 128
# (32-query tiles in the dK/dV kernel): MHA, and GQA 2:1 with ragged
# Sq = 70 < Skv = 200, and Zamba2's D = 80: MHA, and GQA 2:1 with Sq = 150
# and Skv = 330 past a 128-row tile
SM90_BWD_SHAPES = {**BWD_SHAPES, "gqa3-d128-ragged": (1, 6, 2, 100, 300, 128),
                   "mla-192-128": (1, 2, 2, 96, 96, 192, 128),
                   "mla-gqa-ragged": (1, 4, 2, 70, 200, 192, 128),
                   "d80-mha": (1, 2, 2, 96, 96, 80, 80),
                   "d80-gqa-ragged": (1, 4, 2, 150, 330, 80, 80)}


@pytest.mark.parametrize("shape", list(SM90_BWD_SHAPES), ids=list(SM90_BWD_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_bwd_arithmetic_matches_jax_grad(shape, causal):
    """The tensor-core backward's arithmetic (bf16 P and dS into float32
    accumulators) within the bf16 limit, 2^-6 max|want| + 1e-4 per gradient,
    of ``jax.grad`` through the JAX reference on the upcast inputs; at MLA's
    widths dV is Dv wide and dQ, dK Dk wide."""
    args, want = _sm90_bwd_case(SM90_BWD_SHAPES[shape], causal)
    got = _sm90_bwd_arithmetic(*args, causal, args[0].shape[3] ** -0.5)
    for g, w, t in zip(got, want, args[:3]):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert _within(g, w, "bf16")


@pytest.mark.parametrize("fault", ["no-delta", "lse-units"])
def test_bf16_bwd_limit_rejects_known_faults(fault):
    """The limit the card holds the backward to fails dS without its - D
    term and lse taken in the wrong units, where the kernel's arithmetic
    passes."""
    args, want = _sm90_bwd_case(SM90_BWD_SHAPES["gqa3-d128-ragged"], True)
    scale = args[0].shape[3] ** -0.5
    assert all(_within(g, w, "bf16")
               for g, w in zip(_sm90_bwd_arithmetic(*args, True, scale), want))
    bad = _sm90_bwd_arithmetic(*args, True, scale, fault=fault)
    assert not all(_within(g, w, "bf16") for g, w in zip(bad, want))


def _bwd_route_case(case, device="cpu"):
    """(q, k, v, dout) for one case of the backward's route rule, on
    ``device`` (the CPU, or "meta" standing in for a card)."""
    qkv = case if case in ("d64", "model-views", "float32", "dk!=dv", "d256", "mla",
                           "mla-model-views", "dk192-dv192", "d80", "d80-model-views",
                           "d80-float32", "d80-dv64", "d32", "d80-unaligned-base") \
        else "bf16-d128"
    q, k, v = (t.to(device) for t in _route_case(qkv))    # dense: `to` keeps their strides

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    shape = q.shape[:3] + (v.shape[3],)
    dout = z(*shape, dtype=q.dtype)
    # autograd's gradient of a (B, S, H, D) view
    if case in ("model-views", "mla-model-views", "d80-model-views"):
        dout = z(shape[0], shape[2], shape[1], shape[3]).transpose(1, 2)
    elif case == "dout-unaligned-base":
        dout = z(dout.numel() + 1)[1:].view(shape)
    elif case == "dout-unaligned-stride":   # rows of 132 bf16 = 264 bytes
        dout = z(*shape[:3], 132)[..., :128]
    elif case == "dout-last-dim-strided":
        dout = z(*shape[:2], 128, shape[2]).transpose(2, 3)
    elif case == "dout-expanded":   # stride 0 over the heads
        dout = z(1, 1, *shape[2:]).expand(shape)
    elif case == "dout-float32":
        dout = dout.float()
    return q, k, v, dout


BWD_ROUTE_CASES = {"bf16-d128": "sm90", "d64": "sm90", "model-views": "sm90",
                   "float32": "simt", "dk!=dv": "simt", "d256": "simt",
                   "dout-unaligned-base": "simt", "dout-unaligned-stride": "simt",
                   "dout-last-dim-strided": "simt", "dout-expanded": "simt",
                   "dout-float32": "simt", "mla": "sm90", "mla-model-views": "sm90",
                   "dk192-dv192": "simt", "d80": "sm90", "d80-model-views": "sm90",
                   "d80-float32": "simt", "d80-dv64": "simt", "d32": "simt",
                   "d80-unaligned-base": "simt"}


@pytest.mark.parametrize("case", list(BWD_ROUTE_CASES))
def test_bwd_route_rule(case):
    """The backward goes to the tensor-core kernel when the forward's rule
    does and dO passes the same TMA rule (autograd's transposed gradient
    included); everything else to the SIMT kernel."""
    q, k, v, dout = _bwd_route_case(case)
    assert ops.bwd_route(q, k, v, dout) == BWD_ROUTE_CASES[case]


def test_bwd_launch_counters_by_route(monkeypatch):
    """The backward launches the kernel ``bwd_route`` names on the tensors
    as given (no copy changes the route), counts it under that route and in
    the sum, and never tries the other one; ``reset_launches`` zeroes all.
    Meta tensors stand in for CUDA tensors; the bindings are recorders."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    calls = []
    monkeypatch.setattr(ops, "_PLAIN_DEVICES", ("cpu",))    # meta stands in for a card
    monkeypatch.setattr(ops.kernel, "flash_attention_bwd_sm90",
                        lambda *a: calls.append(("sm90", tuple(a[6].shape))))
    monkeypatch.setattr(ops.kernel, "flash_attention_bwd", lambda *a: calls.append(("simt",)))
    monkeypatch.setattr(ops.torch.cuda, "device", lambda d: contextlib.nullcontext())
    saved = (flash_attention_bwd.launches, ops.launches_by_route(flash_attention_bwd))
    try:
        ops.reset_launches()
        for case in ("bf16-d128", "float32", "model-views", "dout-unaligned-stride",
                     "dout-last-dim-strided", "d64"):
            q, k, v, dout = _bwd_route_case(case, "meta")
            lse = torch.zeros(q.shape[:3], dtype=torch.float32, device="meta")
            out = torch.zeros(dout.shape, dtype=dout.dtype, device="meta")
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
            assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert [c[0] for c in calls] == ["sm90", "simt", "sm90", "simt", "simt", "sm90"]
        # the scratch: 2 float32 rows per query of each (batch, head), Sq padded to 128
        assert calls[0][1] == (2, 4, 384) and calls[2][1] == (2, 12, 384)
        assert ops.launches_by_route(flash_attention_bwd) == {"sm90": 3, "simt": 3}
        assert flash_attention_bwd.launches == 6
        ops.reset_launches()
        assert flash_attention_bwd.launches == 0
        assert ops.launches_by_route(flash_attention_bwd) == {"sm90": 0, "simt": 0}
    finally:
        flash_attention_bwd.launches = saved[0]
        for name, n in saved[1].items():
            setattr(flash_attention_bwd, f"launches_{name}", n)
