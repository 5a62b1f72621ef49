"""The port's flash-attention op and its gradient
(`mxnet_tpu_torch.ops.hopper_kernels`) against the JAX package's Pallas
kernels in interpret mode, on the CPU, where the port takes each kernel's
plain PyTorch version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_build
from mxnet_tpu_torch.ops import hopper_kernels as hk

# the reference's forward-attention tolerance (tests/test_pallas.py)
TOL = 2e-4


def _qkv(seed, q_shape, lk):
    b, h, _, d = q_shape
    rng = np.random.RandomState(seed)
    return (rng.randn(*q_shape).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk,rank", [((1, 2, 128, 32), 128, 4),
                                             ((2, 3, 256, 16), 256, 4),
                                             ((1, 2, 128, 32), 256, 4),
                                             ((1, 6, 128, 32), 256, 3)])
def test_flash_attention_with_lse_matches_pallas(causal, q_shape, lk, rank):
    """Rank 3 is MXNet's batch_dot layout [G, L, D]: [1, G, L, D] to the
    JAX kernel."""
    q, k, v = _qkv(0, q_shape, lk)
    o_ref, lse_ref = pk.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True)
    o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)
    if rank == 3:
        q, k, v, o_ref, lse_ref = q[0], k[0], v[0], o_ref[0], lse_ref[0]
    o, lse = hk.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert o.shape == o_ref.shape and lse.shape == lse_ref.shape
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lq,lk", [(200, 200), (64, 160), (256, 200)])
def test_ragged_sequence_raises_value_error(lq, lk):
    q, k, v = _qkv(1, (1, 1, lq, 8), lk)
    with pytest.raises(ValueError):
        hk.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    if lq == lk:
        with pytest.raises(ValueError):
            pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True)


def test_fused_attention_op_goes_through_the_registry():
    q, k, v = _qkv(2, (1, 2, 128, 16), 128)
    cpu = mt.cpu()
    out = mt.nd._fused_attention(mt.nd.array(q, ctx=cpu),
                                 mt.nd.array(k, ctx=cpu),
                                 mt.nd.array(v, ctx=cpu),
                                 causal=True, scale=0.3)
    ref = pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=True, scale=0.3,
                             interpret=True)
    np.testing.assert_allclose(out.asnumpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)

def test_cpu_tensor_never_touches_the_kernel_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel library was loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    hk.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (1, 1, 64, 32), 64))
    hk.flash_attention(q, k, v)
    assert hk.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                           "flash_attn_bwd_dkv": 0, "lstm_gates": 0}


@pytest.mark.parametrize("d,dtype,ok", [(64, torch.float32, True),
                                        (128, torch.bfloat16, True),
                                        (80, torch.float32, False),
                                        (64, torch.float16, False)])
def test_kernel_input_rules_on_cuda(d, dtype, ok):
    # the JAX package's shape rule takes every head dim; the CUDA kernel's
    # own rule does not
    shape = (1, 2, 256, d)
    hk.check_attention(shape, shape, shape)
    if ok:
        hk.check_kernel_inputs(d, dtype)
    else:
        with pytest.raises(ValueError):
            hk.check_kernel_inputs(d, dtype)


def test_plain_version_keeps_bf16_and_meta_shapes():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(4, (1, 2, 64, 16), 64))
    o, lse = hk.flash_attention_with_lse(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    m = torch.empty((2, 3, 128, 64), device="meta")
    o, lse = hk.flash_attention_with_lse(m, m, m)
    assert o.shape == (2, 3, 128, 64) and lse.shape == (2, 3, 128)


# ---------------------------------------------------------------------------
# K2 / K3: the attention backward
# ---------------------------------------------------------------------------

# the reference's attention-gradient tolerance (tests/test_pallas.py:101);
# the worst difference seen on these cases is 1.7e-6
GRAD_TOL = 2e-3

# (q shape, lk, block_q, block_k): the JAX kernel's own blocks, and
# Lq != Lk as in tests/test_pallas.py:105
BWD_CASES = [((1, 2, 128, 16), 128, 128, 128),
             ((2, 2, 128, 64), 128, 64, 64),
             ((1, 2, 64, 16), 256, 32, 64),
             ((1, 2, 64, 64), 256, 32, 64)]


def _bwd_inputs(seed, q_shape, lk):
    q, k, v = _qkv(seed, q_shape, lk)
    rng = np.random.RandomState(seed + 100)
    return (q, k, v, rng.randn(*q_shape).astype(np.float32),
            rng.randn(*q_shape[:-1]).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk,block_q,block_k", BWD_CASES)
def test_backward_plain_versions_match_pallas_bwd(causal, q_shape, lk,
                                                   block_q, block_k):
    """`_attn_dq_plain` / `_attn_dkv_plain` against the JAX package's
    `_pallas_attention_bwd` (K2 and K3 in interpret mode) on the same
    forward residuals and a nonzero dLSE."""
    q, k, v, do, dlse = _bwd_inputs(5, q_shape, lk)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    scale = q_shape[-1] ** -0.5
    o, lse = pk._pallas_attention_fwd(jq, jk, jv, causal=causal, scale=scale,
                                      block_q=block_q, block_k=block_k,
                                      interpret=True)
    ref = pk._pallas_attention_bwd(jq, jk, jv, o, lse, jnp.asarray(do),
                                   jnp.asarray(dlse), causal=causal,
                                   scale=scale, block_q=block_q,
                                   block_k=block_k, interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, do, o, lse,
                                                    dlse)]
    tq, tk, tv, tdo, to, tlse, tdlse = t
    delta = (tdo * to).sum(-1)
    args = (tq, tk, tv, tdo, tlse, delta, tdlse)
    dq = hk._attn_dq_plain(*args, causal=causal, scale=scale)
    dk, dv = hk._attn_dkv_plain(*args, causal=causal, scale=scale)
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk,block_q,block_k", BWD_CASES)
def test_autograd_backward_matches_jax_vjp(causal, q_shape, lk, block_q,
                                           block_k):
    """`flash_attention_with_lse`'s autograd backward on CPU tensors
    against `jax.vjp` of the JAX package's `flash_attention_with_lse`
    (its custom_vjp runs K2 and K3 in interpret mode), with cotangents on
    both O and the logsumexp."""
    import jax
    q, k, v, do, dlse = _bwd_inputs(6, q_shape, lk)

    def f(q, k, v):
        return pk.flash_attention_with_lse(q, k, v, causal=causal,
                                           block_q=block_q, block_k=block_k,
                                           interpret=True)

    (o_ref, lse_ref), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    ref = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = hk.flash_attention_with_lse(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=TOL, atol=TOL)
    got = torch.autograd.grad((o, lse), (tq, tk, tv),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_backward_through_the_op_reaches_transposed_inputs():
    """The op's contiguous copies stay in the autograd graph: a gradient
    flows back to q, k, v handed over as [B, L, H, d] transposes, and only
    O's gradient (no lse cotangent) is needed."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               .requires_grad_(True) for a in _qkv(7, (1, 2, 128, 16), 128))
    args = [t.transpose(1, 2) for t in (q, k, v)]
    out = mt.ops.registry.apply_op("_fused_attention", args, {})[0]
    out.sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o2, _ = hk._flash_attention_with_lse_plain(
        *[t.transpose(1, 2) for t in ref])
    o2.sum().backward()
    for t, r in zip((q, k, v), ref):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


# ---------------------------------------------------------------------------
# K2 / K3 arithmetic on the card, emulated on the CPU: split-TF32 products
# for fp32 inputs, bf16 products with p and ds rounded to bf16
# ---------------------------------------------------------------------------

# sign, exponent and TF32's 10 mantissa bits (0xffffe000 as an int32)
_TF32_MASK = -8192
# bf16 gradients against the reference: relative to the largest magnitude
BF16_GRAD_TOL = 2e-2


def _tf32_round(x):
    """x rounded to TF32 to nearest, ties away (cvt.rna.tf32.f32), by
    mantissa masking: how the kernels take an operand's big part."""
    return ((x.view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)


def _tf32_cut(x):
    """x cut to TF32 toward zero: how the kernels take the small part."""
    return (x.view(torch.int32) & _TF32_MASK).view(torch.float32)


def _mm3(a, b):
    """a @ b as the fp32 kernels take it: three TF32 passes over the split
    operands (big·big + big·small + small·big) summed in fp32; TF32
    products are exact in fp32."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    a_lo, b_lo = _tf32_cut(a - a_hi), _tf32_cut(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm1(a, b):
    """a @ b in one TF32 pass: what a kernel that lost the small parts
    would take."""
    return _tf32_round(a) @ _tf32_round(b)


def _emulated_backward(q, k, v, do, lse, delta, dlse, causal, scale,
                       scheme):
    """(dq, dk, dv) with K2's and K3's rounding on the card.  "fp32": every
    product in three TF32 passes ("tf32": in one).  "bf16" (inputs hold
    bf16 values): the products of bf16 values are exact and summed in fp32,
    p and ds are rounded to bf16 before dv, dk and dq, each gradient on the
    store."""
    if scheme in ("fp32", "tf32"):
        mm, cast = (_mm3 if scheme == "fp32" else _mm1), (lambda t: t)
    else:
        mm, cast = torch.matmul, (lambda t: t.bfloat16().float())
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~hk._causal_keep(*s.shape[-2:], s.device), -1e30)
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp + (dlse - delta)[..., None]) * scale
    p, ds = cast(p), cast(ds)
    return [cast(g) for g in (mm(ds, k), mm(ds.transpose(-1, -2), q),
                              mm(p.transpose(-1, -2), do))]


@pytest.mark.parametrize("scheme,tol", [("fp32", GRAD_TOL),
                                        ("bf16", BF16_GRAD_TOL)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk,block_q,block_k",
                         [BWD_CASES[0], BWD_CASES[1], BWD_CASES[3]])
def test_kernel_rounding_matches_pallas_bwd(scheme, tol, causal, q_shape,
                                            lk, block_q, block_k):
    """The card's arithmetic (emulated) against the JAX package's
    `_pallas_attention_bwd` in interpret mode, within the tolerance of
    each scheme relative to the gradient's largest magnitude: the
    chip-free evidence that the precision choice keeps parity.  bf16
    inputs are bf16 values handed to both as fp32."""
    arrays = _bwd_inputs(13, q_shape, lk)
    if scheme == "bf16":
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    q, k, v, do, dlse = arrays
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    scale = q_shape[-1] ** -0.5
    o, lse = pk._pallas_attention_fwd(jq, jk, jv, causal=causal, scale=scale,
                                      block_q=block_q, block_k=block_k,
                                      interpret=True)
    ref = pk._pallas_attention_bwd(jq, jk, jv, o, lse, jnp.asarray(do),
                                   jnp.asarray(dlse), causal=causal,
                                   scale=scale, block_q=block_q,
                                   block_k=block_k, interpret=True)
    tq, tk, tv, tdo, to, tlse, tdlse = (
        torch.from_numpy(np.array(a)) for a in (q, k, v, do, o, lse, dlse))
    if scheme == "bf16":
        to = to.bfloat16().float()  # K1 stores O in bf16
    delta = (tdo * to).sum(-1)
    got = _emulated_backward(tq, tk, tv, tdo, tlse, delta, tdlse, causal,
                             scale, scheme)
    for g, want in zip(got, ref):
        want = np.asarray(want)
        err = np.abs(g.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_three_pass_tf32_product_keeps_fp32_accuracy():
    """At BERT's head width (a 64-deep product), the three-pass product
    stays within 1e-5 of a plain fp32 matmul; one TF32 pass does not."""
    rng = np.random.RandomState(14)
    a = torch.from_numpy(rng.randn(128, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    plain = a @ b
    np.testing.assert_allclose(_mm3(a, b).numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (_mm1(a, b) - plain).abs().max() > 1e-4


# phase 3b's fp32 K2/K3 cases, one (batch, head) each
SPLIT_CASES = [((1, 1, 512, 64), 512), ((1, 1, 128, 64), 128),
               ((1, 1, 256, 16), 256), ((1, 1, 128, 32), 128),
               ((1, 1, 256, 128), 256), ((1, 1, 64, 16), 256),
               ((1, 1, 64, 64), 256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", SPLIT_CASES)
def test_split_tf32_limit_tells_three_passes_from_one(causal, q_shape, lk):
    """`chip_smoke`'s SPLIT_TF32_TOL against the fp32 plain versions, as
    phase 3b holds K2/K3 on the card: the emulated three-pass backward
    stays within it and a one-pass TF32 backward breaks it."""
    import chip_smoke as cs
    q, k, v, do, dlse = (torch.from_numpy(a)
                         for a in _bwd_inputs(15, q_shape, lk))
    scale = q_shape[-1] ** -0.5
    o, lse = hk._flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                scale=scale)
    args = (q, k, v, do, lse, (do * o).sum(-1), dlse)
    want = (hk._attn_dq_plain(*args, causal=causal, scale=scale),
            *hk._attn_dkv_plain(*args, causal=causal, scale=scale))

    def rel(scheme):
        got = _emulated_backward(*args, causal, scale, scheme)
        return max(((g - w).abs().max() / w.abs().max()).item()
                   for g, w in zip(got, want))

    assert rel("fp32") < cs.SPLIT_TF32_TOL / 10
    assert rel("tf32") > 3 * cs.SPLIT_TF32_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
            3.0]
    assert _tf32_round(x).tolist() == want
    hi = _tf32_round(x)
    assert (hi + (x - hi)).tolist() == x.tolist()


# ---------------------------------------------------------------------------
# K1 arithmetic on the card, emulated on the CPU: the scaled Q and the
# online softmax over the kernel's key tiles, with split-TF32 products for
# fp32 inputs and bf16 products with p rounded to bf16 for bf16 inputs
# ---------------------------------------------------------------------------

def _k1_key_rows(d):
    """Keys of fp32 K1's key tile (`TfCfg<D>::BN` in flash_attn_fwd.cu)."""
    return 64 if d <= 64 else 32


def _emulated_forward(q, k, v, causal, scale, scheme):
    """(O, lse) with K1's rounding on the card.  "fp32": q is scaled, then
    both products run in three TF32 passes ("tf32": in one).  "bf16"
    (inputs hold bf16 values): products of bf16 values are exact and summed
    in fp32, the scale is applied to s after the product, p is rounded to
    bf16 before p·v, and O to bf16 on the store.  The running max and sum
    are taken tile by tile at the kernel's key-tile width."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    if scheme in ("fp32", "tf32"):
        mm, q, post = (_mm3 if scheme == "fp32" else _mm1), q * scale, 1.0
        round_p = (lambda t: t)
    else:
        mm, post = torch.matmul, scale
        round_p = (lambda t: t.bfloat16().float())
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros_like(q)
    rows = torch.arange(lq)[:, None]
    bn = _k1_key_rows(d)
    for k0 in range(0, lk, bn):
        s = mm(q, k[..., k0:k0 + bn, :].transpose(-1, -2)) * post
        if causal:
            cols = torch.arange(k0, min(k0 + bn, lk))[None]
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(round_p(p), v[..., k0:k0 + bn, :])
        m = m_new
    l = l.clamp_min(1e-30)
    o = acc / l[..., None]
    return (o if scheme != "bf16" else o.bfloat16().float()), m + torch.log(l)


# (q shape, lk): D 16/32/64/128 (128 streams 32-row key tiles), Lq != Lk
FWD_EMULATION_CASES = [((2, 2, 128, 16), 128), ((1, 2, 128, 32), 128),
                       ((1, 2, 64, 64), 256), ((1, 1, 256, 128), 256)]


@pytest.mark.parametrize("scheme,tol", [("fp32", TOL), ("bf16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", FWD_EMULATION_CASES)
def test_k1_rounding_matches_pallas_fwd(scheme, tol, causal, q_shape, lk):
    """The new K1's arithmetic (emulated) against the JAX package's
    `_pallas_attention_fwd` in interpret mode, on O and the logsumexp:
    the chip-free evidence that the precision choice keeps parity.  bf16
    inputs are bf16 values handed to both as fp32."""
    arrays = _qkv(17, q_shape, lk)
    if scheme == "bf16":
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    q, k, v = arrays
    scale = q_shape[-1] ** -0.5
    o_ref, lse_ref = pk._pallas_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=min(128, q_shape[2]), block_k=min(128, lk),
        interpret=True)
    o, lse = _emulated_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal, scale, scheme)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL,
                               atol=TOL)


# phase 3's fp32 K1 cases, one (batch, head) each
K1_SPLIT_CASES = [((1, 1, 512, 64), 512), ((1, 1, 128, 64), 128),
                  ((1, 1, 256, 16), 256), ((1, 1, 128, 64), 256),
                  ((1, 1, 128, 32), 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", K1_SPLIT_CASES)
def test_k1_split_tf32_limit_tells_three_passes_from_one(causal, q_shape,
                                                         lk):
    """`chip_smoke`'s K1_SPLIT_TOL against the fp32 plain version, as phase
    3 holds K1's O on the card: the emulated three-pass forward stays
    within a tenth of it and a one-pass TF32 forward breaks it three
    times over."""
    import chip_smoke as cs
    q, k, v = (torch.from_numpy(a) for a in _qkv(21, q_shape, lk))
    scale = q_shape[-1] ** -0.5
    want, _ = hk._flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                 scale=scale)

    def rel(scheme):
        got, _ = _emulated_forward(q, k, v, causal, scale, scheme)
        return ((got - want).abs().max() / want.abs().max()).item()

    assert rel("fp32") < cs.K1_SPLIT_TOL / 10
    assert rel("tf32") > 3 * cs.K1_SPLIT_TOL


def _rz(x):
    """float64 to float32 rounded toward zero: how the tensor cores leave
    each sum they accumulate."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _k1_sum_chunks():
    """8-key chunks of K1's fp32 p·v summed before each fp32 add into O:
    `SUM_CHUNKS`, read from flash_attn_fwd.cu."""
    import os
    import re
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attn_fwd.cu")) as f:
        m = re.search(r"constexpr int SUM_CHUNKS = (\d+);", f.read())
    return int(m.group(1))


def _truncated_pv_drift(seed, std, chunks, rows=512, lk=512, d=64):
    """K1's fp32 O for one head of q, k, v ~ N(0, std²), with every mma
    modelled as exact products added to its accumulator and cut to fp32
    toward zero: p·v summed in one running accumulator over the sequence
    (``chunks`` None) or in sums of ``chunks`` 8-key chunks added in fp32.
    Returns (signed drift of O toward zero over mean |O|, max |error| over
    max |O|) of that O and of one plain fp32 product, against the exact
    O."""
    rng = np.random.RandomState(seed)
    q = rng.randn(rows, d).astype(np.float32) * std
    k, v = (rng.randn(lk, d).astype(np.float32) * std for _ in range(2))
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * d ** -0.5
    p64 = np.exp(s - s.max(1, keepdims=True))
    l64 = p64.sum(1, keepdims=True)
    o_exact = p64 @ v.astype(np.float64) / l64
    p = torch.from_numpy(p64.astype(np.float32))
    tv = torch.from_numpy(v)
    (ph, pl), (vh, vl) = ((_tf32_round(t), _tf32_cut(t - _tf32_round(t)))
                          for t in (p, tv))

    def chunk(c, kc):
        sl = slice(8 * kc, 8 * kc + 8)
        for a, b in ((pl, vh), (ph, vl), (ph, vh)):
            c = _rz(c.astype(np.float64) + a[:, sl].double().numpy() @
                    b[sl].double().numpy())
        return c

    acc = np.zeros((rows, d), np.float32)
    if chunks is None:
        for kc in range(lk // 8):
            acc = chunk(acc, kc)
    else:
        for k0 in range(0, lk // 8, chunks):
            part = np.zeros((rows, d), np.float32)
            for kc in range(k0, k0 + chunks):
                part = chunk(part, kc)
            acc = acc + part

    def drift(o):
        err = o - o_exact
        return ((err * np.sign(o_exact)).mean() / np.abs(o_exact).mean(),
                np.abs(err).max() / np.abs(o_exact).max())

    l32 = l64.astype(np.float32)
    return drift(acc / l32), drift((p @ tv).numpy() / l32)


def test_k1_chunk_sums_keep_o_unbiased_under_truncation():
    """Why K1 sums every `SUM_CHUNKS` chunks of p·v in an accumulator of
    their own (its first product adding to nothing) and adds them to O
    in fp32: O summed in one running accumulator over the sequence drifts
    toward zero at BERT-like scores (small, so O is a mean with cancellation), and its
    error grows far past a plain fp32 product's; the backward's
    delta = rowsum(dO∘O) carries that error into every dsᵢⱼ.  Sums of a
    few chunks added in fp32 keep O within a plain product's error."""
    (run_bias, run_err), (_, plain_err) = _truncated_pv_drift(23, 0.55, None)
    (sum_bias, sum_err), _ = _truncated_pv_drift(23, 0.55, _k1_sum_chunks())
    assert run_bias < -1e-6 and abs(sum_bias) < abs(run_bias) / 10
    assert run_err > 5 * plain_err and sum_err < 2 * plain_err


@pytest.mark.parametrize("std", [1.0, 0.55])
def test_k1_bias_limit_tells_chunk_sums_from_one_running_sum(std):
    """`chip_smoke`'s K1_BIAS_TOL, as phase 3 holds fp32 K1's signed drift
    on randn inputs (std 1) and as BERT's small scores give it (0.55): the
    modelled running sum breaks it, which K1_SPLIT_TOL does not, and the
    kernel's chunk sums stay within half of it."""
    import chip_smoke as cs
    (run_bias, run_err), _ = _truncated_pv_drift(29, std, None, rows=256)
    (sum_bias, _), _ = _truncated_pv_drift(29, std, _k1_sum_chunks(),
                                           rows=256)
    assert run_bias < -cs.K1_BIAS_TOL and run_err < cs.K1_SPLIT_TOL
    assert abs(sum_bias) < cs.K1_BIAS_TOL / 2


def _fake_kernel(monkeypatch, current_device=-1):
    """Replace the kernel library and the CUDA runtime calls of
    `hopper_kernels._call` so that a wrapper runs on CPU tensors: returns
    the list the fake kernel records its arguments in, and the list of
    devices entered."""
    calls, entered = [], []

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(hk, "_kernel_fn",
                        lambda entry: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(hk, "_current_stream", lambda index: 1234)
    monkeypatch.setattr(hk, "_current_device", lambda: current_device)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    return calls, entered


def test_attention_wrapper_aligns_and_passes_shapes(monkeypatch):
    """K1's wrapper with the library faked: an input whose storage starts
    off a 16-byte boundary reaches the kernel as an aligned copy, and the
    kernel gets b·h, Lq, Lk, D, the dtype code, the mask flag, the scale
    and the stream; one launch is counted."""
    calls, entered = _fake_kernel(monkeypatch)
    q = torch.zeros(2 * 3 * 64 * 16 + 1)[1:].view(2, 3, 64, 16)
    k = v = torch.zeros(2, 3, 128, 16)
    assert q.data_ptr() % 16
    hk.reset_launch_counts()
    o, lse = hk._flash_attention_with_lse_cuda(q, k, v, True, 0.25)
    (args,) = calls
    assert args[0] % 16 == 0 and args[0] != q.data_ptr()
    assert args[1:5] == (k.data_ptr(), v.data_ptr(), o.data_ptr(),
                         lse.data_ptr())
    assert args[5:] == (6, 64, 128, 16, 0, 1, 0.25, 1234)
    assert o.shape == q.shape and lse.shape == (2, 3, 64)
    assert lse.dtype == torch.float32 and not entered
    assert hk.LAUNCHES["flash_attn_fwd"] == 1


def test_attention_bounds_at_bert_base():
    """`chip_smoke`'s bounds at BERT-base's [8, 12, 512, 64] fp32 call:
    operations over three TF32 passes' rate (495/3 TFLOP/s) for K1-K3."""
    import chip_smoke as cs
    q = torch.empty((8, 12, 512, 64), device="meta")
    k1, k1_by = cs._attention_bound(q, q, False)
    k2, k2_by = cs._backward_bound(q, q, False, dkv=False)
    k3, k3_by = cs._backward_bound(q, q, False, dkv=True)
    assert (k1_by, k2_by, k3_by) == ("operations",) * 3
    np.testing.assert_allclose([k1, k2, k3], [0.0390, 0.0586, 0.0781],
                               rtol=2e-3)
    # the bytes each would take, for the record: 0.019 and 0.023 ms
    reads = 4 * 8 * 12 * 512 * 64 * 4 + 3 * 8 * 12 * 512 * 4
    np.testing.assert_allclose(
        [(reads + 8 * 12 * 512 * 64 * 4 * n) / cs.MEM_BPS * 1e3
         for n in (1, 2)], [0.019, 0.023], rtol=2e-2)
    assert cs._attention_bound(q.bfloat16(), q.bfloat16(), False)[0] < k1


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes (directly or through another
    header) names a new library; an edit to a header it does not include,
    or a cycle of includes, does not disturb the name."""
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\nint b;\n')
    (tmp_path / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    first = cuda_build._library_path("k")
    assert cuda_build._library_path("k") == first
    (tmp_path / "other.cuh").write_text("int other2;\n")
    assert cuda_build._library_path("k") == first
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\nint b2;\n')
    second = cuda_build._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k2;\n')
    assert cuda_build._library_path("k") not in (first, second)


def test_backward_counts_no_launch_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel library was loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)
    hk.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(8, (1, 1, 64, 32), 64))
    hk.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert set(hk.LAUNCHES) == {"flash_attn_fwd", "flash_attn_bwd_dq",
                                "flash_attn_bwd_dkv", "lstm_gates"}
    assert not any(hk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# K4: the fused LSTM cell update
# ---------------------------------------------------------------------------

# the reference's LSTM-gate tolerance (tests/test_pallas.py:68); bf16
# inputs are compared in fp32 after the cast
LSTM_TOL = 1e-5
LSTM_BF16_TOL = 2e-2


def _lstm_inputs(seed, b, h):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 4 * h).astype(np.float32) * 2,
            rng.randn(b, h).astype(np.float32))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("h", [8, 13, 32])
def test_lstm_gates_plain_matches_pallas(b, h):
    gates, c = _lstm_inputs(h * 10 + b, b, h)
    ref = pk.lstm_gates(jnp.asarray(gates), jnp.asarray(c), interpret=True)
    got = hk.lstm_gates(torch.from_numpy(gates), torch.from_numpy(c))
    for g, r in zip(got, ref):
        assert g.shape == (b, h) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=LSTM_TOL,
                                   atol=LSTM_TOL)


@pytest.mark.parametrize("gates_bf16,c_bf16", [(True, False), (True, True),
                                               (False, True)])
def test_lstm_gates_bf16_matches_pallas(gates_bf16, c_bf16):
    """Each input upcasts on its own; the outputs take c_prev's dtype."""
    gates, c = _lstm_inputs(9, 4, 16)
    jg, jc = jnp.asarray(gates), jnp.asarray(c)
    tg, tc = torch.from_numpy(gates), torch.from_numpy(c)
    if gates_bf16:
        jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
    if c_bf16:
        jc, tc = jc.astype(jnp.bfloat16), tc.to(torch.bfloat16)
    ref = pk.lstm_gates(jg, jc, interpret=True)
    got = hk.lstm_gates(tg, tc)
    for g, r in zip(got, ref):
        assert g.dtype == tc.dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, dtype=np.float32),
                                   rtol=LSTM_BF16_TOL, atol=LSTM_BF16_TOL)


def test_fused_lstm_gates_op_takes_a_broadcast_state():
    """The op through the registry, with c_prev the broadcast view a first
    step's zero state is (`broadcast_axis`)."""
    gates, c = _lstm_inputs(10, 3, 16)
    cpu = mt.cpu()
    c_view = mt.nd.broadcast_axis(mt.nd.array(c[:, :1], ctx=cpu), axis=1,
                                  size=16)
    assert not c_view.data.is_contiguous()
    c_new, h_new = mt.nd._fused_lstm_gates(mt.nd.array(gates, ctx=cpu),
                                           c_view)
    ref = pk.lstm_gates(jnp.asarray(gates),
                        jnp.broadcast_to(jnp.asarray(c[:, :1]), (3, 16)),
                        interpret=True)
    for g, r in zip((c_new, h_new), ref):
        np.testing.assert_allclose(g.asnumpy(), np.asarray(r), rtol=LSTM_TOL,
                                   atol=LSTM_TOL)


@pytest.mark.parametrize("gates_shape,c_shape,dtype,why", [
    ((4, 32), (4, 8), torch.float32, None),
    ((4, 32), (4, 8), torch.bfloat16, None),
    ((4, 32, 1), (4, 8), torch.float32, "rank"),
    ((4, 30), (4, 8), torch.float32, "4H"),
    ((3, 32), (4, 8), torch.float32, "batch"),
    ((4, 32), (4, 8), torch.float16, "dtype"),
    ((4, 32), (4, 8), torch.float64, "dtype")])
def test_lstm_kernel_input_rules_on_cuda(gates_shape, c_shape, dtype, why):
    """What the CUDA wrapper checks before it launches: [B, 4H] and [B, H]
    (the shape rule holds on every device), float32 or bfloat16."""
    gates = torch.zeros(gates_shape, dtype=dtype)
    c = torch.zeros(c_shape, dtype=dtype)
    if why is None:
        hk.check_lstm_kernel_inputs(gates, c)
        hk.check_lstm_kernel_inputs(gates.float(), c.bfloat16())
        return
    with pytest.raises(ValueError):
        hk.check_lstm_kernel_inputs(gates, c)
    if why != "dtype":
        with pytest.raises(ValueError):
            hk.lstm_gates(gates, c)


def test_lstm_kernel_refuses_strided_and_split_inputs():
    gates = torch.zeros(4, 64)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        hk.check_lstm_kernel_inputs(gates, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="one device"):
        hk.check_lstm_kernel_inputs(torch.zeros(4, 32),
                                    torch.zeros(4, 8, device="meta"))


def test_lstm_gates_cpu_never_touches_the_kernel_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel library was loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    hk.reset_launch_counts()
    gates, c = _lstm_inputs(11, 2, 8)
    hk.lstm_gates(torch.from_numpy(gates), torch.from_numpy(c))
    assert hk.LAUNCHES["lstm_gates"] == 0
    assert "lstm_gates" in cuda_build.KERNELS


@pytest.mark.parametrize("on_current_device", [True, False])
@pytest.mark.parametrize("gates_dtype,c_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32),
                          (torch.float32, torch.bfloat16)])
def test_lstm_wrapper_validates_once_and_launches_once(
        monkeypatch, on_current_device, gates_dtype, c_dtype):
    """K4's wrapper with the library faked: it validates once, hands the
    kernel the inputs' and outputs' pointers, B, H and the dtype codes and
    the stream, enters a device context only for a device that is not the
    current one, counts one launch, and returns contiguous [B, H] outputs
    in c's dtype."""
    calls, entered = _fake_kernel(
        monkeypatch, current_device=-1 if on_current_device else 3)
    checks = []
    real_check = hk.check_lstm_kernel_inputs
    monkeypatch.setattr(hk, "check_lstm_kernel_inputs",
                        lambda g, c: checks.append(1) or real_check(g, c))
    gates = torch.zeros(5, 4 * 24, dtype=gates_dtype)
    c = torch.zeros(5, 24, dtype=c_dtype)
    hk.reset_launch_counts()
    c_new, h_new = hk._lstm_gates_cuda(gates, c)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert checks == [1]
    assert calls == [(gates.data_ptr(), c.data_ptr(), c_new.data_ptr(),
                      h_new.data_ptr(), 5, 24, codes[gates_dtype],
                      codes[c_dtype], 1234)]
    assert entered == ([] if on_current_device else [-1])
    assert hk.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                           "flash_attn_bwd_dkv": 0, "lstm_gates": 1}
    for t in (c_new, h_new):
        assert t.shape == (5, 24) and t.dtype == c_dtype
        assert t.is_contiguous()
    assert h_new.data_ptr() != c_new.data_ptr()


def test_lstm_wrapper_raises_on_a_refused_launch(monkeypatch):
    """A nonzero cudaError_t from the entry point raises and counts no
    launch."""
    _fake_kernel(monkeypatch)
    monkeypatch.setattr(hk, "_kernel_fn", lambda entry: lambda *a: 1)
    monkeypatch.setattr(hk, "_cuda_error",
                        lambda entry, err: mt.base.MXNetError(f"{err}"))
    hk.reset_launch_counts()
    with pytest.raises(mt.base.MXNetError):
        hk._lstm_gates_cuda(torch.zeros(2, 32), torch.zeros(2, 8))
    assert hk.LAUNCHES["lstm_gates"] == 0


def test_lstm_gates_keeps_meta_shapes():
    c_new, h_new = hk.lstm_gates(
        torch.empty((32, 800), device="meta"),
        torch.empty((32, 200), dtype=torch.bfloat16, device="meta"))
    assert c_new.shape == h_new.shape == (32, 200)
    assert c_new.dtype == h_new.dtype == torch.bfloat16
    assert c_new.device.type == "meta"
