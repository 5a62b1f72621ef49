"""The port's flash-attention op (`mxnet_tpu_torch.ops.hopper_kernels`)
against the JAX package's Pallas kernel in interpret mode, on the CPU,
where the port takes the kernel's plain PyTorch version."""
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
    assert hk.LAUNCHES == {"flash_attn_fwd": 0}


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
