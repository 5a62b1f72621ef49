"""K1's bf16 kernel on wgmma and TMA (`csrc/flash_attn_fwd.cu`,
``flash_attn_fwd_wgmma_kernel``), its arithmetic emulated on the CPU and
held against the JAX package's `_pallas_attention_fwd` in interpret mode.

The kernel itself runs only on the card (chip_smoke.py phase 3 holds it
against the plain PyTorch version there); this file is the chip-free
evidence that its design keeps parity: the key-tile width, the scale
folded with log2(e) into c = scale·log2(e) and applied after the product
(for c > 0 the masks and the row max on the unscaled scores and
p = exp2(fma(s, c, -m)); for any other scale x = s·c first), exp2 with the
running max kept in base 2, masked scores at -1e30·log2(e), p rounded to
bf16 before p·v, lse = m·ln2 + log(l), query tiles of 64 rows that skip
the key tiles above the causal diagonal, and ragged rows past Lq."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_build
from mxnet_tpu_torch.ops import hopper_kernels as hk

# O in bf16 against the fp32 reference, and the fp32 logsumexp: the
# tolerances chip_smoke.py holds the kernel to (TOL[bfloat16], TOL[float32])
O_TOL, LSE_TOL = 2e-2, 2e-4
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _source():
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attn_fwd.cu")) as f:
        return f.read()


def _constant(name):
    """An integer ``constexpr int`` of flash_attn_fwd.cu."""
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    return int(m.group(1))


def _emulated_wgmma_forward(q, k, v, causal, scale):
    """(O, lse) with the bf16 wgmma kernel's arithmetic, for inputs that
    hold bf16 values: per 64-row query tile, the key tiles up to the
    causal end at WG_BN keys each; s = q·kᵀ exact products summed in fp32,
    c = scale·log2e in fp32; for c > 0 the masks (-1e30·log2e / c causal,
    -inf past lk) and the row max on s, the max times c, and
    p = exp2(fma(s, c, -m)); otherwise x = s·c, masks at -1e30·log2e and
    -inf, p = exp2(x - m); m and alpha in base 2, p summed in fp32 and
    rounded to bf16 for p·v, O = acc / max(l, 1e-30) rounded to bf16 and
    lse = m·ln2 + log(l)."""
    bm, bn = _constant("WG_BM"), _constant("WG_BN")
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E)
    masked = torch.tensor(-1e30, dtype=torch.float32) * torch.tensor(LOG2E)
    fold = c.item() > 0
    mask_value = (masked / c).item() if fold else masked.item()
    o = torch.zeros(q.shape)
    lse = torch.zeros(q.shape[:-1])
    for q0 in range(0, lq, bm):
        qb = q[..., q0:q0 + bm, :]
        rows = torch.arange(q0, q0 + qb.shape[-2])[:, None]
        k_end = min(lk, q0 + bm, lq) if causal else lk
        m = torch.full(qb.shape[:-1], masked.item())
        l = torch.zeros(qb.shape[:-1])
        acc = torch.zeros(qb.shape)
        for k0 in range(0, k_end, bn):
            cols = torch.arange(k0, k0 + bn)[None]
            kt = k[..., k0:k0 + bn, :]
            vt = v[..., k0:k0 + bn, :]
            pad = bn - kt.shape[-2]     # a tile past lk: the kernel's zeros
            if pad:
                kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
                vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
            x = torch.matmul(qb, kt.transpose(-1, -2))
            if not fold:
                x = x * c
            if causal:
                x = x.masked_fill(cols > rows, mask_value)
            x = x.masked_fill(cols >= lk, float("-inf"))
            mx = x.amax(-1) * c if fold else x.amax(-1)
            m_new = torch.maximum(m, mx)
            alpha = torch.exp2(m - m_new)
            if fold:   # one rounding, as fma's
                p = torch.exp2((x.double() * c.double() -
                                m_new.double()[..., None]).float())
            else:
                p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.bfloat16().float(), vt)
            m = m_new
        l = l.clamp_min(1e-30)
        o[..., q0:q0 + bm, :] = (acc / l[..., None]).bfloat16().float()
        lse[..., q0:q0 + bm] = m * LN2 + torch.log(l)
    return o, lse


def _bf16_qkv(seed, q_shape, lk):
    """q, k, v ~ N(0, 1) rounded to bf16 and held as fp32 arrays, so both
    packages see the same bf16 values."""
    b, h, _, d = q_shape
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a).bfloat16().float().numpy()
            for a in (rng.randn(*q_shape).astype(np.float32),
                      rng.randn(b, h, lk, d).astype(np.float32),
                      rng.randn(b, h, lk, d).astype(np.float32))]


# (q shape, lk): every head dim the kernel is built for (32-, 64- and
# 128-byte swizzles, two column blocks at 128), Lq < Lk and Lq > Lk, and
# ragged Lq <= 128 (a query tile that runs past the last row)
WGMMA_CASES = [((2, 2, 128, 16), 128), ((1, 2, 128, 32), 256),
               ((1, 2, 256, 64), 128), ((1, 1, 256, 128), 256),
               ((1, 2, 100, 64), 128), ((1, 1, 72, 128), 128),
               ((2, 1, 40, 16), 256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", WGMMA_CASES)
def test_wgmma_arithmetic_matches_pallas_fwd(causal, q_shape, lk):
    """The bf16 kernel's arithmetic (emulated) against the JAX package's
    `_pallas_attention_fwd` in interpret mode, on O and the logsumexp."""
    _check_against_pallas(causal, q_shape, lk, q_shape[-1] ** -0.5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_wgmma_arithmetic_at_scales_without_the_fold(causal, scale):
    """A scale of zero or below takes the kernel's unfolded arithmetic
    (the row max of s·c is not c times the max of s there)."""
    _check_against_pallas(causal, (1, 2, 128, 64), 256, scale)


def _check_against_pallas(causal, q_shape, lk, scale):
    q, k, v = _bf16_qkv(23, q_shape, lk)
    o_ref, lse_ref = pk._pallas_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=min(128, q_shape[2]), block_k=min(128, lk),
        interpret=True)
    o, lse = _emulated_wgmma_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=O_TOL,
                               atol=O_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_arithmetic_matches_the_plain_version(causal):
    """The same emulation against the port's plain version, the card's
    yardstick in chip_smoke.py, at 22a's head width and a sequence of
    several key tiles."""
    q, k, v = (torch.from_numpy(a)
               for a in _bf16_qkv(29, (1, 2, 512, 64), 512))
    want_o, want_lse = hk._flash_attention_with_lse_plain(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=causal,
        scale=64 ** -0.5)
    o, lse = _emulated_wgmma_forward(q, k, v, causal, 64 ** -0.5)
    torch.testing.assert_close(o, want_o.float(), rtol=O_TOL, atol=O_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


def _switch_cases(function):
    """The head dims a dispatch function of flash_attn_fwd.cu launches."""
    src = _source()
    body = src[src.index(f"cudaError_t {function}("):]
    body = body[:body.index("default:")]
    return tuple(int(x) for x in re.findall(r"case (\d+):", body))


@pytest.mark.parametrize("function", ["dispatch_fp32", "dispatch_bf16"])
def test_each_dtype_dispatches_every_wrapper_head_dim(function):
    """Both of the entry point's switches (fp32 on mma.sync, bf16 on
    wgmma) launch a kernel at every head dim the wrapper lets through."""
    assert _switch_cases(function) == hk.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("d", hk.KERNEL_HEAD_DIMS)
def test_wgmma_tiles_fit_their_blocks_per_sm(d):
    """The bf16 kernel's shared memory (the Q tile, WG_STAGES K and V
    tiles, 5 barriers, 1 KB of alignment) times the blocks per SM its
    __launch_bounds__ ask for fits the H100's 228 KB an SM (1 KB of it
    reserved per block), and a tile row is one of TMA's swizzle widths."""
    bm, bn, stages = (_constant(n) for n in ("WG_BM", "WG_BN", "WG_STAGES"))
    m = re.search(r"__launch_bounds__\(WG_NT, D == 128 \? (\d+) : (\d+)\)",
                  _source())
    blocks = int(m.group(1)) if d == 128 else int(m.group(2))
    smem = bm * d * 2 + 2 * stages * bn * d * 2 + (1 + 2 * stages) * 8 + 1024
    assert blocks * (smem + 1024) <= 228 * 1024
    assert min(d, 64) * 2 in (32, 64, 128)
