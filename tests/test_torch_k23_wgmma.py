"""K2's and K3's bf16 kernels on wgmma and TMA (`csrc/flash_attn_bwd.cu`,
``flash_attn_bwd_dq_wgmma_kernel`` and ``flash_attn_bwd_dkv_wgmma_kernel``),
their arithmetic emulated on the CPU and held against the JAX package's
`_pallas_attention_bwd` in interpret mode.

The kernels themselves run only on the card (chip_smoke.py phase 3b holds
them against the plain PyTorch versions there); this file is the chip-free
evidence that their design keeps parity: the tile widths read from the
source (64 owned rows; K2's 64-key tiles; K3's query tiles of 64 rows, 32
at D = 128), p = exp2(fma(s, c, -lse·log2e)) with c = scale·log2(e) and no
row max (so any sign of the scale), masked scores at -1e30·log2(e) before
the exponent, p = 0 past the last key (K2) or query (K3), where K3's rows
of a query tile past Lq are the next (b, h)'s, p and ds / scale rounded
to bf16 before the accumulating products, sums in fp32, dq and dk
multiplied by the scale on the store, each gradient rounded to bf16
there, and the causal tile skips: K2 stops at the last key
tile its query tile reaches, K3 starts at the first query tile that
reaches its first key."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_build
from mxnet_tpu_torch.ops import hopper_kernels as hk

# dq, dk and dv in bf16 against the fp32 reference, relative to each
# gradient's largest magnitude: the tolerance chip_smoke.py holds the
# kernels to (BF16_GRAD_TOL).  p and ds / scale are rounded to bf16 (2^-9
# relative) before the accumulating products, and each gradient once more
# on the store; the sums stay in fp32.
GRAD_TOL = 2e-2
LOG2E = np.float32(1.4426950408889634)
MASKED2 = np.float32(-1e30) * LOG2E
# the H100's shared memory an SM (KB) and the 1 KB it reserves per block
SM_SMEM_KB, BLOCK_RESERVED = 228, 1024


def _source():
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attn_bwd.cu")) as f:
        return f.read()


def _constant(name):
    """An integer ``constexpr int`` of flash_attn_bwd.cu."""
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    return int(m.group(1))


def _of_d(function, d):
    """The value at head dim ``d`` of a ``constexpr int`` function of D of
    flash_attn_bwd.cu whose body is ``return D <op> N ? A : B;``."""
    m = re.search(rf"constexpr int {function}\(\) {{\s*return D (<=|==) "
                  rf"(\d+) \? (\d+) : (\d+);", _source())
    op, n, a, b = m.groups()
    hit = d <= int(n) if op == "<=" else d == int(n)
    return int(a) if hit else int(b)


def _fma_exp2(s, c, l2):
    """exp2(fma(s, c, -l2)) in fp32: the fma rounds once."""
    return torch.exp2((s.double() * c.double() - l2.double()).float())


def _rows(t, n):
    """``t`` [BH, L, ...] padded with zeros to ``n`` rows (TMA's zeros past
    one (b, h)'s rows)."""
    pad = n - t.shape[1]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def _emulated_dq(q, k, v, do, lse, delta, dlse, causal, scale):
    """dq with the bf16 wgmma K2's arithmetic, for [BH, L, D] inputs that
    hold bf16 values: per 64-row query tile (rows past Lq zeros, their lse
    and dlse - delta 0), the 64-key tiles up to the causal end; s and dp
    exact products summed in fp32; per row l2 = lse·log2e and
    cr = dlse - delta; p = exp2(fma(s, c, -l2)), masked (key > query) at
    exp2(-1e30·log2e - l2), 0 past lk; ds / scale = p·(dp + cr) rounded
    to bf16; dq / scale += (ds / scale)·k in fp32, times the scale and
    rounded to bf16 on the store."""
    bm, bn = _constant("WG_BM"), _constant("WG_KEYS")
    bh, lq, d = q.shape
    lk = k.shape[1]
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E)
    dq = torch.zeros(q.shape)
    for q0 in range(0, lq, bm):
        qb = _rows(q[:, q0:q0 + bm], bm)
        dob = _rows(do[:, q0:q0 + bm], bm)
        rows = torch.arange(q0, q0 + bm)
        live = rows < lq
        l2 = torch.where(live, _rows(lse[:, q0:q0 + bm], bm) * LOG2E,
                         torch.zeros(()))[..., None]
        cr = torch.where(live, _rows((dlse - delta)[:, q0:q0 + bm], bm),
                         torch.zeros(()))[..., None]
        k_end = min(lk, q0 + bm, lq) if causal else lk
        acc = torch.zeros(bh, bm, d)
        for k0 in range(0, k_end, bn):
            kt = _rows(k[:, k0:k0 + bn], bn)
            vt = _rows(v[:, k0:k0 + bn], bn)
            cols = torch.arange(k0, k0 + bn)[None]
            s = torch.matmul(qb, kt.transpose(1, 2))
            dp = torch.matmul(dob, vt.transpose(1, 2))
            p = _fma_exp2(s, c, l2)
            if causal:
                p = torch.where(cols > rows[:, None],
                                torch.exp2(MASKED2 - l2), p)
            p = torch.where(cols >= lk, torch.zeros(()), p)
            ds = p * (dp + cr)
            acc += torch.matmul(ds.bfloat16().float(), kt)
        n = min(bm, lq - q0)
        dq[:, q0:q0 + n] = (acc[:, :n] * scale).bfloat16().float()
    return dq


def _flat_rows(t, q0, n):
    """K3's rank-1 read of ``n`` values of the flat [BH·Lq] rows at each
    (b, h)'s query q0: past one (b, h)'s rows it reads the next one's, and
    zeros past the last."""
    bh, lq = t.shape
    idx = torch.arange(bh)[:, None] * lq + q0 + torch.arange(n)[None]
    flat = torch.cat([t.reshape(-1), t.new_zeros(n)])
    return flat[idx.clamp(max=bh * lq)]


def _emulated_dkv(q, k, v, do, lse, delta, dlse, causal, scale):
    """(dk, dv) with the bf16 wgmma K3's arithmetic: per 64-key tile, the
    query tiles (wg_query_rows at this D) from the first that reaches the
    tile's first key under the causal mask; s^T and dp^T exact products
    summed in fp32; per query l2 = lse·log2e and cq = dlse - delta from the
    flat rows; p = exp2(fma(s, c, -l2)), masked (key > query) at
    exp2(-1e30·log2e - l2), 0 past lq; ds / scale = p·(dp + cq); p and
    ds / scale rounded to bf16; dv += pᵀ·dO and dk / scale +=
    (ds / scale)ᵀ·q in fp32, dk times the scale, both rounded to bf16 on
    the store."""
    bm = _constant("WG_BM")
    bh, lq, d = q.shape
    lk = k.shape[1]
    bn = _of_d("wg_query_rows", d)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for k0 in range(0, lk, bm):
        kt = _rows(k[:, k0:k0 + bm], bm)
        vt = _rows(v[:, k0:k0 + bm], bm)
        keys = torch.arange(k0, k0 + bm)[:, None]
        adk, adv = torch.zeros(bh, bm, d), torch.zeros(bh, bm, d)
        for q0 in range((k0 // bn) * bn if causal else 0, lq, bn):
            qt = _rows(q[:, q0:q0 + bn], bn)
            dot = _rows(do[:, q0:q0 + bn], bn)
            cols = torch.arange(q0, q0 + bn)[None]
            l2 = (_flat_rows(lse, q0, bn) * LOG2E)[:, None]
            cq = (_flat_rows(dlse, q0, bn) -
                  _flat_rows(delta, q0, bn))[:, None]
            st = torch.matmul(kt, qt.transpose(1, 2))
            dpt = torch.matmul(vt, dot.transpose(1, 2))
            p = _fma_exp2(st, c, l2)
            if causal:
                p = torch.where(keys > cols, torch.exp2(MASKED2 - l2), p)
            p = torch.where(cols >= lq, torch.zeros(()), p)
            ds = p * (dpt + cq)
            adv += torch.matmul(p.bfloat16().float(), dot)
            adk += torch.matmul(ds.bfloat16().float(), qt)
        n = min(bm, lk - k0)
        dk[:, k0:k0 + n] = (adk[:, :n] * scale).bfloat16().float()
        dv[:, k0:k0 + n] = adv[:, :n].bfloat16().float()
    return dk, dv


def _bf16_inputs(seed, q_shape, lk):
    """q, k, v and dO ~ N(0, 1) rounded to bf16 and held as fp32 arrays,
    so both packages see the same bf16 values, and a nonzero dLSE."""
    b, h, lq, d = q_shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   .bfloat16().float().numpy()
                   for s in (q_shape, (b, h, lk, d), (b, h, lk, d), q_shape))
    dlse = rng.randn(b, h, lq).astype(np.float32)
    return q, k, v, do, dlse


def _grad_rel(got, want):
    """max |got - want| over max |want| (over 1 where want is all zero:
    dq and dk at a scale of 0)."""
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _emulated(q, k, v, do, lse, delta, dlse, causal, scale):
    """(dq, dk, dv) [B, H, L, D] of both emulations from numpy arrays."""
    b, h, lq, d = q.shape
    flat = [torch.from_numpy(np.ascontiguousarray(a)).reshape(
        b * h, a.shape[2], *a.shape[3:]) for a in (q, k, v, do)]
    rows = [torch.tensor(a, dtype=torch.float32).reshape(b * h, lq)
            for a in (lse, delta, dlse)]
    dq = _emulated_dq(*flat, *rows, causal, scale)
    dk, dv = _emulated_dkv(*flat, *rows, causal, scale)
    return [g.reshape(b, h, -1, d).numpy() for g in (dq, dk, dv)]


def _check_against_pallas(causal, q_shape, lk, scale):
    q, k, v, do, dlse = _bf16_inputs(31, q_shape, lk)
    lq = q_shape[2]
    blocks = dict(block_q=min(128, lq), block_k=min(128, lk))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o, lse = pk._pallas_attention_fwd(jq, jk, jv, causal=causal, scale=scale,
                                      interpret=True, **blocks)
    want = pk._pallas_attention_bwd(
        jq, jk, jv, o, lse, jnp.asarray(do), jnp.asarray(dlse),
        causal=causal, scale=scale, interpret=True, **blocks)
    delta = (do * np.asarray(o)).sum(-1, dtype=np.float32)
    got = _emulated(q, k, v, do, np.asarray(lse), delta, dlse, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert _grad_rel(g, w) <= GRAD_TOL, (name, _grad_rel(g, w))


# (q shape, lk): every head dim the kernels are built for (32-, 64- and
# 128-byte swizzles, two column blocks and K3's 32-query tiles at 128),
# Lq < Lk and Lq > Lk, a ragged Lq (a query tile past the last row; K3's
# rows of the next (b, h)) at D 64 and 128, and a ragged Lk
WGMMA_BWD_CASES = [((2, 2, 128, 16), 256), ((1, 2, 128, 32), 128),
                   ((1, 2, 256, 64), 128), ((1, 1, 256, 128), 256),
                   ((1, 2, 64, 16), 256), ((2, 2, 100, 64), 128),
                   ((2, 1, 72, 128), 128), ((2, 1, 128, 64), 100)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", WGMMA_BWD_CASES)
def test_wgmma_bwd_arithmetic_matches_pallas_bwd(causal, q_shape, lk):
    """K2's and K3's bf16 arithmetic (emulated) against the JAX package's
    `_pallas_attention_bwd` in interpret mode, on dq, dk and dv with a
    nonzero dLSE."""
    _check_against_pallas(causal, q_shape, lk, q_shape[-1] ** -0.5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_wgmma_bwd_arithmetic_at_any_scale(causal, scale):
    """A scale of zero or below: the fold p = exp2(fma(s, c, -l2)) takes
    no row max, so it holds for any sign of c."""
    _check_against_pallas(causal, (1, 2, 128, 64), 256, scale)


@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_bwd_arithmetic_matches_the_plain_versions(causal):
    """The same emulation against the port's plain versions, the card's
    yardstick in chip_smoke.py, at 22a's head width over several tiles."""
    q, k, v, do, dlse = (torch.from_numpy(a) for a in
                         _bf16_inputs(37, (1, 2, 512, 64), 512))
    scale = 64 ** -0.5
    o, lse = hk._flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                scale=scale)
    delta = (do * o).sum(-1)
    args = [t.bfloat16() for t in (q, k, v, do)] + [lse, delta, dlse]
    want = (hk._attn_dq_plain(*args, causal=causal, scale=scale),
            *hk._attn_dkv_plain(*args, causal=causal, scale=scale))
    got = _emulated(*(t.numpy() for t in (q, k, v, do, lse, delta, dlse)),
                    causal, scale)
    for g, w in zip(got, want):
        assert _grad_rel(g, w.float().numpy()) <= GRAD_TOL


def _body(function):
    """The source of a function of flash_attn_bwd.cu, up to the next
    top-level closing brace."""
    src = _source()
    start = re.search(rf"\n\S[^\n]* {function}\(", src).start()
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("function", ["dispatch_fp32", "dispatch_bf16"])
def test_each_dtype_dispatches_every_wrapper_head_dim(function):
    """Both of the entry points' switches (fp32 on mma.sync, bf16 on
    wgmma) launch a kernel at every head dim the wrapper lets through."""
    cases = tuple(int(x) for x in re.findall(r"case (\d+):",
                                             _body(function)))
    assert cases == hk.KERNEL_HEAD_DIMS


def test_bf16_dispatch_names_only_the_wgmma_kernels():
    """bf16 reaches K2's and K3's wgmma kernels and nothing else; the
    mma.sync kernels take fp32 only (no bf16 instantiation is left)."""
    bf16 = _body("launch_bf16")
    assert set(re.findall(r"launch_\w+<", bf16)) == {
        "launch_dkv_wgmma<", "launch_dq_wgmma<"}
    assert "flash_attn_bwd_dq_wgmma_kernel<" in _body("launch_dq_wgmma")
    assert "flash_attn_bwd_dkv_wgmma_kernel<" in _body("launch_dkv_wgmma")
    assert "dispatch_bf16<" in _body("dispatch") and \
        "dispatch_fp32<" in _body("dispatch")
    for kernel in ("flash_attn_bwd_dq_kernel", "flash_attn_bwd_dkv_kernel"):
        head = _source()[_source().index(f"\n{kernel}("):]
        head = head[:head.index(")")]
        assert "bf16" not in head and "const float* __restrict__ q" in head


@pytest.mark.parametrize("dkv", [False, True])
@pytest.mark.parametrize("d", hk.KERNEL_HEAD_DIMS)
def test_wgmma_bwd_tiles_fit_their_blocks_per_sm(d, dkv):
    """Each wgmma kernel's shared memory (WgBwdSmem: the owned pair of
    tiles, WG_STAGES stages of the streamed pair and, for K3, of the lse,
    delta and dlse rows, 5 barriers and 1 KB of alignment) times the
    blocks per SM its __launch_bounds__ ask for fits the H100's 228 KB an
    SM (1 KB of it reserved per block); each tile is a whole number of
    1024-byte swizzle atoms, each row array of 128-byte TMA boxes, and a
    tile row one of TMA's swizzle widths."""
    bm, stages = _constant("WG_BM"), _constant("WG_STAGES")
    if dkv:
        bn, blocks = _of_d("wg_query_rows", d), _of_d("wg_dkv_blocks", d)
    else:
        bn, blocks = _constant("WG_KEYS"), _of_d("wg_dq_blocks", d)
    own, tile, row = bm * d * 2, bn * d * 2, bn * 4 if dkv else 0
    smem = 2 * own + 2 * stages * tile + 3 * stages * row + \
        (1 + 2 * stages) * 8 + 1024
    assert blocks * (smem + BLOCK_RESERVED) <= SM_SMEM_KB * 1024
    assert own % 1024 == 0 and tile % 1024 == 0 and row % 128 == 0
    assert min(d, 64) * 2 in (32, 64, 128)
    # the block's threads: one consumer warpgroup and one producer warp
    assert _constant("WG_CONSUMERS") == 128
    assert bn in (32, 64) and bm == 64
