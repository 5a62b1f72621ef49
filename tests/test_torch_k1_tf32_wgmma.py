"""K1's fp32 kernel on wgmma and TMA (`csrc/flash_attn_fwd.cu`,
``flash_attn_fwd_tf32_kernel``), its arithmetic emulated on the CPU and
held against the JAX package's `_pallas_attention_fwd` in interpret mode.

The kernel itself runs only on the card (chip_smoke.py phase 3 holds it
against the plain PyTorch version there); this file is the chip-free
evidence that its design keeps fp32 parity: q scaled, then q and each K
and V tile split once into TF32 big and small parts by `hopper_mma.cuh`'s
rule (big rounded to nearest, ties away; small cut toward zero), both
products in three passes per 8 columns with the small terms first, the
running max in base 2 with p = exp2(fma(s, log2 e, -m)), p split into its
parts for p·v, p·v summed over every PV_KEYS keys on its own and added into
O in fp32, blocks of WGS consumer warpgroups of 64 query rows, each
skipping the key tiles past its causal diagonal, and ragged rows and keys
past Lq and Lk.  It also reads the source's layout of V's transposed
parts back the way wgmma's descriptors read them."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_build
from mxnet_tpu_torch.ops import hopper_kernels as hk

import chip_smoke as cs

# the reference's forward-attention tolerance (tests/test_pallas.py), the
# fp32 TOL chip_smoke.py holds the kernel to
TOL = 2e-4
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
MASKED = np.float32(-1e30)
# sign, exponent and TF32's 10 mantissa bits (0xffffe000 as an int32)
TF32_MASK = -8192


def _source():
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attn_fwd.cu")) as f:
        return f.read()


def _constant(name):
    """An integer ``constexpr int`` of flash_attn_fwd.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def _per_dim(name, d):
    """A `TfCfg` member of the form ``NAME = D == 128 ? a : b;``."""
    m = re.search(rf"int {name} = D == 128 \? (\d+) : (\d+);", _source())
    return int(m.group(1) if d == 128 else m.group(2))


def _tiles(d):
    """(query rows of a block, its consumer warpgroups, keys of a tile)."""
    wgs = _per_dim("WGS", d)
    return 64 * wgs, wgs, _per_dim("BN", d)


def _pv_keys():
    """Keys of one p·v sum: PV_KEYS = SUM_CHUNKS * 8."""
    assert re.search(r"constexpr int PV_KEYS = SUM_CHUNKS \* 8;", _source())
    return _constant("SUM_CHUNKS") * 8


def _split(x):
    """x's TF32 big part (rounded to nearest, ties away, by masking) and
    small part (x - big, cut toward zero), as `hmma::split` takes them."""
    hi = ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def _product(a, b, passes):
    """a @ b as the kernel's wgmma products take it: per 8 columns of a
    (rows of b), the small·big, big·small and big·big passes in that order
    (``passes`` 1: the big·big pass alone), each added in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
        for x, y in terms:
            out = out + x[..., ks] @ y[..., ks, :]
    return out


def _emulated_tf32_forward(q, k, v, causal, scale, passes=3):
    """(O, lse) with the fp32 kernel's arithmetic: per block of BM query
    rows, each consumer warpgroup's 64 rows walk the key tiles (BN keys,
    zeros past lk) up to their own causal end; s = (q·scale)·kᵀ and each
    PV_KEYS-key part of p·v by `_product`, masks at -1e30 (causal) and -inf
    (past lk), m in base 2, p = exp2(fma(s, log2 e, -m)), acc rescaled by
    alpha and each p·v sum added in fp32, O = acc / max(l, 1e-30) and
    lse = m·ln2 + log(l)."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    bm, wgs, bn = _tiles(d)
    pv_keys = _pv_keys()
    qs = q * torch.tensor(scale, dtype=torch.float32)
    o = torch.zeros(q.shape)
    lse = torch.zeros(q.shape[:-1])
    for q0 in range(0, lq, bm):
        for w in range(wgs):
            r0 = q0 + 64 * w
            if r0 >= lq:
                break
            r1 = min(r0 + 64, lq)
            rows = torch.arange(r0, r1)[:, None]
            k_end = min(lk, r0 + 64, lq) if causal else lk
            m = torch.full(q.shape[:-2] + (r1 - r0,), float(MASKED * LOG2E))
            l = torch.zeros(m.shape)
            acc = torch.zeros(q.shape[:-2] + (r1 - r0, d))
            for k0 in range(0, k_end, bn):
                kt, vt = k[..., k0:k0 + bn, :], v[..., k0:k0 + bn, :]
                pad = bn - kt.shape[-2]     # a tile past lk: TMA's zeros
                if pad:
                    kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
                    vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
                s = _product(qs[..., r0:r1, :], kt.transpose(-1, -2), passes)
                cols = torch.arange(k0, k0 + bn)[None]
                if causal:
                    s = s.masked_fill(cols > rows, float(MASKED))
                s = s.masked_fill(cols >= lk, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1) * LOG2E)
                alpha = torch.exp2(m - m_new)
                # one rounding, as fma's
                p = torch.exp2((s.double() * float(LOG2E) -
                                m_new.double()[..., None]).float())
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                for c0 in range(0, bn, pv_keys):
                    acc = acc + _product(p[..., c0:c0 + pv_keys],
                                         vt[..., c0:c0 + pv_keys, :], passes)
                m = m_new
            l = l.clamp_min(1e-30)
            o[..., r0:r1, :] = acc / l[..., None]
            lse[..., r0:r1] = m * LN2 + torch.log(l)
    return o, lse


def _qkv(seed, q_shape, lk):
    b, h, _, d = q_shape
    rng = np.random.RandomState(seed)
    return (rng.randn(*q_shape).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32))


# (q shape, lk): every head dim (64- and 128-byte swizzles, one to four
# column blocks, 32-key tiles and one warpgroup at 128), Lq < Lk and
# Lq > Lk, a ragged Lq (a block's second warpgroup past the rows, and one
# past its first), a ragged Lk (a tile past the last key)
TF32_CASES = [((2, 2, 128, 16), 128), ((1, 2, 128, 32), 256),
              ((1, 2, 256, 64), 128), ((1, 1, 128, 128), 256),
              ((1, 2, 100, 64), 128), ((1, 1, 40, 64), 128),
              ((1, 2, 96, 64), 100), ((1, 1, 72, 128), 72)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", TF32_CASES)
def test_tf32_arithmetic_matches_pallas_fwd(causal, q_shape, lk):
    """The fp32 kernel's arithmetic (emulated) against the JAX package's
    `_pallas_attention_fwd` in interpret mode, on O and the logsumexp."""
    _check_against_pallas(causal, q_shape, lk, q_shape[-1] ** -0.5)


@pytest.mark.parametrize("causal", [False, True])
def test_tf32_arithmetic_at_a_negative_scale(causal):
    """q is scaled before the split, so a scale below zero takes the same
    path: the scores come out of the product scaled."""
    _check_against_pallas(causal, (1, 2, 128, 64), 256, -0.125)


def _check_against_pallas(causal, q_shape, lk, scale):
    q, k, v = _qkv(31, q_shape, lk)
    o_ref, lse_ref = pk._pallas_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=min(128, q_shape[2]), block_k=min(128, lk),
        interpret=True)
    o, lse = _emulated_tf32_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_tf32_arithmetic_matches_the_plain_version(causal):
    """The same emulation against the port's plain version, the card's
    yardstick in chip_smoke.py, at BERT-base's head width over several key
    tiles and blocks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(37, (1, 2, 512, 64), 512))
    want_o, want_lse = hk._flash_attention_with_lse_plain(
        q, k, v, causal=causal, scale=64 ** -0.5)
    o, lse = _emulated_tf32_forward(q, k, v, causal, 64 ** -0.5)
    torch.testing.assert_close(o, want_o, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


# phase 3's fp32 K1 cases, one (batch, head) each
SPLIT_CASES = [((1, 1, 512, 64), 512), ((1, 1, 128, 64), 128),
               ((1, 1, 256, 16), 256), ((1, 1, 128, 64), 256),
               ((1, 1, 128, 32), 128), ((1, 1, 256, 128), 256),
               ((1, 1, 100, 64), 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,lk", SPLIT_CASES)
def test_split_limit_tells_three_passes_from_one(causal, q_shape, lk):
    """`chip_smoke`'s K1_SPLIT_TOL against the fp32 plain version, as
    phase 3 holds K1's O on the card: the emulated three-pass kernel stays
    within a tenth of it and the same kernel with one TF32 pass breaks it
    three times over."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(41, q_shape, lk))
    scale = q_shape[-1] ** -0.5
    want, _ = hk._flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                 scale=scale)

    def rel(passes):
        got, _ = _emulated_tf32_forward(q, k, v, causal, scale, passes)
        return ((got - want).abs().max() / want.abs().max()).item()

    assert rel(3) < cs.K1_SPLIT_TOL / 10
    assert rel(1) > 3 * cs.K1_SPLIT_TOL


def _rz(x):
    """float64 to float32 rounded toward zero: how the tensor cores leave
    each sum they accumulate."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _pv_drift(seed, std, keys, rows=256, lk=512, d=64):
    """O for one head of q, k, v ~ N(0, std²) with p·v taken as the
    kernel's wgmma products: per 8 keys three passes, each one's exact
    products added to its accumulator and cut to fp32 toward zero; p·v in
    one accumulator over the whole sequence (``keys`` None) or summed alone
    over every ``keys`` keys and added in fp32.  Returns (signed drift
    toward zero over mean |O|, max |error| over max |O|) against the
    exact O."""
    rng = np.random.RandomState(seed)
    q = rng.randn(rows, d).astype(np.float32) * std
    k, v = (rng.randn(lk, d).astype(np.float32) * std for _ in range(2))
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * d ** -0.5
    p64 = np.exp(s - s.max(1, keepdims=True))
    l64 = p64.sum(1, keepdims=True)
    o_exact = p64 @ v.astype(np.float64) / l64
    (ph, pl), (vh, vl) = (
        (a.double().numpy() for a in _split(torch.from_numpy(t)))
        for t in (p64.astype(np.float32), v))

    def steps(c, k0, k1):
        for j in range(k0, k1, 8):
            for a, b in ((pl, vh), (ph, vl), (ph, vh)):
                c = _rz(c.astype(np.float64) + a[:, j:j + 8] @ b[j:j + 8])
        return c

    if keys is None:
        acc = steps(np.zeros((rows, d), np.float32), 0, lk)
    else:
        acc = np.zeros((rows, d), np.float32)
        for k0 in range(0, lk, keys):
            acc = acc + steps(np.zeros((rows, d), np.float32), k0, k0 + keys)
    err = acc / l64.astype(np.float32) - o_exact
    return ((err * np.sign(o_exact)).mean() / np.abs(o_exact).mean(),
            np.abs(err).max() / np.abs(o_exact).max())


@pytest.mark.parametrize("std", [1.0, 0.55])
def test_bias_limit_tells_pv_sums_from_one_running_sum(std):
    """`chip_smoke`'s K1_BIAS_TOL, as phase 3 holds fp32 K1's signed drift
    on randn inputs (std 1) and as BERT's small scores give it (0.55): p·v
    in one truncating accumulator over the sequence breaks it, while its
    error stays within K1_SPLIT_TOL, and the kernel's sums of PV_KEYS keys
    added in fp32 stay within half of it."""
    run_bias, run_err = _pv_drift(43, std, None)
    sum_bias, _ = _pv_drift(43, std, _pv_keys())
    assert run_bias < -cs.K1_BIAS_TOL and run_err < cs.K1_SPLIT_TOL
    assert abs(sum_bias) < cs.K1_BIAS_TOL / 2


def _swizzle(off, row):
    """`hwg::swizzle<ROW>`: the 16-byte piece index XORed with the
    128-byte line index, over row / 16 pieces."""
    return off ^ (((off >> 7) & (row // 16 - 1)) << 4)


@pytest.mark.parametrize("d", hk.KERNEL_HEAD_DIMS)
def test_transposed_v_parts_read_back_as_the_p_fragments_want(d):
    """`split_vt`'s writes, modelled byte for byte: V's tile as TMA
    swizzles it ([BN keys][D] in column blocks of ROW-byte rows), each
    unit's four keys 2s + odd of an 8-key chunk written as one 16-byte
    piece of Vᵀ's 128-byte swizzled rows.  Read back the way p·v's
    descriptors read B (row n at (n // 8)·1024 + (n % 8)·128 of the
    32-key block, 8 keys at 32 bytes a step, the swizzle on the address),
    position s of each 8-key chunk holds key 2s (s < 4) or 2(s - 4) + 1:
    the keys p's A fragment slots t and t + 4 hold (chunk columns 2t and
    2t + 1 of the s accumulator)."""
    _, _, bn = _tiles(d)
    row = 128 if d >= 32 else 4 * d
    dc = row // 4
    v = np.arange(bn * d, dtype=np.int64).reshape(bn, d)
    raw = {}
    for key in range(bn):
        for col in range(d):
            off = (col // dc) * bn * row + key * row + (col % dc) * 4
            raw[_swizzle(off, row)] = v[key, col]
    vt = {}
    for u in range(d * bn // 4):            # split_vt's units
        dd, jh = u % d, u // d
        base = (dd // dc) * bn * row + (dd % dc) * 4
        key = 8 * (jh >> 1) + (jh & 1)
        vals = [raw[_swizzle(base + (key + 2 * i) * row, row)]
                for i in range(4)]
        pos = 4 * jh
        off = _swizzle((pos // 32) * d * 128 + dd * 128 + (pos % 32) * 4,
                       128)
        for i in range(4):
            assert off + 4 * i not in vt
            vt[off + 4 * i] = vals[i]
    for j in range(bn // 8):                # wgmma's B reads, step j
        start = (j // 4) * d * 128 + (j % 4) * 32
        for n in range(d):
            for s in range(8):
                addr = start + (n // 8) * 1024 + (n % 8) * 128 + 4 * s
                key = 8 * j + (2 * s if s < 4 else 2 * (s - 4) + 1)
                assert vt[_swizzle(addr, 128)] == v[key, n]


def _body(function):
    src = _source()
    body = src[src.index(f"cudaError_t {function}("):]
    return body[:body.index("\n}\n")]


def test_fp32_dispatch_names_only_the_kept_kernels():
    """Every head dim of fp32 dispatch launches the TF32 wgmma kernel, and
    the mma.sync kernel it replaced is gone from the source."""
    dispatch = _body("dispatch_fp32")
    cases = re.findall(r"case (\d+):\s+return (\w+)<(\d+), CAUSAL>",
                       dispatch)
    assert tuple(int(c) for c, _, _ in cases) == hk.KERNEL_HEAD_DIMS
    assert all(fn == "launch_tf32" and c == d for c, fn, d in cases)
    assert "flash_attn_fwd_tf32_kernel<" in _body("launch_tf32")
    assert "flash_attn_fwd_kernel" not in _source()


@pytest.mark.parametrize("d", hk.KERNEL_HEAD_DIMS)
def test_tf32_tiles_fit_their_block_per_sm(d):
    """The fp32 kernel's shared memory (Q's two parts, TF_STAGES stages of
    four K/V parts, the raw K and V tiles, 3 + 2·TF_STAGES barriers, 1 KB
    of alignment) fits the one block an SM its __launch_bounds__ ask for in
    the H100's 228 KB (1 KB of it reserved per block, at most 227 KB a
    block), and a Q/K row is one of TMA's swizzle widths."""
    bm, wgs, bn = _tiles(d)
    stages = _constant("TF_STAGES")
    assert re.search(r"__launch_bounds__\(TfCfg<D>::NT, 1\)", _source())
    smem = (2 * bm * d * 4 + 4 * stages * bn * d * 4 + 2 * bn * d * 4 +
            (3 + 2 * stages) * 8 + 1024)
    assert smem <= 227 * 1024 and smem + 1024 <= 228 * 1024
    assert min(d, 32) * 4 in (64, 128)
    # a block's threads: the consumer warpgroups and the splitter's 128
    assert 128 * wgs + _constant("TF_SPLITTERS") <= 1024
