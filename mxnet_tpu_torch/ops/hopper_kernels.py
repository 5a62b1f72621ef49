"""Hand-written Hopper kernels for the hot ops (the counterpart of
`mxnet_tpu/ops/pallas_kernels.py`).

* `flash_attention` / `flash_attention_with_lse` — K1, the streaming
  online-softmax attention forward, in CUDA C++ (`csrc/flash_attn_fwd.cu`,
  replacing `pallas_kernels.py:_attn_fwd_kernel`; fp32 in three TF32
  passes and bf16 both on wgmma fed by TMA, `csrc/hopper_wgmma.cuh`),
  and its gradient: K2 (dq) and K3 (dk, dv) in `csrc/flash_attn_bwd.cu`,
  replacing `_attn_dq_kernel` and `_attn_dkv_kernel` (fp32 on mma.sync,
  bf16 on wgmma fed by TMA).  The pair is one
  `torch.autograd.Function`, as the JAX package's is one `jax.custom_vjp`.
  It backs the `_fused_attention` op, which `graph_opt`'s
  ``pallas_select`` pass swaps in for MXNet's batch_dot/softmax attention
  idiom and which a training graph may hold itself.
* `lstm_gates` — K4, the fused LSTM cell update (c' and h' from the [B, 4H]
  gate pre-activations and c), in CUDA C++ (`csrc/lstm_gates.cu`,
  replacing `pallas_kernels.py:_lstm_gate_kernel`), forward only as in the
  reference.  It backs the `_fused_lstm_gates` op, which ``pallas_select``
  swaps in for the unfused cell math of `rnn.LSTMCell`.

Each kernel sits beside its plain PyTorch version.  A wrapper takes the
plain version only for a tensor on the CPU (``meta`` tensors, which carry
shapes and no values, take it too for shape inference); on a CUDA tensor
it launches the kernel or raises.  `LAUNCHES` counts launches per kernel,
so a run can show that its path went through the kernels: `count_launch`
adds to it under a lock, and a launch on a stream inside
`recording_launches` (the stream a CUDA graph is being captured on, whose
launches run nothing until a replay) counts into that capture's dict
instead, from whichever thread makes it (autograd runs a captured
backward on its own thread, on the forward's stream), so a capture
neither takes nor hides the replays other threads count meanwhile.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..base import MXNetError
from . import cuda_build
from .registry import register

__all__ = ["flash_attention", "flash_attention_with_lse", "check_attention",
           "check_kernel_inputs", "KERNEL_HEAD_DIMS", "lstm_gates",
           "check_lstm_kernel_inputs", "LAUNCHES", "reset_launch_counts",
           "count_launch", "recording_launches"]

#: launches per kernel since the last `reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                            "flash_attn_bwd_dkv": 0, "lstm_gates": 0}


_LAUNCH_LOCK = threading.Lock()
#: raw stream handle -> the launch record of the capture running on it
_RECORDING: Dict[int, Dict[str, int]] = {}


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(kernel: str, n: int = 1, stream: int = 0) -> None:
    """Count ``n`` launches of ``kernel`` made on raw stream handle
    ``stream``: into the record of a capture on that stream, else into
    `LAUNCHES`."""
    with _LAUNCH_LOCK:
        rec = _RECORDING.get(stream) if stream else None
        if rec is not None:
            rec[kernel] = rec.get(kernel, 0) + n
        else:
            LAUNCHES[kernel] += n


@contextlib.contextmanager
def recording_launches(stream: int):
    """The launches counted on raw stream handle ``stream`` inside, by
    any thread, as a dict {kernel: n} kept out of `LAUNCHES`."""
    counts: Dict[str, int] = {}
    with _LAUNCH_LOCK:
        if stream in _RECORDING:
            raise MXNetError(f"stream 0x{stream:x} is already recording")
        _RECORDING[stream] = counts
    try:
        yield counts
    finally:
        with _LAUNCH_LOCK:
            del _RECORDING[stream]


_NEG_INF = -1e30
#: head dims the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# shape rules
# ---------------------------------------------------------------------------

def check_attention(q_shape, k_shape, v_shape) -> None:
    """Raise `ValueError` for shapes the attention op does not take, by the
    JAX package's rule: q [B,H,Lq,D] (or [G,Lq,D]) and k, v of the same
    leading dims and D, where a sequence longer than 128 must be a multiple
    of 128.  `graph_opt` applies it per matched site, so a site keeps its
    unfused graph exactly where the JAX package's does."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) not in (3, 4) or len(k_shape) != len(q_shape) or \
            tuple(v_shape) != k_shape:
        raise ValueError(f"flash_attention: want q [B,H,Lq,D] and k, v "
                         f"[B,H,Lk,D] (or without B); got {q_shape}, "
                         f"{k_shape}, {tuple(v_shape)}")
    lq, d = q_shape[-2:]
    if k_shape[:-2] != q_shape[:-2] or k_shape[-1] != d:
        raise ValueError(f"flash_attention: q {q_shape} and k {k_shape} "
                         "disagree on the leading dims or D")
    lk = k_shape[-2]
    block_q, block_k = min(128, lq), min(128, lk)
    if lq % block_q or lk % block_k:
        raise ValueError(
            f"flash_attention: seq lengths ({lq}, {lk}) must divide block "
            f"sizes ({block_q}, {block_k}) — pad inputs")


def check_kernel_inputs(head_dim: int, dtype: Optional[torch.dtype]) -> None:
    """Raise `ValueError` for a head dim (or, when given, a dtype) the CUDA
    kernels are not built for.  The JAX package's kernels take any of
    them, so on the card such a site fails rather than run unfused
    unasked."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if dtype is not None and dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: the kernel takes float32 "
                         f"and bfloat16, got {dtype}")


def _check_cuda_inputs(*tensors) -> None:
    """What every kernel wrapper checks before it hands out pointers: one
    device, one dtype the kernel is built for, contiguous [.., L, D]."""
    first = tensors[0]
    device, dtype = first.device, first.dtype
    for t in tensors:
        if t.device != device:
            raise ValueError("flash_attention: inputs must be on one device")
        if t.dtype != dtype:
            raise ValueError("flash_attention: q, k, v must share a dtype")
        if not t.is_contiguous():
            raise ValueError("flash_attention: the kernel takes contiguous "
                             "[B,H,L,D] tensors")
    check_kernel_inputs(first.shape[-1], dtype)


#: each C entry point: (source, counter, pointers, ints, takes a scale);
#: every entry point takes the stream last
_ENTRIES = {
    "mxtt_flash_attn_fwd": ("flash_attn_fwd", "flash_attn_fwd", 5, 6, True),
    "mxtt_flash_attn_bwd_dq": ("flash_attn_bwd", "flash_attn_bwd_dq", 8, 6,
                               True),
    "mxtt_flash_attn_bwd_dkv": ("flash_attn_bwd", "flash_attn_bwd_dkv", 9, 6,
                                True),
    "mxtt_lstm_gates": ("lstm_gates", "lstm_gates", 4, 4, False),
}
_FNS: Dict[str, Callable[..., int]] = {}


def _kernel_fn(entry: str) -> Callable[..., int]:
    """The `ctypes` function of a kernel entry point with its C signature
    declared, bound once (the library is built at first use)."""
    fn = _FNS.get(entry)
    if fn is None:
        source, _, n_ptrs, n_ints, scale = _ENTRIES[entry]
        fn = getattr(cuda_build.load(source), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + \
            [ctypes.c_int] * n_ints + \
            ([ctypes.c_float] if scale else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def _cuda_error(entry: str, err: int) -> MXNetError:
    lib = cuda_build.load(_ENTRIES[entry][0])
    lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return MXNetError(f"{_ENTRIES[entry][1]} launch failed: CUDA error {err} "
                      f"({lib.mxtt_cuda_error_string(err).decode()})")


def _current_device() -> int:
    """The current CUDA device's index (the tensors that reach a kernel
    wrapper have initialized CUDA already)."""
    return torch._C._cuda_getDevice()


def _current_stream(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream (no
    `torch.cuda.Stream` object is built for it)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _call(entry: str, index: int, *args) -> None:
    """Launch one kernel entry point with ``args`` on the current stream of
    CUDA device ``index``, which is made the current device only when it is
    not already; raise if the launch was refused, count it if not."""
    fn = _kernel_fn(entry)
    stream = _current_stream(index)
    if _current_device() == index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise _cuda_error(entry, err)
    count_launch(_ENTRIES[entry][1], stream=stream)


def _launch(entry: str, q, k, ptrs, causal, scale) -> None:
    """Launch an attention kernel over q [.., Lq, D] and k [.., Lk, D],
    the leading dims flattened into one b·h axis."""
    lq, d = q.shape[-2:]
    _call(entry, q.get_device(), *[t.data_ptr() for t in ptrs],
          q.numel() // (lq * d), lq, k.shape[-2], d, _DTYPE_CODES[q.dtype],
          int(causal), scale)


# ---------------------------------------------------------------------------
# K1: flash attention forward
# ---------------------------------------------------------------------------

def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    """Key j is visible to query i when j <= i (top-left aligned)."""
    return torch.ones((lq, lk), dtype=torch.bool, device=device).tril()


def _flash_attention_with_lse_plain(q, k, v, *, causal: bool = False,
                                    scale: Optional[float] = None):
    """Plain version of K1: softmax(scale·QKᵀ [+ causal mask]) V and the
    row logsumexp, in fp32, O cast back to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], s.device), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


def _flash_attention_with_lse_cuda(q, k, v, causal: bool, scale: float):
    _check_cuda_inputs(q, k, v)
    q, k, v = _aligned(q, k, v)
    o = torch.empty_like(q)
    lse = q.new_empty(q.shape[:-1], dtype=torch.float32)
    _launch("mxtt_flash_attn_fwd", q, k, (q, k, v, o, lse), causal, scale)
    return o, lse


# ---------------------------------------------------------------------------
# K2 / K3: flash attention backward
# ---------------------------------------------------------------------------

def _attn_p_ds(q, k, v, do, lse, delta, dlse, causal, scale):
    """The kernels' shared algebra in fp32: P recomputed from the saved
    logsumexp, and dS = P ∘ (dO·Vᵀ − Δ + dLSE) · scale."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], s.device), _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None] + dlse[..., None]) * scale


def _attn_dq_plain(q, k, v, do, lse, delta, dlse, *, causal: bool,
                   scale: float):
    """Plain version of K2: dq = dS·K, in q's dtype."""
    _, ds = _attn_p_ds(q, k, v, do, lse, delta, dlse, causal, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def _attn_dkv_plain(q, k, v, do, lse, delta, dlse, *, causal: bool,
                    scale: float):
    """Plain version of K3: dk = dSᵀ·Q and dv = Pᵀ·dO, in k's and v's
    dtypes."""
    p, ds = _attn_p_ds(q, k, v, do, lse, delta, dlse, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _aligned(*tensors):
    """K1 reads its [L, D] tiles by TMA, K2 and K3 with 16-byte cp.async
    (fp32) or by TMA (bf16; K3's lse, delta and dlse rows too), which want
    a 16-byte aligned base: a tensor whose storage starts elsewhere (a
    contiguous view at an odd offset) is copied to fresh, aligned memory
    first."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def _attn_dq_cuda(q, k, v, do, lse, delta, dlse, *, causal, scale):
    _check_cuda_inputs(q, k, v, do)
    q, k, v, do = _aligned(q, k, v, do)
    dq = torch.empty_like(q)
    _launch("mxtt_flash_attn_bwd_dq", q, k,
            (q, k, v, do, lse, delta, dlse, dq), causal, scale)
    return dq


def _attn_dkv_cuda(q, k, v, do, lse, delta, dlse, *, causal, scale):
    _check_cuda_inputs(q, k, v, do)
    q, k, v, do, lse, delta, dlse = _aligned(q, k, v, do, lse, delta, dlse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("mxtt_flash_attn_bwd_dkv", q, k,
            (q, k, v, do, lse, delta, dlse, dk, dv), causal, scale)
    return dk, dv


def _attention_backward(q, k, v, o, lse, do, dlse, causal: bool,
                        scale: float):
    """(dq, dk, dv) for the cotangents ``do`` of O and ``dlse`` of the
    logsumexp (either may be None: no gradient flows into that output).
    Δ = rowsum(dO∘O) is taken here in fp32, as the JAX package takes it
    outside its kernels; K2 and K3 run on CUDA tensors, their plain
    versions on CPU tensors."""
    do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
    dlse = torch.zeros_like(lse) if dlse is None else \
        dlse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse)
    if q.device.type == "cuda":
        return (_attn_dq_cuda(*args, causal=causal, scale=scale),
                *_attn_dkv_cuda(*args, causal=causal, scale=scale))
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    return (_attn_dq_plain(*args, causal=causal, scale=scale),
            *_attn_dkv_plain(*args, causal=causal, scale=scale))


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the JAX package's `custom_vjp` at
    `pallas_kernels.py:275`).  Both outputs, O and the logsumexp, take a
    gradient.  There is no double backward, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cuda":
            o, lse = _flash_attention_with_lse_cuda(q, k, v, causal, scale)
        elif q.device.type in ("cpu", "meta"):
            o, lse = _flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                     scale=scale)
        else:
            raise MXNetError(
                f"flash_attention: no kernel for device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _attention_backward(q, k, v, o, lse, do, dlse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over q [B,H,Lq,D], k and v [B,H,Lk,D] (flash-attention
    style) that also returns the row logsumexp [B,H,Lq] in fp32.  The B
    axis may be left out ([H,L,D], MXNet's batch_dot layout).  ``scale``
    defaults to D^-0.5; ``causal`` masks key j > query i.  Differentiable
    in q, k and v through both outputs."""
    check_attention(q.shape, k.shape, v.shape)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """`flash_attention_with_lse` without the logsumexp."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


@register("_fused_attention", num_inputs=3,
          input_names=["query", "key", "value"])
def _fused_attention_op(attrs, q, k, v):
    """nd/sym surface of the attention kernels (what `graph_opt`'s
    ``pallas_select`` rewires matched attention subgraphs to, and what a
    training graph names itself).  The copies to contiguous layout stay
    inside the autograd graph, so gradients flow back through them to a
    transposed input."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=attrs.get_bool("causal", False),
                           scale=attrs.get_float("scale", None))


# ---------------------------------------------------------------------------
# K4: the fused LSTM cell update
# ---------------------------------------------------------------------------

def _check_lstm_shapes(gates_shape, c_shape) -> None:
    """Raise `ValueError` unless gates is [B, 4H] and c_prev [B, H]."""
    if len(gates_shape) != 2 or len(c_shape) != 2 or \
            gates_shape[0] != c_shape[0] or gates_shape[1] != 4 * c_shape[1]:
        raise ValueError(f"lstm_gates: want gates [B, 4H] and c_prev "
                         f"[B, H]; got {tuple(gates_shape)} and "
                         f"{tuple(c_shape)}")


def check_lstm_kernel_inputs(gates: torch.Tensor,
                             c_prev: torch.Tensor) -> None:
    """Raise `ValueError` for inputs the CUDA kernel does not take: shapes
    other than [B, 4H] and [B, H], two devices, a dtype other than
    float32 or bfloat16 (each input on its own), or a strided input.  The
    kernel's wrapper calls it once a launch, so it stays cheap."""
    _check_lstm_shapes(gates.shape, c_prev.shape)
    if gates.device != c_prev.device:
        raise ValueError("lstm_gates: gates and c_prev must be on one "
                         "device")
    if gates.dtype in _DTYPE_CODES and c_prev.dtype in _DTYPE_CODES and \
            gates.is_contiguous() and c_prev.is_contiguous():
        return
    for name, t in (("gates", gates), ("c_prev", c_prev)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"lstm_gates: the kernel takes float32 and "
                             f"bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_gates: the kernel takes a contiguous "
                             f"{name}")


def _lstm_gates_plain(gates: torch.Tensor, c_prev: torch.Tensor):
    """Plain version of K4, the JAX kernel's body line for line: fp32 math
    over the i|f|g|o quarters of the gates, outputs in c_prev's dtype."""
    hidden = gates.shape[1] // 4
    g = gates.float()
    c = c_prev.float()
    i = torch.sigmoid(g[:, 0 * hidden:1 * hidden])
    f = torch.sigmoid(g[:, 1 * hidden:2 * hidden])
    gg = torch.tanh(g[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(g[:, 3 * hidden:4 * hidden])
    c_new = f * c + i * gg
    return c_new.to(c_prev.dtype), (o * torch.tanh(c_new)).to(c_prev.dtype)


def _lstm_gates_cuda(gates: torch.Tensor, c_prev: torch.Tensor):
    """K4 on the card.  The LM's path calls it 2·T times a forward at a
    size where the kernel takes about 2 µs, so the host's share is kept
    small: one validation, the raw device index and stream handle, and the
    `ctypes` function bound once.  The outputs are two allocations: the two
    halves of one [2, B, H] allocation would cost two views, and a view
    costs PyTorch's dispatcher more host time than an allocation."""
    check_lstm_kernel_inputs(gates, c_prev)
    if torch.is_grad_enabled() and (gates.requires_grad or
                                    c_prev.requires_grad):
        raise MXNetError("lstm_gates: the kernel is forward only, as the "
                         "reference's; a gradient through it is not "
                         "defined")
    b, h = c_prev.shape
    c_new, h_new = torch.empty_like(c_prev), torch.empty_like(c_prev)
    if b * h:
        _call("mxtt_lstm_gates", gates.get_device(), gates.data_ptr(),
              c_prev.data_ptr(), c_new.data_ptr(), h_new.data_ptr(), b, h,
              _DTYPE_CODES[gates.dtype], _DTYPE_CODES[c_prev.dtype])
    return c_new, h_new


def lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM elementwise update: gates [B, 4H] (i|f|g|o
    pre-activations) and c_prev [B, H] → (c_new, h_new) in c_prev's dtype,
    c' = σ(f)·c + σ(i)·tanh(g) and h' = σ(o)·tanh(c'), in fp32 math.
    Forward only, as in the reference."""
    if gates.is_cuda:
        return _lstm_gates_cuda(gates, c_prev)
    _check_lstm_shapes(gates.shape, c_prev.shape)
    if gates.device.type in ("cpu", "meta") and \
            c_prev.device == gates.device:
        return _lstm_gates_plain(gates, c_prev)
    raise MXNetError(f"lstm_gates: no kernel for devices {gates.device} "
                     f"and {c_prev.device}")


@register("_fused_lstm_gates", num_inputs=2, num_outputs=2,
          input_names=["gates", "c_prev"])
def _fused_lstm_gates_op(attrs, gates, c_prev):
    """nd/sym surface of K4, what `graph_opt`'s ``pallas_select`` rewires
    the matched LSTM gate math to (outputs: c_new, h_new).  A first step's
    zero state arrives as a broadcast view; the copy to contiguous layout
    is a no-op for every other input."""
    return lstm_gates(gates.contiguous(), c_prev.contiguous())
