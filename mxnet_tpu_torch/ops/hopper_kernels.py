"""Hand-written Hopper kernels for the hot ops (the counterpart of
`mxnet_tpu/ops/pallas_kernels.py`).

* `flash_attention` / `flash_attention_with_lse` — K1, the streaming
  online-softmax attention forward, in CUDA C++ (`csrc/flash_attn_fwd.cu`,
  replacing `pallas_kernels.py:_attn_fwd_kernel`).  It backs the
  `_fused_attention` op that `graph_opt`'s ``pallas_select`` pass swaps in
  for MXNet's batch_dot/softmax attention idiom.

Each kernel sits beside its plain PyTorch version.  A wrapper takes the
plain version only for a tensor on the CPU (``meta`` tensors, which carry
shapes and no values, take it too for shape inference); on a CUDA tensor
it launches the kernel or raises.  `LAUNCHES` counts launches per kernel,
so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..base import MXNetError
from . import cuda_build
from .registry import register

__all__ = ["flash_attention", "flash_attention_with_lse", "check_attention",
           "check_kernel_inputs", "KERNEL_HEAD_DIMS", "LAUNCHES",
           "reset_launch_counts"]

#: launches per kernel since the last `reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attn_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_NEG_INF = -1e30
#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# K1: flash attention forward
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
    kernel is not built for.  The JAX package's kernel takes any of them,
    so on the card such a site fails rather than run unfused unasked."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if dtype is not None and dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: the kernel takes float32 "
                         f"and bfloat16, got {dtype}")


def _flash_attention_with_lse_plain(q, k, v, *, causal: bool = False,
                                    scale: Optional[float] = None):
    """Plain version of K1: softmax(scale·QKᵀ [+ causal mask]) V and the
    row logsumexp, in fp32, O cast back to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


_K1 = None


def _k1():
    """The K1 entry point, with its C signature declared."""
    global _K1
    if _K1 is None:
        lib = cuda_build.load("flash_attn_fwd")
        fn = lib.mxtt_flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
        _K1 = lib
    return _K1


def _flash_attention_with_lse_cuda(q, k, v, causal: bool, scale: float):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only until the backward "
            "kernels (K2 dq, K3 dk/dv) arrive with the training slice")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention: q, k, v must share a dtype")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes contiguous "
                         "[B,H,L,D] tensors")
    lq, d = q.shape[-2:]
    check_kernel_inputs(d, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    lib = _k1()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the kernel sees the leading dims flattened into one b·h axis
        err = lib.mxtt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), q.numel() // (lq * d), lq, k.shape[-2], d,
            _DTYPE_CODES[q.dtype], int(causal), scale, stream)
    if err != 0:
        raise MXNetError(f"flash_attn_fwd launch failed: CUDA error {err} "
                         f"({lib.mxtt_cuda_error_string(err).decode()})")
    LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over q [B,H,Lq,D], k and v [B,H,Lk,D] (flash-attention
    style) that also returns the row logsumexp [B,H,Lq] in fp32.  The B
    axis may be left out ([H,L,D], MXNet's batch_dot layout).  ``scale``
    defaults to D^-0.5; ``causal`` masks key j > query i."""
    check_attention(q.shape, k.shape, v.shape)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cuda":
        return _flash_attention_with_lse_cuda(q, k, v, causal, scale)
    if q.device.type not in ("cpu", "meta"):
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    return _flash_attention_with_lse_plain(q, k, v, causal=causal,
                                           scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """`flash_attention_with_lse` without the logsumexp."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


@register("_fused_attention", num_inputs=3,
          input_names=["query", "key", "value"])
def _fused_attention_op(attrs, q, k, v):
    """nd/sym surface of K1 (what `graph_opt`'s ``pallas_select`` rewires
    matched attention subgraphs to)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=attrs.get_bool("causal", False),
                           scale=attrs.get_float("scale", None))
