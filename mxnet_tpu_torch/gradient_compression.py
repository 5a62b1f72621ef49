"""2-bit gradient compression with an error-feedback residual (the
counterpart of `mxnet_tpu/gradient_compression.py`; reference
`src/kvstore/gradient_compression-inl.h`, Quantize2BitKernel and
Dequantize2BitKernel, set by ``kvstore.set_gradient_compression({'type':
'2bit', 'threshold': t})``).

The arithmetic is the reference's::

    r  = residual + grad
    q  = +t if r >= t (code 0b11), -t if r <= -t (code 0b10), else 0
    residual' = r - q

and the wire form packs 16 two-bit codes into each uint32 word, element
j of a word at bit 2·(j mod 16), the JAX package's layout.  A local store
applies the quantized gradient; across processes a ``dist`` store gathers
each rank's packed words and sums their dequantized values
(`decompress_sum`).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_2bit", "dequantize_2bit", "pack_2bit", "unpack_2bit",
           "GradientCompression"]


def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the gradient quantized to {-t, 0, +t}, the new residual)."""
    r = residual + grad
    t = torch.full((), threshold, dtype=r.dtype, device=r.device)
    q = torch.where(r >= t, t, torch.where(r <= -t, -t, torch.zeros_like(t)))
    return q.to(grad.dtype), r - q


def dequantize_2bit(q: torch.Tensor, threshold: float) -> torch.Tensor:
    """The identity on the {-t, 0, +t} form (the reference's dequantize
    maps the codes back to these values)."""
    return q


def pack_2bit(q: torch.Tensor, threshold: float) -> torch.Tensor:
    """A {-t, 0, +t} array as uint32 words, 16 codes a word."""
    flat = q.reshape(-1)
    pad = (-flat.numel()) % 16
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    codes = torch.where(flat > 0, 3, torch.where(flat < 0, 2, 0)).to(
        torch.int64).reshape(-1, 16)
    shifts = torch.arange(16, device=q.device, dtype=torch.int64) * 2
    # the codes occupy disjoint bits, so the sum is their bitwise or
    return (codes << shifts).sum(dim=1).to(torch.uint32)


def unpack_2bit(words: torch.Tensor, threshold: float, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """`pack_2bit`'s inverse: uint32 words to a flat [n] array of
    {-t, 0, +t}."""
    shifts = torch.arange(16, device=words.device, dtype=torch.int64) * 2
    codes = (words.to(torch.int64)[:, None] >> shifts) & 3
    vals = torch.where(codes == 3, threshold,
                       torch.where(codes == 2, -threshold, 0.0))
    return vals.to(dtype).reshape(-1)[:n]


class GradientCompression:
    """A store's compression: its type, threshold and each key's
    residual."""

    def __init__(self, params):
        params = dict(params or {})
        ctype = params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError(f"unsupported gradient compression type "
                             f"{ctype!r} (reference supports '2bit')")
        self.type = ctype
        self.threshold = float(params.get("threshold", 0.5))
        if self.threshold <= 0:
            raise ValueError("threshold must be positive")
        self._residuals = {}

    def reset_residual(self, key) -> None:
        """Start ``key``'s error feedback afresh (`KVStore.init` of the
        key)."""
        self._residuals.pop(key, None)

    def quantize(self, key, grad: torch.Tensor) -> torch.Tensor:
        """Quantize with error feedback in float32, updating ``key``'s
        residual."""
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape or \
                res.device != grad.device:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        q, self._residuals[key] = quantize_2bit(grad.float(), res,
                                                self.threshold)
        return q

    def compress(self, key, grad: torch.Tensor) -> torch.Tensor:
        """Quantize with error feedback; the packed uint32 words."""
        return pack_2bit(self.quantize(key, grad), self.threshold)

    def decompress_sum(self, gathered_words: torch.Tensor, shape,
                       dtype) -> torch.Tensor:
        """The sum of each worker's unpacked contribution ([W, words])."""
        n = 1
        for d in shape:
            n *= int(d)
        out = sum(unpack_2bit(w, self.threshold, n) for w in gathered_words)
        return out.reshape(shape).to(dtype)
