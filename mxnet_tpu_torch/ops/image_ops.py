"""Image ops (the counterpart of `mxnet_tpu/ops/image_ops.py`; reference
`src/operator/image/`): the per-sample augmenters that the Gluon vision
transforms call, on HWC (or NHWC) images.

``_image_resize`` is the JAX package's `jax.image.resize(method="linear")`
written out: per resized axis, a weight matrix of the triangle kernel,
widened by the scale when shrinking (antialiased), normalized per output
sample and applied as a product, H before W.  Integer images are rounded
(half to even) and clipped to [0, 255] after each adjustment, as in the
reference.

`batch_normalize_mirror` (registered as ``_image_normalize_mirror_batch``)
is the data plane's device step: a uint8 NHWC batch, staged to the card
as it was decoded, is cast, its flagged rows mirrored, normalized and
transposed to NCHW in a few elementwise launches.  The JAX package jits
the same arithmetic in XLA, outside any Pallas kernel, so plain tensor ops
are its counterpart here.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import alias, register

_R, _G, _B = 0.299, 0.587, 0.114  # ITU-R BT.601 luma


@register("_image_to_tensor", num_inputs=1, input_names=["data"])
def _to_tensor(attrs, x):
    """HWC [0, 255] to CHW float32 [0, 1]; NHWC to NCHW."""
    if x.dim() not in (3, 4):
        raise MXNetError(f"to_tensor expects a 3D (HWC) or 4D (NHWC) "
                         f"input, got {x.dim()}D")
    x = x.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize", num_inputs=1, input_names=["data"])
def _normalize(attrs, x):
    """``(x - mean) / std`` per channel of a CHW or NCHW image."""
    if x.dim() not in (3, 4):
        raise MXNetError(f"normalize expects a 3D (CHW) or 4D (NCHW) "
                         f"input, got {x.dim()}D")
    c = x.shape[0] if x.dim() == 3 else x.shape[1]
    if c not in (1, 3):
        raise MXNetError(f"normalize expects 1 or 3 channels, got {c}")
    mean = torch.tensor(attrs.get_tuple("mean", (0.0,)), dtype=x.dtype,
                        device=x.device)
    std = torch.tensor(attrs.get_tuple("std", (1.0,)), dtype=x.dtype,
                       device=x.device)
    shape = (-1, 1, 1) if x.dim() == 3 else (1, -1, 1, 1)
    return (x - mean.reshape(shape)) / std.reshape(shape)


def batch_normalize_mirror(x: torch.Tensor, flip: torch.Tensor,
                           mean: torch.Tensor, std: torch.Tensor,
                           layout: str = "NCHW") -> torch.Tensor:
    """``(x - mean) / std`` in float32 of a uint8 NHWC batch whose rows
    with ``flip`` set are mirrored along the width; ``mean`` and ``std``
    are (C,) or (1,); NCHW (contiguous) or NHWC out."""
    xf = x.to(torch.float32)
    xf = torch.where(flip.reshape(-1, 1, 1, 1), xf.flip(2), xf)
    xf = (xf - mean) / std
    if layout == "NCHW":
        xf = xf.permute(0, 3, 1, 2).contiguous()
    return xf


@register("_image_normalize_mirror_batch", num_inputs=2,
          input_names=["data", "flip"])
def _normalize_mirror_batch(attrs, x, flip):
    """`batch_normalize_mirror` with ``mean``, ``std`` and ``layout``
    as attrs."""
    if x.dim() != 4:
        raise MXNetError(f"normalize_mirror_batch expects a 4D NHWC input, "
                         f"got {x.dim()}D")
    layout = attrs.get_str("layout", "NCHW")
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError(f"unsupported layout {layout!r}")
    kw = dict(dtype=torch.float32, device=x.device)
    mean = torch.tensor(attrs.get_tuple("mean", (0.0,)), **kw)
    std = torch.tensor(attrs.get_tuple("std", (1.0,)), **kw)
    return batch_normalize_mirror(x, flip.to(torch.bool), mean, std, layout)


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` linear-resize weights (`jax.image`'s
    `compute_weight_mat` with the triangle kernel, antialiased, no
    translation)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv \
        - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32,
                                           device=device)[:, None]).abs()
    w = torch.clamp_min(1.0 - dist / kernel_scale, 0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register("_image_resize", num_inputs=1, input_names=["data"])
def _resize(attrs, x):
    """Bilinear resize to ``size`` = (w, h) (one number: square), or, with
    ``keep_ratio``, the shorter edge to min(w, h)."""
    size = attrs.get_tuple("size")
    if len(size) == 1:
        size = (size[0], size[0])
    w, h = int(size[0]), int(size[1])
    hax = 0 if x.dim() == 3 else 1
    ih, iw = x.shape[hax], x.shape[hax + 1]
    if attrs.get_bool("keep_ratio", False):
        short = min(w, h)
        if ih < iw:
            h, w = short, max(1, round(iw * short / ih))
        else:
            h, w = max(1, round(ih * short / iw)), short
    out = x.to(torch.float32)
    for ax, (n_in, n_out) in ((hax, (ih, h)), (hax + 1, (iw, w))):
        if n_in == n_out:
            continue
        wm = _weight_mat(n_in, n_out, x.device)
        out = torch.tensordot(out.movedim(ax, -1), wm, dims=1).movedim(-1,
                                                                        ax)
    if not x.is_floating_point():
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(x.dtype)


@register("_image_flip_left_right", num_inputs=1, input_names=["data"])
def _flip_lr(attrs, x):
    return torch.flip(x, dims=[-2])


@register("_image_flip_top_bottom", num_inputs=1, input_names=["data"])
def _flip_tb(attrs, x):
    return torch.flip(x, dims=[-3])


def _coin(generator, x) -> bool:
    """A fair coin from ``generator`` (on the image's device)."""
    return bool(torch.rand((), generator=generator, device=x.device) < 0.5)


@register("_image_random_flip_left_right", num_inputs=1,
          input_names=["data"], needs_rng=True)
def _random_flip_lr(attrs, generator, x):
    return torch.flip(x, dims=[-2]) if _coin(generator, x) else x


@register("_image_random_flip_top_bottom", num_inputs=1,
          input_names=["data"], needs_rng=True)
def _random_flip_tb(attrs, generator, x):
    return torch.flip(x, dims=[-3]) if _coin(generator, x) else x


def _finish(out, ref):
    if not ref.is_floating_point():
        return torch.clamp(torch.round(out), 0, 255).to(ref.dtype)
    return out.to(ref.dtype)


def _gray(xf):
    return xf[..., 0] * _R + xf[..., 1] * _G + xf[..., 2] * _B


@register("_image_adjust_lighting_scale", num_inputs=1, input_names=["data"])
def _adjust_brightness(attrs, x):
    return _finish(x.to(torch.float32) * attrs.get_float("alpha", 1.0), x)


alias("_image_adjust_lighting_scale", "_image_random_brightness_scale")


@register("_image_adjust_contrast", num_inputs=1, input_names=["data"])
def _adjust_contrast(attrs, x):
    """Blend with the image's mean gray level."""
    alpha = attrs.get_float("alpha", 1.0)
    xf = x.to(torch.float32)
    return _finish(xf * alpha + _gray(xf).mean() * (1.0 - alpha), x)


@register("_image_adjust_saturation", num_inputs=1, input_names=["data"])
def _adjust_saturation(attrs, x):
    """Blend with each pixel's gray level."""
    alpha = attrs.get_float("alpha", 1.0)
    xf = x.to(torch.float32)
    return _finish(xf * alpha + _gray(xf)[..., None] * (1.0 - alpha), x)


@register("_image_adjust_hue", num_inputs=1, input_names=["data"])
def _adjust_hue(attrs, x):
    """Hue shift by ``alpha`` half-turns: a rotation in YIQ space."""
    alpha = attrs.get_float("alpha", 0.0)
    u, w = math.cos(alpha * math.pi), math.sin(alpha * math.pi)
    kw = dict(dtype=torch.float32, device=x.device)
    t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], **kw)
    t_rgb = torch.tensor([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], **kw)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], **kw)
    m = t_rgb @ rot @ t_yiq
    return _finish(x.to(torch.float32) @ m.T, x)


@register("_image_crop", num_inputs=1, input_names=["data"])
def _crop(attrs, x):
    """The ``width`` x ``height`` window at (``x``, ``y``)."""
    x0, y0 = attrs.get_int("x"), attrs.get_int("y")
    w, h = attrs.get_int("width"), attrs.get_int("height")
    if x.dim() == 3:
        return x[y0:y0 + h, x0:x0 + w, :]
    return x[:, y0:y0 + h, x0:x0 + w, :]
