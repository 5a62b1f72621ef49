"""Contrib operators (the counterpart of `mxnet_tpu/ops/contrib_ops.py`):
detection (MultiBox, box NMS and IoU, ROI pooling and align), resize and
adaptive pooling, the transformer helpers, fft, the spatial transformer
family and int8 quantization.

Reference `src/operator/contrib/` and `src/operator/quantization/`.  The
JAX package computes all of these in ``jnp``/``lax``, none in a Pallas
kernel, so they are PyTorch functions here.  Their outputs keep the JAX
package's fixed shapes: suppressed entries keep their slots with score
-1, and the sorts are stable (``jnp.argsort``'s order), so ties break the
same way.

The greedy NMS sweep is sequential in its rows, as the JAX package's
``fori_loop`` is.  Boxes are sorted by score, so the valid rows are a
prefix: the sweep visits that prefix only (at most ``topk`` rows) and
computes one IoU row a step, so an SSD head's 8732 anchors never build an
8732 x 8732 matrix.

The int8 products (`quantized_fully_connected`, and `quantized_conv` in
`quantized_ops.py`) give int32 accumulators bit-equal to the JAX
package's: on the card through ``torch._int_mm`` (int8 operands, int32
sums; its shape rules are met by zero padding), on the CPU through a
float64 product, exact while the sums stay below 2^53.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import Attrs, alias, canonical_attrs, register

__all__: list = []


def device_const(values, device, dtype=torch.float32):
    """A small constant built on ``device`` by fills, with no host-to-device
    copy, so a CUDA-graph capture can hold it."""
    arr = np.asarray(values, np.float64)
    out = torch.empty(arr.size, dtype=dtype, device=device)
    for i, v in enumerate(arr.reshape(-1)):
        out[i] = float(v)
    return out.reshape(arr.shape)


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------

def _box_area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)


def _corner(b, fmt):
    if fmt == "corner":
        return b
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _pair_iou(a, b, fmt="corner"):
    """IoU of [..., N, 4] against [..., M, 4] -> [..., N, M]."""
    a = _corner(a, fmt)
    b = _corner(b, fmt)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _box_area(a)[..., :, None]
    area_b = _box_area(b)[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


@register("_contrib_box_iou", num_inputs=2, input_names=["lhs", "rhs"])
def _box_iou(attrs, lhs, rhs):
    return _pair_iou(lhs, rhs, attrs.get_str("format", "corner"))


def _greedy_keep(boxes, valid, thresh, same=None):
    """The JAX package's greedy sweep over score-sorted rows, batched:
    row i survives when it is valid and no kept row j < i overlaps it by
    more than ``thresh`` (among rows ``same`` marks as comparable).
    ``valid`` is a prefix of each row set, so the sweep stops past the
    longest prefix."""
    keep = valid.clone()
    stop = int(valid.sum(dim=1).max()) if valid.numel() else 0
    if stop == 0:
        return keep
    b = boxes[:, :stop]
    for i in range(1, stop):
        iou = _pair_iou(b[:, i:i + 1], b[:, :i])[:, 0]          # [B, i]
        hit = (iou > thresh) & keep[:, :i]
        if same is not None:
            hit = hit & same[:, i, :i]
        keep[:, i] = keep[:, i] & ~hit.any(dim=1)
    return keep


@register("_contrib_box_nms", num_inputs=1, input_names=["data"])
def _box_nms(attrs, data):
    """Reference `box_nms` (`bounding_box-inl.h`): per-batch greedy NMS on
    [..., N, K]; suppressed rows keep their place with score -1."""
    thresh = attrs.get_float("overlap_thresh", 0.5)
    valid_thresh = attrs.get_float("valid_thresh", 0.0)
    topk = attrs.get_int("topk", -1)
    coord = attrs.get_int("coord_start", 2)
    sid = attrs.get_int("score_index", 1)
    idx_id = attrs.get_int("id_index", -1)
    force = attrs.get_bool("force_suppress", False)
    fmt = attrs.get_str("in_format", "corner")
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))            # [B, N, K]
    n = flat.shape[1]
    order = torch.argsort(-flat[:, :, sid], dim=1, stable=True)
    ds = torch.gather(flat, 1, order[:, :, None].expand_as(flat))
    s_sorted = ds[:, :, sid]
    valid = s_sorted > valid_thresh
    if topk > 0:
        valid = valid & (torch.arange(n, device=data.device) < topk)
    boxes = _corner(ds[:, :, coord:coord + 4], fmt)
    same = None
    if idx_id >= 0 and not force:
        ids = ds[:, :, idx_id]
        stop = int(valid.sum(dim=1).max()) if valid.numel() else 0
        same = ids[:, :stop, None] == ids[:, None, :stop]
    keep = _greedy_keep(boxes, valid, thresh, same)
    ds = ds.clone()
    ds[:, :, sid] = torch.where(keep, s_sorted,
                                torch.full_like(s_sorted, -1.0))
    inv = torch.argsort(order, dim=1, stable=True)
    out = torch.gather(ds, 1, inv[:, :, None].expand_as(ds))
    return out.reshape(shape)


alias("_contrib_box_nms", "box_nms")
alias("_contrib_box_iou", "box_iou")


# ---------------------------------------------------------------------------
# MultiBox (SSD): src/operator/contrib/multibox_*.cc
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", num_inputs=1, input_names=["data"])
def _multibox_prior(attrs, data):
    """Anchors for a feature map (H, W): (s1, r1..rn), (s2..sm, r1) per
    cell, centred at ((i + offset) * step)."""
    sizes = attrs.get_tuple("sizes", (1.0,))
    ratios = attrs.get_tuple("ratios", (1.0,))
    steps = attrs.get_tuple("steps", (-1.0, -1.0))
    offsets = attrs.get_tuple("offsets", (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, device=dev, dtype=torch.float32) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, device=dev, dtype=torch.float32) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    whs = device_const(np.asarray(whs, np.float32), dev)
    cxg, cyg = cxg[..., None], cyg[..., None]
    bw = whs[None, None, :, 0] / 2
    bh = whs[None, None, :, 1] / 2
    anchors = torch.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh], -1)
    return anchors.reshape(1, -1, 4).to(data.dtype)


@register("_contrib_MultiBoxTarget", num_inputs=3,
          input_names=["anchor", "label", "cls_pred"], num_outputs=3)
def _multibox_target(attrs, anchor, label, cls_pred):
    """Anchor-to-ground-truth matching and target encoding (reference
    `multibox_target.cc`): (box_target [B, A*4], box_mask [B, A*4],
    cls_target [B, A]), with the hard-negative mining of
    ``negative_mining_ratio``."""
    iou_thresh = attrs.get_float("overlap_threshold", 0.5)
    variances = attrs.get_tuple("variances", (0.1, 0.1, 0.2, 0.2))
    neg_thresh = attrs.get_float("negative_mining_thresh", 0.5)
    neg_ratio = attrs.get_float("negative_mining_ratio", -1.0)
    anchors = anchor.reshape(-1, 4)
    a_cx = (anchors[:, 0] + anchors[:, 2]) / 2
    a_cy = (anchors[:, 1] + anchors[:, 3]) / 2
    a_w = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-8)
    a_h = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-8)
    n_anchor = anchors.shape[0]
    gt_valid = label[:, :, 0] >= 0                            # [B, M]
    gt_boxes = label[:, :, 1:5]
    iou = _pair_iou(anchors[None], gt_boxes)                  # [B, A, M]
    iou = torch.where(gt_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)                        # [B, A]
    best_gt = torch.argmax(iou, dim=2)
    pos = best_iou >= iou_thresh
    best_anchor = torch.argmax(iou, dim=1)                    # [B, M]
    owned = torch.zeros(label.shape[0], n_anchor, dtype=torch.int32,
                        device=anchor.device).scatter_reduce(
        1, best_anchor, gt_valid.to(torch.int32), reduce="amax")
    pos = pos | owned.bool()
    g = torch.gather(gt_boxes, 1, best_gt[:, :, None].expand(-1, -1, 4))
    g_cx = (g[..., 0] + g[..., 2]) / 2
    g_cy = (g[..., 1] + g[..., 3]) / 2
    g_w = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    g_h = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    tx = (g_cx - a_cx) / a_w / variances[0]
    ty = (g_cy - a_cy) / a_h / variances[1]
    tw = torch.log(g_w / a_w) / variances[2]
    th = torch.log(g_h / a_h) / variances[3]
    box_t = torch.stack([tx, ty, tw, th], dim=2)              # [B, A, 4]
    box_t = torch.where(pos[..., None], box_t, torch.zeros_like(box_t))
    mask = pos[..., None].to(box_t.dtype).expand(-1, -1, 4)
    gt_cls = torch.gather(label[:, :, 0], 1, best_gt) + 1
    if neg_ratio > 0:
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]        # [B, A]
        cand = (~pos) & (best_iou < neg_thresh)
        num_pos = pos.sum(dim=1).to(torch.float32)
        num_neg = torch.minimum(torch.floor(num_pos * neg_ratio),
                                cand.sum(dim=1).to(torch.float32))
        score = torch.where(cand, bg_prob,
                            torch.full_like(bg_prob, float("inf")))
        rank = torch.argsort(torch.argsort(score, dim=1, stable=True),
                             dim=1, stable=True)
        neg = cand & (rank < num_neg[:, None])
        cls_t = torch.where(pos, gt_cls, torch.where(
            neg, torch.zeros_like(gt_cls), torch.full_like(gt_cls, -1.0)))
    else:
        cls_t = torch.where(pos, gt_cls, torch.zeros_like(gt_cls))
    b = label.shape[0]
    return (box_t.reshape(b, -1).to(anchor.dtype),
            mask.reshape(b, -1).to(anchor.dtype), cls_t.to(anchor.dtype))


@register("_contrib_MultiBoxDetection", num_inputs=3,
          input_names=["cls_prob", "loc_pred", "anchor"])
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode and class-aware NMS (reference `multibox_detection.cc`):
    [B, A, 6] rows (cls_id, score, x1, y1, x2, y2), cls_id -1 where
    suppressed or below ``threshold``."""
    nms_thresh = attrs.get_float("nms_threshold", 0.5)
    score_thresh = attrs.get_float("threshold", 0.01)
    variances = attrs.get_tuple("variances", (0.1, 0.1, 0.2, 0.2))
    nms_topk = attrs.get_int("nms_topk", -1)
    anchors = anchor.reshape(-1, 4)
    a_cx = (anchors[:, 0] + anchors[:, 2]) / 2
    a_cy = (anchors[:, 1] + anchors[:, 3]) / 2
    a_w = anchors[:, 2] - anchors[:, 0]
    a_h = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    cx = loc[..., 0] * variances[0] * a_w + a_cx
    cy = loc[..., 1] * variances[1] * a_h + a_cy
    w = torch.exp(loc[..., 2] * variances[2]) * a_w
    h = torch.exp(loc[..., 3] * variances[3]) * a_h
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 2)
    best_score, _ = cls_prob[:, 1:].max(dim=1)                # [B, A]
    best_cls = torch.argmax(cls_prob[:, 1:], dim=1)
    keep = best_score > score_thresh
    cls_id = torch.where(keep, best_cls.to(cls_prob.dtype),
                         torch.full_like(best_score, -1.0))
    rows = torch.cat([cls_id[..., None], best_score[..., None], boxes], 2)
    nms_attrs = Attrs(canonical_attrs(dict(
        overlap_thresh=nms_thresh, valid_thresh=0.0, topk=nms_topk,
        coord_start=2, score_index=1, id_index=0)))
    out = _box_nms(nms_attrs, rows)
    cls = torch.where(out[..., 1] > 0, out[..., 0],
                      torch.full_like(out[..., 0], -1.0))
    out = out.clone()
    out[..., 0] = cls
    return out


alias("_contrib_MultiBoxPrior", "MultiBoxPrior")
alias("_contrib_MultiBoxTarget", "MultiBoxTarget")
alias("_contrib_MultiBoxDetection", "MultiBoxDetection")


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

def _roi_corners(rois, scale):
    return (rois[:, 0].to(torch.int64), rois[:, 1] * scale,
            rois[:, 2] * scale, rois[:, 3] * scale, rois[:, 4] * scale)


@register("ROIPooling", num_inputs=2, input_names=["data", "rois"])
def _roi_pooling(attrs, data, rois):
    """Max-pool each ROI to a fixed grid (reference `roi_pooling.cc`) over
    the JAX package's sampled lattice: each bin max-pools S x S samples
    (S = 4)."""
    ph, pw = attrs.get_tuple("pooled_size")
    scale = attrs.get_float("spatial_scale", 1.0)
    S = 4
    _, C, H, W = data.shape
    bidx, x1, y1, x2, y2 = _roi_corners(rois, scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    ar_h = torch.arange(ph * S, device=data.device, dtype=rois.dtype)
    ar_w = torch.arange(pw * S, device=data.device, dtype=rois.dtype)
    ys = y1[:, None] + (ar_h + 0.5) * rh[:, None] / (ph * S)
    xs = x1[:, None] + (ar_w + 0.5) * rw[:, None] / (pw * S)
    yi = torch.clamp(ys.to(torch.int64), 0, H - 1)            # [R, ph*S]
    xi = torch.clamp(xs.to(torch.int64), 0, W - 1)
    img = data[bidx]                                          # [R, C, H, W]
    rows = torch.gather(img, 2, yi[:, None, :, None].expand(
        -1, C, -1, W))
    patch = torch.gather(rows, 3, xi[:, None, None, :].expand(
        -1, C, ph * S, -1))
    patch = patch.reshape(-1, C, ph, S, pw, S)
    return patch.amax(dim=(3, 5))


def _bilinear_taps(img, y, x):
    """``img`` [R, C, H, W] sampled at [R, P] float coords (clamped taps,
    the JAX package's ROIAlign sampling) -> [R, C, P]."""
    _, C, H, W = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    flat = img.reshape(img.shape[0], C, H * W)

    def tap(yi, xi):
        idx = (yi * W + xi)[:, None, :].expand(-1, C, -1)
        return torch.gather(flat, 2, idx)

    return (tap(y0i, x0i) * (1 - wy) * (1 - wx) +
            tap(y0i, x1i) * (1 - wy) * wx +
            tap(y1i, x0i) * wy * (1 - wx) + tap(y1i, x1i) * wy * wx)


@register("_contrib_ROIAlign", num_inputs=2, input_names=["data", "rois"])
def _roi_align(attrs, data, rois):
    """Bilinear ROI align (reference `contrib/roi_align.cc`)."""
    ph, pw = attrs.get_tuple("pooled_size")
    scale = attrs.get_float("spatial_scale", 1.0)
    S = max(1, attrs.get_int("sample_ratio", 2))
    _, C, H, W = data.shape
    bidx, x1, y1, x2, y2 = _roi_corners(rois, scale)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    ar_h = torch.arange(ph * S, device=data.device, dtype=rois.dtype)
    ar_w = torch.arange(pw * S, device=data.device, dtype=rois.dtype)
    ys = y1[:, None] + (ar_h + 0.5) * rh[:, None] / (ph * S)
    xs = x1[:, None] + (ar_w + 0.5) * rw[:, None] / (pw * S)
    yg = ys[:, :, None].expand(-1, -1, pw * S).reshape(ys.shape[0], -1)
    xg = xs[:, None, :].expand(-1, ph * S, -1).reshape(xs.shape[0], -1)
    vals = _bilinear_taps(data[bidx], yg, xg)
    return vals.reshape(-1, C, ph, S, pw, S).mean(dim=(3, 5))


alias("_contrib_ROIAlign", "ROIAlign")


# ---------------------------------------------------------------------------
# resize and adaptive pooling
# ---------------------------------------------------------------------------

def _linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` in float32, by its formula:
    start * (1 - t) + stop * t with t = i / (num - 1), the end point
    exact."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        float(num - 1)
    out = float(start) * (1 - t) + float(stop) * t
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


@register("_contrib_BilinearResize2D", num_inputs=1, input_names=["data"])
def _bilinear_resize(attrs, data):
    """Reference `bilinear_resize.cc:67-75`: align-corners sampling, the
    source coordinate dst * (in - 1) / (out - 1); a one-pixel output
    samples 0."""
    h = attrs.get_int("height")
    w = attrs.get_int("width")
    _, _, H, W = data.shape
    ys = _linspace(0.0, H - 1, h, data.device) if h > 1 else \
        torch.zeros(1, device=data.device)
    xs = _linspace(0.0, W - 1, w, data.device) if w > 1 else \
        torch.zeros(1, device=data.device)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0).to(data.dtype)[:, None]
    wx = (xs - x0).to(data.dtype)[None, :]
    r0 = data.index_select(2, y0)
    r1 = data.index_select(2, y1)
    out = ((1 - wy) * ((1 - wx) * r0.index_select(3, x0)
                       + wx * r0.index_select(3, x1))
           + wy * ((1 - wx) * r1.index_select(3, x0)
                   + wx * r1.index_select(3, x1)))
    return out.to(data.dtype)


def _linear_weights(n_in, n_out, device, dtype):
    """`jax.image.resize`'s 'linear' weights (a triangle kernel widened by
    the downscale factor, antialiased, normalized): [n_in, n_out]."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=dtype,
                                          device=device)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1 - x, min=0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@register("_contrib_AdaptiveAvgPooling2D", num_inputs=1, input_names=["data"])
def _adaptive_avg_pool(attrs, data):
    osize = attrs.get_tuple("output_size", (1, 1))
    if len(osize) == 1:
        osize = (osize[0], osize[0])
    B, C, H, W = data.shape
    oh, ow = int(osize[0]), int(osize[1])
    if H % oh == 0 and W % ow == 0:
        return data.reshape(B, C, oh, H // oh, ow, W // ow).mean(dim=(3, 5))
    wt = torch.float64 if data.dtype == torch.float64 else torch.float32
    wy = _linear_weights(H, oh, data.device, wt)
    wx = _linear_weights(W, ow, data.device, wt)
    out = torch.einsum("bchw,hi,wj->bcij", data.to(wt), wy, wx)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# transformer helpers and the rest
# ---------------------------------------------------------------------------

@register("_contrib_div_sqrt_dim", num_inputs=1, input_names=["data"])
def _div_sqrt_dim(attrs, data):
    """Reference `contrib/transformer.cc:34`: x / sqrt(d_last)."""
    return data / torch.full((), float(data.shape[-1]), dtype=data.dtype,
                             device=data.device).sqrt()


class _GradMultiplier(torch.autograd.Function):
    """The identity forward, the gradient scaled by ``scalar``."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradient_multiplier", num_inputs=1, input_names=["data"])
def _gradmult(attrs, data):
    return _GradMultiplier.apply(data, attrs.get_float("scalar", 1.0))


@register("_contrib_quadratic", num_inputs=1, input_names=["data"])
def _quadratic(attrs, data):
    a = attrs.get_float("a", 0.0)
    b = attrs.get_float("b", 0.0)
    c = attrs.get_float("c", 0.0)
    return a * data * data + b * data + c


@register("_contrib_index_copy", num_inputs=3,
          input_names=["old_tensor", "index_vector", "new_tensor"])
def _index_copy(attrs, old, index, new):
    return torch.index_put(old, (index.to(torch.int64),), new.to(old.dtype))


@register("_contrib_fft", num_inputs=1, input_names=["data"])
def _fft(attrs, data):
    """Reference `contrib/fft.cc` (cuFFT): real -> interleaved complex."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(tuple(data.shape[:-1]) +
                         (2 * data.shape[-1],)).to(torch.float32)


@register("_contrib_ifft", num_inputs=1, input_names=["data"])
def _ifft(attrs, data):
    n = data.shape[-1] // 2
    c = data.reshape(tuple(data.shape[:-1]) + (n, 2)).to(torch.float32)
    comp = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32)


def _sample(img, yy, xx):
    """``img`` [B, C, H, W] at [B, h, w] pixel coords, zero outside the
    image (reference `bilinear_sampler.cc`)."""
    B, C, H, W = img.shape
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = (yy - y0)[:, None]
    wx = (xx - x0)[:, None]
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    mask = ((yy >= 0) & (yy <= H - 1) & (xx >= 0) &
            (xx <= W - 1)).to(img.dtype)[:, None]
    flat = img.reshape(B, C, H * W)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(B, 1, -1).expand(-1, C, -1)
        return torch.gather(flat, 2, idx).reshape(B, C, *yy.shape[1:])

    v = (tap(y0i, x0i) * (1 - wy) * (1 - wx) +
         tap(y0i, x1i) * (1 - wy) * wx +
         tap(y1i, x0i) * wy * (1 - wx) + tap(y1i, x1i) * wy * wx)
    return v * mask


@register("BilinearSampler", num_inputs=2, input_names=["data", "grid"])
def _bilinear_sampler(attrs, data, grid):
    """Sample ``data`` at normalized grid coords in [-1, 1]; grid
    [B, 2, H', W'] holds (x, y)."""
    _, _, H, W = data.shape
    gx = (grid[:, 0] + 1) * (W - 1) / 2
    gy = (grid[:, 1] + 1) * (H - 1) / 2
    return _sample(data, gy, gx)


@register("GridGenerator", num_inputs=1, input_names=["data"])
def _grid_generator(attrs, data):
    """Reference `grid_generator.cc`: affine theta [B, 6] -> a sampling
    grid [B, 2, H, W]; ``warp`` adds a flow to the pixel grid and
    normalizes."""
    if attrs.get_str("transform_type", "affine") == "warp":
        _, _, H, W = data.shape
        gx = torch.arange(W, dtype=data.dtype,
                          device=data.device)[None, :].expand(H, W)
        gy = torch.arange(H, dtype=data.dtype,
                          device=data.device)[:, None].expand(H, W)
        grid_dst = torch.stack([gx, gy], 0)
        denom = device_const([(W - 1) / 2.0, (H - 1) / 2.0], data.device,
                             data.dtype).reshape(1, 2, 1, 1)
        return (data + grid_dst[None]) / denom - 1.0
    th, tw = attrs.get_tuple("target_shape")
    B = data.shape[0]
    ys = _linspace(-1, 1, th, data.device)
    xs = _linspace(-1, 1, tw, data.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([xg, yg, torch.ones_like(xg)], 0).reshape(3, -1)
    theta = data.reshape(B, 2, 3)
    out = torch.einsum("bij,jk->bik", theta, base.to(theta.dtype))
    return out.reshape(B, 2, th, tw)


@register("SpatialTransformer", num_inputs=2, input_names=["data", "loc"])
def _spatial_transformer(attrs, data, loc):
    """Reference `spatial_transformer.cc`: an affine grid, then bilinear
    sampling."""
    th, tw = attrs.get_tuple("target_shape")
    grid = _grid_generator(Attrs(canonical_attrs(dict(
        transform_type="affine", target_shape=(th, tw)))), loc)
    return _bilinear_sampler(Attrs(()), data, grid)


# ---------------------------------------------------------------------------
# int8 quantization (reference src/operator/quantization/)
# ---------------------------------------------------------------------------

def _range(lo, hi):
    return torch.maximum(lo.abs(), hi.abs())


def _to_int8(x):
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


@register("_contrib_quantize", num_inputs=3,
          input_names=["data", "min_range", "max_range"], num_outputs=3)
def _quantize(attrs, data, min_range, max_range):
    """Reference `quantize-inl.h`: float -> int8 over the given range."""
    real_range = _range(min_range, max_range)
    scale = 127.0 / torch.clamp(real_range, min=1e-12)
    return _to_int8(data * scale), -real_range, real_range


@register("_contrib_quantize_v2", num_inputs=1, input_names=["data"],
          num_outputs=3)
def _quantize_v2(attrs, data):
    """Reference `quantize_v2-inl.h`: the range from the data, or the
    calibrated one."""
    mn = attrs.get_float("min_calib_range", None)
    mx = attrs.get_float("max_calib_range", None)
    if mn is None or mx is None:
        real_range = data.abs().max().to(torch.float32)
    else:
        real_range = torch.full((), max(abs(mn), abs(mx)),
                                dtype=torch.float32, device=data.device)
    scale = 127.0 / torch.clamp(real_range, min=1e-12)
    rr = real_range.reshape(())
    return _to_int8(data * scale), -rr, rr


@register("_contrib_dequantize", num_inputs=3,
          input_names=["data", "min_range", "max_range"])
def _dequantize(attrs, data, min_range, max_range):
    return data.to(torch.float32) * _range(min_range, max_range) / 127.0


@register("_contrib_requantize", num_inputs=3,
          input_names=["data", "min_range", "max_range"], num_outputs=3)
def _requantize(attrs, data, min_range, max_range):
    """int32 accumulators -> int8 (reference `requantize-inl.h`), over the
    calibrated range when the attrs hold one."""
    real_range = _range(min_range, max_range)
    f = data.to(torch.float32) * real_range / (127.0 * 127.0 * 127.0)
    mn = attrs.get_float("min_calib_range", None)
    mx = attrs.get_float("max_calib_range", None)
    if mn is not None and mx is not None:
        new_range = torch.full((), max(abs(mn), abs(mx)),
                               dtype=torch.float32, device=data.device)
    else:
        new_range = f.abs().max()
    scale = 127.0 / torch.clamp(new_range, min=1e-12)
    return _to_int8(f * scale), -new_range, new_range


def int8_gemm(a, b):
    """``a`` [M, K] times ``b`` [K, N], int8 (or int-valued) operands, as
    exact int32 sums.  On the card ``torch._int_mm``, with M padded past
    16 rows and K, N to multiples of 8 by zeros (which add nothing); on
    the CPU a float64 product, exact for sums below 2^53."""
    M, K = a.shape
    N = b.shape[1]
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    a8 = a.to(torch.int8)
    b8 = b.to(torch.int8)
    pm, pk, pn = max(17, M) - M, -K % 8, -N % 8
    if pm or pk:
        a8 = torch.nn.functional.pad(a8, (0, pk, 0, pm))
    if pk or pn:
        b8 = torch.nn.functional.pad(b8, (0, pn, 0, pk))
    return torch._int_mm(a8, b8)[:M, :N]


def _bias_counts(bias, min_bias, max_bias, d_range, w_range):
    """An int8 bias in int32-accumulator units, in the JAX package's order
    and dtype: one accumulator count is d_range * w_range / 127^2, one
    bias count b_range / 127."""
    b_range = _range(min_bias, max_bias)
    b_scale = 127.0 * b_range / torch.clamp(d_range * w_range, min=1e-12)
    return torch.round(bias.to(torch.float32) * b_scale).to(torch.int32)


def split_quantized_inputs(ins, what):
    """(data, weight, bias, min_data, max_data, min_weight, max_weight,
    min_bias, max_bias) from the reference's 9 inputs, or 6 without a
    bias."""
    if len(ins) == 9:
        return ins
    if len(ins) == 6:
        data, weight, min_data, max_data, min_weight, max_weight = ins
        return (data, weight, None, min_data, max_data, min_weight,
                max_weight, None, None)
    raise ValueError(f"{what} expects 6 or 9 inputs")


@register("_contrib_quantized_fully_connected", num_inputs=None,
          num_outputs=3)
def _quantized_fc(attrs, *ins):
    """int8 x int8 -> int32 (reference `quantized_fully_connected.cc`); 9
    inputs with a bias, 6 without."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = split_quantized_inputs(
        ins, "quantized_fully_connected")
    lead = tuple(data.shape[:-1])
    out = int8_gemm(data.reshape(-1, data.shape[-1]), weight.t())
    out = out.reshape(lead + (weight.shape[0],))
    d_range = _range(min_data, max_data)
    w_range = _range(min_weight, max_weight)
    out_range = d_range * w_range * 127.0
    if bias is not None and min_bias is not None:
        out = out + _bias_counts(bias, min_bias, max_bias, d_range, w_range)
    return out, -out_range, out_range

