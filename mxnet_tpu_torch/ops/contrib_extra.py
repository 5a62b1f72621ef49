"""The contrib op long tail (the counterpart of
`mxnet_tpu/ops/contrib_extra.py`): deformable convolution, PSROI pooling,
RPN proposals, bipartite matching, count_sketch, the DGL graph ops and
sync BatchNorm.

Reference `src/operator/contrib/` (`deformable_convolution.cc`,
`psroi_pooling.cc`, `deformable_psroi_pooling.cc`, `proposal.cc`,
`multi_proposal.cc`, `bounding_box.cc:155`, `count_sketch.cc`,
`dgl_graph.cc`, `sync_batch_norm.cc`).  The JAX package writes them in
``jnp``/``lax`` with static shapes (bilinear gathers, masked reductions,
padded samples); here they are PyTorch functions with the same shapes,
padding and stable sort orders.

The DGL samplers draw from the op's ``torch.Generator``, so they agree
with the JAX package's (which draws from its keys) in structure and
distribution, not sample for sample.

``SyncBatchNorm`` keeps the JAX package's semantics: inside a
`parallel.shard_map` (or `mesh_scope`) whose mesh has the attr
``axis_name``, it takes the mean over that axis of each rank's batch mean
and of each rank's batch variance (the mean of the variances, not the
whole batch's variance); elsewhere it is BatchNorm.
"""
from __future__ import annotations

import numpy as np
import torch

from .contrib_ops import _pair_iou, device_const
from .registry import alias, register


# ---------------------------------------------------------------------------
# bilinear sampling (deformable convolution, deformable PSROI pooling)
# ---------------------------------------------------------------------------

def _bilinear_gather(img, ys, xs):
    """``img`` [C, H, W] sampled at float coords ``ys``/``xs`` (any shape),
    zero outside -> [C, *ys.shape]."""
    C, H, W = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    flat = img.reshape(C, H * W)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)

    def tap(yi, xi, w):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        vals = flat[:, idx.reshape(-1)].reshape((C,) + tuple(idx.shape))
        return vals * (w * valid.to(img.dtype))

    out = tap(y0i, x0i, (1 - wy1) * (1 - wx1))
    out = out + tap(y0i, x0i + 1, (1 - wy1) * wx1)
    out = out + tap(y0i + 1, x0i, wy1 * (1 - wx1))
    out = out + tap(y0i + 1, x0i + 1, wy1 * wx1)
    return out


# ---------------------------------------------------------------------------
# DeformableConvolution (`contrib/deformable_convolution.cc`)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution", num_inputs=None,
          input_names=["data", "offset", "weight", "bias"])
def _deformable_convolution(attrs, data, offset, weight, bias=None):
    """Deformable convolution v1: learned offsets shift each kernel tap,
    sampled bilinearly; deformable im2col is a batched gather and the
    contraction one einsum."""
    kh, kw = attrs.get_tuple("kernel")
    sh, sw = attrs.get_tuple("stride", (1, 1))
    dh, dw = attrs.get_tuple("dilate", (1, 1))
    ph, pw = attrs.get_tuple("pad", (0, 0))
    groups = attrs.get_int("num_group", 1)
    dg = attrs.get_int("num_deformable_group", 1)
    N, C, H, W = data.shape
    CO = weight.shape[0]
    K = kh * kw
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = data.device
    oy = torch.arange(OH, device=dev) * sh - ph
    ox = torch.arange(OW, device=dev) * sw - pw
    ki, kj = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    base_y = (oy[None, :, None] + (ki.reshape(-1) * dh)[:, None, None]
              ).expand(K, OH, OW).to(data.dtype)
    base_x = (ox[None, None, :] + (kj.reshape(-1) * dw)[:, None, None]
              ).expand(K, OH, OW).to(data.dtype)
    off = offset.reshape(N, dg, K, 2, OH, OW)
    ys = base_y[None, None] + off[:, :, :, 0]          # (N, dg, K, OH, OW)
    xs = base_x[None, None] + off[:, :, :, 1]
    cpg = C // dg
    cols = []
    for n in range(N):
        grouped = data[n].reshape(dg, cpg, H, W)
        per = [_bilinear_gather(grouped[g], ys[n, g], xs[n, g])
               for g in range(dg)]                      # (cpg, K, OH, OW)
        cols.append(torch.stack(per).reshape(C, K, OH, OW))
    cols = torch.stack(cols).reshape(N, groups, C // groups, K, OH, OW)
    wmat = weight.reshape(groups, CO // groups, C // groups, K)
    out = torch.einsum("ngckhw,gock->ngohw", cols, wmat)
    out = out.reshape(N, CO, OH, OW)
    if bias is not None and not attrs.get_bool("no_bias", False):
        out = out + bias.reshape(1, CO, 1, 1)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# PSROIPooling and its deformable variant
# ---------------------------------------------------------------------------

def _ps_channels(out_dim, G, gh, gw, device):
    return (torch.arange(out_dim, device=device) * G + gh) * G + gw


@register("_contrib_PSROIPooling", num_inputs=2, input_names=["data", "rois"])
def _psroi_pooling(attrs, data, rois):
    """Position-sensitive ROI pooling: bin (ph, pw) of a roi averages
    channel (c * G + gh) * G + gw over the bin's rectangle, a masked mean
    over the whole map."""
    scale = attrs.get_float("spatial_scale")
    out_dim = attrs.get_int("output_dim")
    P = attrs.get_int("pooled_size")
    G = attrs.get_int("group_size", P)
    _, C, H, W = data.shape
    r = rois.to(torch.float32)
    dev = data.device
    ar_h = torch.arange(H, dtype=torch.float32, device=dev)
    ar_w = torch.arange(W, dtype=torch.float32, device=dev)
    bidx = r[:, 0].to(torch.int64)
    x1 = torch.round(r[:, 1]) * scale
    y1 = torch.round(r[:, 2]) * scale
    x2 = torch.round(r[:, 3] + 1.0) * scale
    y2 = torch.round(r[:, 4] + 1.0) * scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = rh / P, rw / P
    img = data[bidx]                                          # (R, C, H, W)
    outs = []
    for ph in range(P):
        for pw in range(P):
            hs = torch.floor(y1 + ph * bin_h)
            he = torch.ceil(y1 + (ph + 1) * bin_h)
            ws = torch.floor(x1 + pw * bin_w)
            we = torch.ceil(x1 + (pw + 1) * bin_w)
            mh = ((ar_h >= hs[:, None]) & (ar_h < he[:, None])).float()
            mw = ((ar_w >= ws[:, None]) & (ar_w < we[:, None])).float()
            mask = mh[:, :, None] * mw[:, None, :]            # (R, H, W)
            cnt = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
            gh = min(ph * G // P, G - 1)
            gw = min(pw * G // P, G - 1)
            chans = img[:, _ps_channels(out_dim, G, gh, gw, dev)]
            outs.append((chans * mask[:, None]).sum(dim=(2, 3)) /
                        cnt[:, None])
    out = torch.stack(outs, dim=2)                            # (R, out, P*P)
    return out.reshape(-1, out_dim, P, P).to(data.dtype)


@register("_contrib_DeformablePSROIPooling", num_inputs=None,
          input_names=["data", "rois", "trans"])
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """Deformable PSROI pooling (`contrib/deformable_psroi_pooling.cc`):
    bins shifted by learned normalized offsets, sample_per_part^2
    bilinear samples a bin."""
    scale = attrs.get_float("spatial_scale")
    out_dim = attrs.get_int("output_dim")
    P = attrs.get_int("pooled_size")
    G = attrs.get_int("group_size", P)
    part = attrs.get_int("part_size", P) or P
    spp = attrs.get_int("sample_per_part", 1)
    trans_std = attrs.get_float("trans_std", 0.0)
    no_trans = attrs.get_bool("no_trans", False) or trans is None
    dev = data.device
    r = rois.to(torch.float32)
    tr_all = torch.zeros((r.shape[0], 2, part, part), device=dev) \
        if no_trans else trans.to(torch.float32)
    ar = torch.arange(spp, dtype=torch.float32, device=dev) + 0.5
    results = []
    for roi, tr in zip(r, tr_all):
        bidx = int(roi[0])
        x1 = torch.round(roi[1]) * scale - 0.5
        y1 = torch.round(roi[2]) * scale - 0.5
        x2 = (torch.round(roi[3]) + 1.0) * scale - 0.5
        y2 = (torch.round(roi[4]) + 1.0) * scale - 0.5
        rw = torch.clamp(x2 - x1, min=0.1)
        rh = torch.clamp(y2 - y1, min=0.1)
        bin_h, bin_w = rh / P, rw / P
        sub_h, sub_w = bin_h / spp, bin_w / spp
        img = data[bidx]
        outs = []
        for ph in range(P):
            for pw in range(P):
                if no_trans:
                    dy = dx = torch.zeros((), device=dev)
                else:
                    py = min(ph * part // P, part - 1)
                    px = min(pw * part // P, part - 1)
                    dy = tr[0, py, px] * trans_std * rh
                    dx = tr[1, py, px] * trans_std * rw
                ys = y1 + ph * bin_h + dy + ar * sub_h
                xs = x1 + pw * bin_w + dx + ar * sub_w
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                gh = min(ph * G // P, G - 1)
                gw = min(pw * G // P, G - 1)
                chans = img[_ps_channels(out_dim, G, gh, gw, dev)]
                outs.append(_bilinear_gather(chans, yy, xx).mean(dim=(1, 2)))
        results.append(torch.stack(outs, 1).reshape(out_dim, P, P))
    return torch.stack(results).to(data.dtype)


# ---------------------------------------------------------------------------
# Proposal / MultiProposal (`contrib/proposal.cc`, `multi_proposal.cc`)
# ---------------------------------------------------------------------------

def _gen_anchors(scales, ratios, stride):
    base = stride - 1.0
    anchors = []
    for r in ratios:
        size_r = stride * stride / r
        w = np.round(np.sqrt(size_r))
        h = np.round(w * r)
        for s in scales:
            ws, hs = w * s, h * s
            cx = cy = base / 2.0
            anchors.append([cx - (ws - 1) / 2, cy - (hs - 1) / 2,
                            cx + (ws - 1) / 2, cy + (hs - 1) / 2])
    return np.asarray(anchors, np.float32)                 # (A, 4)


def _proposal_single(scores, deltas, im_info, anchors, pre_n, post_n,
                     thresh, min_size, stride, iou_loss):
    """scores (A, H, W) foreground scores, deltas (4A, H, W) -> boxes
    (post_n, 4) and scores (post_n, 1)."""
    A = anchors.shape[0]
    _, H, W = scores.shape
    dev = scores.device
    shift_x = torch.arange(W, dtype=torch.float32, device=dev) * stride
    shift_y = torch.arange(H, dtype=torch.float32, device=dev) * stride
    sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)            # (H, W, 4)
    boxes = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    d = deltas.reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
    s = scores.permute(1, 2, 0).reshape(-1)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    cx = boxes[:, 0] + ws * 0.5
    cy = boxes[:, 1] + hs * 0.5
    if iou_loss:
        px1, py1 = boxes[:, 0] + d[:, 0], boxes[:, 1] + d[:, 1]
        px2, py2 = boxes[:, 2] + d[:, 2], boxes[:, 3] + d[:, 3]
    else:
        pcx = cx + d[:, 0] * ws
        pcy = cy + d[:, 1] * hs
        pw = ws * torch.exp(torch.clamp(d[:, 2], -10, 10))
        ph = hs * torch.exp(torch.clamp(d[:, 3], -10, 10))
        px1, py1 = pcx - pw * 0.5, pcy - ph * 0.5
        px2, py2 = pcx + pw * 0.5, pcy + ph * 0.5
    imh, imw = im_info[0], im_info[1]
    zero = torch.zeros((), device=dev)
    px1 = torch.minimum(torch.maximum(px1, zero), imw - 1)
    py1 = torch.minimum(torch.maximum(py1, zero), imh - 1)
    px2 = torch.minimum(torch.maximum(px2, zero), imw - 1)
    py2 = torch.minimum(torch.maximum(py2, zero), imh - 1)
    props = torch.stack([px1, py1, px2, py2], dim=1)
    ms = min_size * im_info[2]
    keep = ((px2 - px1 + 1) >= ms) & ((py2 - py1 + 1) >= ms)
    s = torch.where(keep, s, torch.full_like(s, -1.0))
    pre_n = min(pre_n, s.shape[0])
    # lax.top_k: the largest first, ties by the lower index
    top_i = torch.argsort(-s, stable=True)[:pre_n]
    top_s = s[top_i]
    top_b = props[top_i]
    iou = _pair_iou(top_b, top_b)
    sup = torch.zeros(pre_n, dtype=torch.bool, device=dev)
    ar = torch.arange(pre_n, device=dev)
    for i in range(pre_n):
        sup = sup | ((iou[i] > thresh) & (ar > i) & ~sup[i])
    valid = ~sup & (top_s > -1.0)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    post_idx = order[:post_n]
    if post_idx.shape[0] < post_n:
        post_idx = torch.cat([post_idx, post_idx.new_zeros(
            post_n - post_idx.shape[0])])
    sel_valid = valid[post_idx]
    best = torch.argmax(valid.to(torch.int8))
    post_idx = torch.where(sel_valid, post_idx, best)
    out_scores = torch.where(sel_valid, top_s[post_idx],
                             torch.zeros_like(top_s[post_idx]))
    return top_b[post_idx], out_scores[:, None]


def _proposal_attrs(attrs):
    return (attrs.get_int("rpn_pre_nms_top_n", 6000),
            attrs.get_int("rpn_post_nms_top_n", 300),
            attrs.get_float("threshold", 0.7),
            attrs.get_int("rpn_min_size", 16),
            tuple(attrs.get_tuple("scales", (4, 8, 16, 32))),
            tuple(attrs.get_tuple("ratios", (0.5, 1, 2))),
            attrs.get_int("feature_stride", 16),
            attrs.get_bool("output_score", False),
            attrs.get_bool("iou_loss", False))


def _proposal_outputs(attrs):
    return 2 if attrs.get_bool("output_score", False) else 1


@register("_contrib_Proposal", num_inputs=3,
          input_names=["cls_prob", "bbox_pred", "im_info"],
          num_outputs=_proposal_outputs)
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """The RPN proposal layer (batch 1): anchors plus deltas, clipped,
    the small ones dropped, the top ``pre_n``, NMS, the top ``post_n``."""
    (pre_n, post_n, thresh, min_size, scales, ratios, stride,
     output_score, iou_loss) = _proposal_attrs(attrs)
    A = len(scales) * len(ratios)
    anchors = device_const(_gen_anchors(scales, ratios, stride),
                           cls_prob.device)
    boxes, sc = _proposal_single(cls_prob[0, A:], bbox_pred[0], im_info[0],
                                 anchors, pre_n, post_n, thresh, min_size,
                                 float(stride), iou_loss)
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], dim=1)
    return (rois, sc) if output_score else rois


@register("_contrib_MultiProposal", num_inputs=3,
          input_names=["cls_prob", "bbox_pred", "im_info"],
          num_outputs=_proposal_outputs)
def _multi_proposal(attrs, cls_prob, bbox_pred, im_info):
    """Batched RPN proposals; roi column 0 is the batch index."""
    (pre_n, post_n, thresh, min_size, scales, ratios, stride,
     output_score, iou_loss) = _proposal_attrs(attrs)
    A = len(scales) * len(ratios)
    anchors = device_const(_gen_anchors(scales, ratios, stride),
                           cls_prob.device)
    boxes, scs = [], []
    for n in range(cls_prob.shape[0]):
        b, s = _proposal_single(cls_prob[n, A:], bbox_pred[n], im_info[n],
                                anchors, pre_n, post_n, thresh, min_size,
                                float(stride), iou_loss)
        boxes.append(b)
        scs.append(s)
    boxes = torch.stack(boxes)
    N = boxes.shape[0]
    bidx = torch.arange(N, dtype=boxes.dtype, device=boxes.device)[
        :, None, None].expand(N, post_n, 1)
    rois = torch.cat([bidx, boxes], dim=2).reshape(N * post_n, 5)
    if output_score:
        return rois, torch.stack(scs).reshape(N * post_n, 1)
    return rois


# ---------------------------------------------------------------------------
# bipartite matching (`contrib/bounding_box.cc:155`)
# ---------------------------------------------------------------------------

@register("_contrib_bipartite_matching", num_inputs=1, input_names=["data"],
          num_outputs=2)
def _bipartite_matching(attrs, data):
    """Greedy bipartite matching on [..., N, M] scores: take the best edge
    left, min(N, M) times.  Returns (row -> col, col -> row), -1 where
    unmatched."""
    is_ascend = attrs.get_bool("is_ascend", False)
    threshold = attrs.get_float("threshold", 0.0)
    batch = tuple(data.shape[:-2])
    N, M = data.shape[-2:]
    sign = -1.0 if is_ascend else 1.0
    sv = (data.reshape((-1, N, M)) * sign).clone()
    tv = threshold * sign
    B = sv.shape[0]
    rows = torch.full((B, N), -1.0, device=data.device)
    cols = torch.full((B, M), -1.0, device=data.device)
    ninf = float("-inf")
    bi = torch.arange(B, device=data.device)
    for _ in range(min(N, M)):
        flat = torch.argmax(sv.reshape(B, -1), dim=1)
        i, j = flat // M, flat % M
        ok = sv[bi, i, j] >= tv
        rows[bi, i] = torch.where(ok, j.to(rows.dtype), rows[bi, i])
        cols[bi, j] = torch.where(ok, i.to(cols.dtype), cols[bi, j])
        hit = sv.clone()
        hit[bi, i, :] = ninf
        hit[bi, :, j] = ninf
        sv = torch.where(ok[:, None, None], hit, torch.full_like(sv, ninf))
    return rows.reshape(batch + (N,)), cols.reshape(batch + (M,))


# ---------------------------------------------------------------------------
# count_sketch (`contrib/count_sketch.cc`)
# ---------------------------------------------------------------------------

@register("_contrib_count_sketch", num_inputs=3,
          input_names=["data", "h", "s"])
def _count_sketch(attrs, data, h, s):
    """out[n, h[i]] += s[i] * data[n, i] (compact bilinear pooling)."""
    out_dim = attrs.get_int("out_dim")
    hh = h.reshape(-1).to(torch.int64)
    vals = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, vals)


# ---------------------------------------------------------------------------
# DGL graph ops (`contrib/dgl_graph.cc`), dense and padded
# ---------------------------------------------------------------------------

@register("_contrib_dgl_adjacency", num_inputs=1, input_names=["data"])
def _dgl_adjacency(attrs, data):
    """The binary adjacency of an edge-id matrix."""
    return (data != 0).to(torch.float32)


@register("_contrib_edge_id", num_inputs=3, input_names=["data", "u", "v"])
def _edge_id(attrs, data, u, v):
    """data[u[i], v[i]], -1 where the edge is absent (0 in the dense
    form)."""
    vals = data[u.to(torch.int64), v.to(torch.int64)]
    return torch.where(vals == 0, torch.full_like(vals, -1.0),
                       vals).to(data.dtype)


@register("_contrib_getnnz", num_inputs=1, input_names=["data"])
def _getnnz(attrs, data):
    """The number of stored values (`contrib/nnz.cc`); dense: non-zeros."""
    axis = attrs.get_attr("axis", None)
    nz = (data != 0).to(torch.int32)
    if axis is None:
        return nz.sum(dtype=torch.int32)
    return nz.sum(dim=int(axis), dtype=torch.int32)


def _neighbor_sample(gen, adj, seeds, num_neighbor, max_vertices,
                     probability=None):
    """Up to ``num_neighbor`` neighbors of each seed (uniform or weighted,
    with replacement), -1 past the degree; the sorted unique vertices
    padded with -1 to ``max_vertices``."""
    seeds = seeds.to(torch.int64)
    rows = adj[seeds] != 0                                    # (S, V)
    if probability is not None:
        w = torch.where(rows, torch.clamp(probability, min=1e-20)[None, :],
                        torch.zeros((), device=adj.device))
    else:
        w = rows.to(torch.float32)
    deg = rows.sum(dim=1)
    w = torch.where(deg[:, None] > 0, w, torch.ones_like(w))
    picks = torch.multinomial(w.to(torch.float64), num_neighbor,
                              replacement=True, generator=gen)
    valid = torch.arange(num_neighbor, device=adj.device)[None, :] < \
        torch.clamp(deg, max=num_neighbor)[:, None]
    neigh = torch.where(valid, picks, torch.full_like(picks, -1)).to(
        torch.int32)
    verts = torch.unique(torch.cat([seeds.to(torch.int32),
                                    neigh.reshape(-1)]), sorted=True)
    verts = verts[:max_vertices]
    if verts.shape[0] < max_vertices:
        verts = torch.cat([verts, verts.new_full(
            (max_vertices - verts.shape[0],), -1)])
    return verts, neigh


@register("_contrib_dgl_csr_neighbor_uniform_sample", num_inputs=2,
          input_names=["csr_matrix", "seed_arr"], needs_rng=True,
          num_outputs=2)
def _dgl_uniform_sample(attrs, gen, adj, seeds):
    """Uniform neighbor sampling: (the sampled vertices padded with -1,
    each seed's picks)."""
    return _neighbor_sample(gen, adj, seeds.reshape(-1),
                            attrs.get_int("num_neighbor", 2),
                            attrs.get_int("max_num_vertices", 100))


@register("_contrib_dgl_csr_neighbor_non_uniform_sample", num_inputs=3,
          input_names=["csr_matrix", "probability", "seed_arr"],
          needs_rng=True, num_outputs=2)
def _dgl_non_uniform_sample(attrs, gen, adj, probability, seeds):
    return _neighbor_sample(gen, adj, seeds.reshape(-1),
                            attrs.get_int("num_neighbor", 2),
                            attrs.get_int("max_num_vertices", 100),
                            probability.reshape(-1))


@register("_contrib_dgl_subgraph", num_inputs=2,
          input_names=["graph", "data"], num_outputs=1)
def _dgl_subgraph(attrs, adj, vids):
    """The subgraph induced by ``vids`` (ids < 0 give zero rows)."""
    v = vids.reshape(-1).to(torch.int64)
    m = (v >= 0).to(adj.dtype)
    vc = torch.clamp(v, 0, adj.shape[0] - 1)
    return adj[vc][:, vc] * m[:, None] * m[None, :]


@register("_contrib_dgl_graph_compact", num_inputs=1,
          input_names=["graph_data"], num_outputs=1)
def _dgl_graph_compact(attrs, adj):
    """Renumber the non-empty vertices of a padded adjacency densely."""
    nz = (adj != 0).to(torch.int32)
    deg = nz.sum(dim=1) + nz.sum(dim=0)
    order = torch.argsort((deg == 0).to(torch.int8), stable=True)
    return adj[order][:, order]


# ---------------------------------------------------------------------------
# SyncBatchNorm (`contrib/sync_batch_norm.cc`)
# ---------------------------------------------------------------------------

def _mapped_axis(axis_name):
    """The current mesh when ``axis_name`` is one of its axes of more than
    one rank (the op runs inside that axis's map), else None."""
    if not axis_name:
        return None
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.axis_names or \
            mesh.axis_size(axis_name) < 2:
        return None
    return mesh


@register("_contrib_SyncBatchNorm", num_inputs=5,
          input_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
          uses_train_mode=True, num_outputs=1, mutate_inputs=(3, 4))
def _sync_batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Cross-rank BatchNorm: in training, the batch moments, then (inside
    a map over ``axis_name``) their mean over that axis, as the JAX
    package's ``lax.pmean`` of the mean and of the variance; under
    `SPMDTrainer` (`ops.nn.batch_stats_scope`) the whole batch's moments,
    as BatchNorm's."""
    eps = attrs.get_float("eps", 1e-3)
    momentum = attrs.get_float("momentum", 0.9)
    fix_gamma = attrs.get_bool("fix_gamma", True)
    use_global = attrs.get_bool("use_global_stats", False)
    training = attrs.get_bool("__train", False) and not use_global
    axes = (0,) + tuple(range(2, data.dim()))
    if training:
        mean = data.mean(dim=axes)
        var = data.var(dim=axes, unbiased=False)
        axis = attrs.get_str("axis_name", None)
        from .nn import _BATCH_STATS, _global_moments
        if _mapped_axis(axis) is not None:
            from ..parallel import collectives as C
            mean = C.pmean(mean, axis)
            var = C.pmean(var, axis)
        elif _BATCH_STATS.reduce is not None:
            mean, var = _global_moments(data, axes, _BATCH_STATS.reduce,
                                        _BATCH_STATS.ranks)
            mean, var = mean.to(data.dtype), var.to(data.dtype)
        with torch.no_grad():
            new_mean = momentum * moving_mean + (1 - momentum) * mean
            new_var = momentum * moving_var + (1 - momentum) * var
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    shape = (1, -1) + (1,) * (data.dim() - 2)
    out = (data - mean.reshape(shape)) * \
        (g.reshape(shape) * torch.rsqrt(var.reshape(shape) + eps)) + \
        beta.reshape(shape)
    return out, new_mean.detach(), new_var.detach()


# ---------------------------------------------------------------------------
# aliases
# ---------------------------------------------------------------------------

alias("_contrib_DeformableConvolution", "DeformableConvolution")
alias("_contrib_PSROIPooling", "PSROIPooling")
alias("_contrib_DeformablePSROIPooling", "DeformablePSROIPooling")
alias("_contrib_Proposal", "Proposal")
alias("_contrib_MultiProposal", "MultiProposal")
alias("_contrib_SyncBatchNorm", "SyncBatchNorm")
alias("_contrib_box_nms", "_contrib_box_non_maximum_suppression")
alias("_contrib_gradient_multiplier", "_contrib_gradientmultiplier")
