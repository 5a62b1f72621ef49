"""The contrib ops' cases without the JAX package: one or more cases for
each of the 57 names of `ops/contrib_ops.py`, `ops/contrib_extra.py` and
`ops/quantized_ops.py` (aliases included), at small shapes, from seeds.
`tests/test_torch_contrib_ops.py` runs them through both packages on the
CPU; ``chip_smoke.py`` phase 20d runs them on the card against the port's
CPU path.  Each case is ``(op name, inputs, attrs, wrt)``: ``wrt`` lists
the inputs whose gradient (of a fixed random projection of the float
outputs, `torch_sweep_cases.run_case`) is compared; the samplers are held
by structure in `SAMPLERS`."""
import numpy as np

RS = np.random.RandomState


def maker(pkg, ctx=None):
    """``pkg.nd.array`` keeping the input's dtype (int8 payloads, int32
    accumulators), on ``ctx``."""
    kw = {} if ctx is None else {"ctx": ctx}
    return lambda x: pkg.nd.array(np.asarray(x), dtype=np.asarray(x).dtype,
                                  **kw)


def _boxes(rs, *lead, scale=1.0):
    xy = rs.uniform(0, 0.7, lead + (2,))
    wh = rs.uniform(0.1, 0.3, lead + (2,))
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


def _nms_rows(seed=0, batch=2, n=12):
    rs = RS(seed)
    ids = rs.randint(0, 3, (batch, n, 1)).astype(np.float32)
    scores = rs.uniform(0, 1, (batch, n, 1)).astype(np.float32)
    base = _boxes(rs, batch, n // 2)
    jitter = rs.uniform(-0.02, 0.02, (batch, n // 2, 4)).astype(np.float32)
    boxes = np.concatenate([base, base + jitter], 1)
    return np.concatenate([ids, scores, boxes], -1).astype(np.float32)


def _anchors(h=4, w=4, sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5)):
    """MultiBoxPrior's anchors in numpy (the op's formula)."""
    cy = (np.arange(h) + 0.5) / h
    cx = (np.arange(w) + 0.5) / w
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    whs = np.asarray(whs)
    a = np.stack([cxg[..., None] - whs[:, 0] / 2, cyg[..., None] - whs[:, 1] / 2,
                  cxg[..., None] + whs[:, 0] / 2,
                  cyg[..., None] + whs[:, 1] / 2], -1)
    return a.reshape(1, -1, 4).astype(np.float32)


def _mb_labels(seed=3):
    rs = RS(seed)
    lab = np.full((2, 4, 5), -1.0, np.float32)
    for b, m in ((0, 3), (1, 2)):
        lab[b, :m, 0] = rs.randint(0, 4, m)
        lab[b, :m, 1:] = _boxes(rs, m)
    return lab


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _rois(seed, n, size, batch=2):
    rs = RS(seed)
    xy = rs.uniform(0, size * 0.5, (n, 2))
    wh = rs.uniform(size * 0.2, size * 0.45, (n, 2))
    b = rs.randint(0, batch, (n, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


def _int8(seed, *shape):
    return RS(seed).randint(-127, 128, shape).astype(np.int8)


def _scalar(v):
    return np.array([v], np.float32)


def _graph(seed=0, n=6):
    rs = RS(seed)
    adj = (rs.uniform(size=(n, n)) < 0.45) * rs.randint(1, 9, (n, n))
    np.fill_diagonal(adj, 0)
    adj[n - 1] = 0
    adj[:, n - 1] = 0
    return adj.astype(np.float32)


def _cases():
    img = RS(1).randn(2, 3, 8, 8).astype(np.float32)
    anchors = _anchors()
    A = anchors.shape[1]
    cls_pred = RS(4).randn(2, 5, A).astype(np.float32)
    cls_prob = _softmax(RS(5).randn(2, 5, A).astype(np.float32), 1)
    loc = (RS(6).randn(2, A * 4) * 0.1).astype(np.float32)
    theta = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.05],
                      [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)
    grid = RS(7).uniform(-1.1, 1.1, (2, 2, 5, 6)).astype(np.float32)
    flow = RS(8).randn(2, 2, 4, 5).astype(np.float32)
    acc = RS(9).randint(-50000, 50000, (3, 4, 5, 5)).astype(np.int32)
    q_fc = [_int8(10, 4, 16), _int8(11, 8, 16), _int8(12, 8),
            _scalar(-1.2), _scalar(1.5), _scalar(-0.8), _scalar(0.6),
            _scalar(-0.2), _scalar(0.3)]
    q_conv = [_int8(13, 2, 3, 8, 8), _int8(14, 4, 3, 3, 3), _int8(15, 4),
              _scalar(-2.0), _scalar(2.5), _scalar(-0.5), _scalar(0.4),
              _scalar(-0.1), _scalar(0.1)]
    q8 = [_int8(16, 2, 3, 7, 7), _scalar(-3.0), _scalar(3.0)]
    rs = RS(17)
    dconv = [rs.randn(1, 4, 6, 6).astype(np.float32),
             (rs.randn(1, 18, 6, 6) * 0.5).astype(np.float32),
             rs.randn(4, 4, 3, 3).astype(np.float32),
             rs.randn(4).astype(np.float32)]
    ps_data = RS(18).randn(2, 8, 8, 8).astype(np.float32)
    ps_rois = _rois(19, 3, 8)
    trans = (RS(20).randn(3, 2, 2, 2) * 0.5).astype(np.float32)
    A_p = 6
    prop = [RS(21).uniform(size=(1, 2 * A_p, 4, 4)).astype(np.float32),
            (RS(22).randn(1, 4 * A_p, 4, 4) * 0.1).astype(np.float32),
            np.array([[64.0, 64.0, 1.0]], np.float32)]
    prop_attrs = dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8,
                      scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=16,
                      rpn_min_size=4, threshold=0.7, output_score=True)
    adj = _graph()
    return {
        "box_iou": ("_contrib_box_iou", [_boxes(RS(0), 2, 5),
                                         _boxes(RS(1), 3)], {}, [0, 1]),
        "box_iou_alias_center": ("box_iou", [_boxes(RS(2), 4),
                                             _boxes(RS(3), 3)],
                                 {"format": "center"}, [0, 1]),
        "box_nms": ("_contrib_box_nms", [_nms_rows()],
                    {"overlap_thresh": 0.5, "topk": 8, "id_index": 0},
                    [0]),
        "box_nms_alias": ("box_nms", [_nms_rows(1)],
                          {"overlap_thresh": 0.3, "valid_thresh": 0.2}, [0]),
        "box_nms_force": ("_contrib_box_non_maximum_suppression",
                          [_nms_rows(2)], {"overlap_thresh": 0.4,
                                           "id_index": 0,
                                           "force_suppress": True}, [0]),
        "multibox_prior": ("_contrib_MultiBoxPrior",
                           [np.zeros((1, 3, 4, 4), np.float32)],
                           {"sizes": (0.3, 0.5), "ratios": (1, 2, 0.5)}, []),
        "multibox_prior_alias": ("MultiBoxPrior",
                                 [np.zeros((1, 3, 3, 5), np.float32)],
                                 {"sizes": (0.2,), "ratios": (1, 3),
                                  "steps": (0.3, 0.2)}, []),
        "multibox_target": ("_contrib_MultiBoxTarget",
                            [anchors, _mb_labels(), cls_pred],
                            {"overlap_threshold": 0.5}, []),
        "multibox_target_mining": ("MultiBoxTarget",
                                   [anchors, _mb_labels(), cls_pred],
                                   {"overlap_threshold": 0.5,
                                    "negative_mining_ratio": 3.0,
                                    "negative_mining_thresh": 0.5}, []),
        "multibox_detection": ("_contrib_MultiBoxDetection",
                               [cls_prob, loc, anchors],
                               {"nms_threshold": 0.45, "nms_topk": 20},
                               []),
        "multibox_detection_alias": ("MultiBoxDetection",
                                     [cls_prob, loc, anchors],
                                     {"threshold": 0.3}, []),
        "roi_pooling": ("ROIPooling", [img, _rois(23, 3, 8)],
                        {"pooled_size": (2, 2), "spatial_scale": 1.0}, [0]),
        "roi_align": ("_contrib_ROIAlign", [img, _rois(24, 3, 8)],
                      {"pooled_size": (2, 3), "spatial_scale": 1.0,
                       "sample_ratio": 2}, [0]),
        "roi_align_alias": ("ROIAlign", [img, _rois(25, 2, 16)],
                            {"pooled_size": (2, 2), "spatial_scale": 0.5},
                            [0]),
        "bilinear_resize": ("_contrib_BilinearResize2D", [img],
                            {"height": 5, "width": 11}, [0]),
        "adaptive_pool": ("_contrib_AdaptiveAvgPooling2D",
                          [RS(26).randn(2, 3, 7, 7).astype(np.float32)],
                          {"output_size": (3, 3)}, [0]),
        "adaptive_pool_divisible": ("_contrib_AdaptiveAvgPooling2D", [img],
                                    {"output_size": 4}, [0]),
        "div_sqrt_dim": ("_contrib_div_sqrt_dim",
                         [RS(27).randn(3, 4, 8).astype(np.float32)], {}, [0]),
        "gradient_multiplier": ("_contrib_gradient_multiplier",
                                [RS(28).randn(3, 4).astype(np.float32)],
                                {"scalar": 0.25}, [0]),
        "gradientmultiplier": ("_contrib_gradientmultiplier",
                               [RS(29).randn(3, 4).astype(np.float32)],
                               {"scalar": -2.0}, [0]),
        "quadratic": ("_contrib_quadratic",
                      [RS(30).randn(3, 4).astype(np.float32)],
                      {"a": 0.5, "b": -1.5, "c": 2.0}, [0]),
        "index_copy": ("_contrib_index_copy",
                       [RS(31).randn(5, 3).astype(np.float32),
                        np.array([0, 4, 2], np.float32),
                        RS(32).randn(3, 3).astype(np.float32)], {}, [0, 2]),
        "fft": ("_contrib_fft", [RS(33).randn(3, 8).astype(np.float32)],
                {}, [0]),
        "ifft": ("_contrib_ifft", [RS(34).randn(3, 16).astype(np.float32)],
                 {}, [0]),
        "bilinear_sampler": ("BilinearSampler",
                             [img, grid], {}, [0, 1]),
        "grid_generator_affine": ("GridGenerator", [theta],
                                  {"transform_type": "affine",
                                   "target_shape": (4, 5)}, [0]),
        "grid_generator_warp": ("GridGenerator", [flow],
                                {"transform_type": "warp"}, [0]),
        "spatial_transformer": ("SpatialTransformer", [img, theta],
                                {"target_shape": (6, 5),
                                 "transform_type": "affine",
                                 "sampler_type": "bilinear"}, [0, 1]),
        "quantize": ("_contrib_quantize",
                     [RS(35).randn(4, 5).astype(np.float32), _scalar(-1.5),
                      _scalar(2.0)], {}, []),
        "quantize_v2": ("_contrib_quantize_v2",
                        [RS(36).randn(4, 5).astype(np.float32)], {}, []),
        "quantize_v2_calib": ("_contrib_quantize_v2",
                              [RS(37).randn(4, 5).astype(np.float32)],
                              {"min_calib_range": -1.0,
                               "max_calib_range": 1.25}, []),
        "dequantize": ("_contrib_dequantize",
                       [_int8(38, 4, 5), _scalar(-0.7), _scalar(1.1)], {},
                       []),
        "requantize": ("_contrib_requantize",
                       [acc, _scalar(-3.0), _scalar(3.0)], {}, []),
        "requantize_calib": ("_contrib_requantize",
                             [acc, _scalar(-3.0), _scalar(3.0)],
                             {"min_calib_range": -0.02,
                              "max_calib_range": 0.02}, []),
        "quantized_fc": ("_contrib_quantized_fully_connected", q_fc,
                         {"num_hidden": 8}, []),
        "quantized_fc_no_bias": ("_contrib_quantized_fully_connected",
                                 [q_fc[0], q_fc[1]] + q_fc[3:7],
                                 {"num_hidden": 8, "no_bias": True}, []),
        "quantized_conv": ("_contrib_quantized_conv", q_conv,
                           {"kernel": (3, 3), "pad": (1, 1),
                            "num_filter": 4}, []),
        "quantized_conv_strided": ("_contrib_quantized_conv",
                                   [q_conv[0], q_conv[1]] + q_conv[3:7],
                                   {"kernel": (3, 3), "stride": (2, 2),
                                    "num_filter": 4, "no_bias": True}, []),
        "quantized_pooling_max": ("_contrib_quantized_pooling", q8,
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "max"}, []),
        "quantized_pooling_avg": ("_contrib_quantized_pooling", q8,
                                  {"kernel": (2, 2), "stride": (2, 2),
                                   "pool_type": "avg",
                                   "pooling_convention": "full"}, []),
        "quantized_pooling_global": ("_contrib_quantized_pooling", q8,
                                     {"kernel": (1, 1), "global_pool": True,
                                      "pool_type": "avg"}, []),
        "quantized_flatten": ("_contrib_quantized_flatten", q8, {}, []),
        "quantized_concat": ("_contrib_quantized_concat",
                             [_int8(39, 2, 3, 4), _int8(40, 2, 2, 4),
                              _scalar(-1.0), _scalar(1.0), _scalar(-0.5),
                              _scalar(2.0)],
                             {"num_args": 2, "dim": 1}, []),
        "quantized_act": ("_contrib_quantized_act", q8,
                          {"act_type": "relu"}, []),
        "deformable_conv": ("_contrib_DeformableConvolution", dconv,
                            {"kernel": (3, 3), "pad": (1, 1),
                             "num_filter": 4}, [0, 1, 2, 3]),
        "deformable_conv_alias": ("DeformableConvolution",
                                  [dconv[0], dconv[1][:, :, ::2, ::2].copy(),
                                   dconv[2]],
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "num_filter": 4,
                                   "no_bias": True}, [0, 1, 2]),
        "psroi_pooling": ("_contrib_PSROIPooling", [ps_data, ps_rois],
                          {"spatial_scale": 1.0, "output_dim": 2,
                           "pooled_size": 2, "group_size": 2}, [0]),
        "psroi_pooling_alias": ("PSROIPooling", [ps_data, ps_rois],
                                {"spatial_scale": 0.5, "output_dim": 2,
                                 "pooled_size": 2}, [0]),
        "deformable_psroi": ("_contrib_DeformablePSROIPooling",
                             [ps_data, ps_rois, trans],
                             {"spatial_scale": 1.0, "output_dim": 2,
                              "pooled_size": 2, "group_size": 2,
                              "part_size": 2, "sample_per_part": 2,
                              "trans_std": 0.1}, [0, 2]),
        "deformable_psroi_alias": ("DeformablePSROIPooling",
                                   [ps_data, ps_rois],
                                   {"spatial_scale": 1.0, "output_dim": 2,
                                    "pooled_size": 2, "no_trans": True,
                                    "sample_per_part": 3}, [0]),
        "proposal": ("_contrib_Proposal", prop, prop_attrs, []),
        "proposal_alias": ("Proposal", prop,
                           dict(prop_attrs, output_score=False,
                                iou_loss=True), []),
        "multi_proposal": ("_contrib_MultiProposal",
                           [np.concatenate([prop[0], prop[0][:, :, ::-1]]),
                            np.concatenate([prop[1], -prop[1]]),
                            np.repeat(prop[2], 2, 0)], prop_attrs, []),
        "multi_proposal_alias": ("MultiProposal",
                                 [np.repeat(prop[0], 2, 0),
                                  np.repeat(prop[1], 2, 0),
                                  np.repeat(prop[2], 2, 0)],
                                 dict(prop_attrs, output_score=False), []),
        "bipartite_matching": ("_contrib_bipartite_matching",
                               [RS(41).uniform(size=(2, 4, 3))
                                .astype(np.float32)],
                               {"threshold": 0.2}, []),
        "bipartite_matching_ascend": ("_contrib_bipartite_matching",
                                      [RS(42).uniform(size=(5, 3))
                                       .astype(np.float32)],
                                      {"threshold": 0.8, "is_ascend": True},
                                      []),
        "count_sketch": ("_contrib_count_sketch",
                         [RS(43).randn(3, 6).astype(np.float32),
                          np.array([0, 3, 1, 0, 2, 3], np.float32),
                          np.array([1, -1, 1, 1, -1, 1], np.float32)],
                         {"out_dim": 4}, [0]),
        "dgl_adjacency": ("_contrib_dgl_adjacency", [adj], {}, []),
        "edge_id": ("_contrib_edge_id",
                    [adj, np.array([0, 1, 2, 5], np.float32),
                     np.array([1, 0, 4, 2], np.float32)], {}, []),
        "getnnz": ("_contrib_getnnz", [adj], {}, []),
        "getnnz_axis": ("_contrib_getnnz", [adj], {"axis": 0}, []),
        "dgl_subgraph": ("_contrib_dgl_subgraph",
                         [adj, np.array([0, 2, -1, 3], np.float32)], {}, []),
        "dgl_graph_compact": ("_contrib_dgl_graph_compact", [adj], {}, []),
        "sync_batch_norm": ("_contrib_SyncBatchNorm",
                            [RS(44).randn(4, 3, 5, 5).astype(np.float32),
                             RS(45).uniform(0.5, 1.5, 3).astype(np.float32),
                             RS(46).randn(3).astype(np.float32),
                             RS(47).randn(3).astype(np.float32),
                             RS(48).uniform(0.5, 2, 3).astype(np.float32)],
                            {"fix_gamma": False}, [0, 1, 2]),
        "sync_batch_norm_alias": ("SyncBatchNorm",
                                  [RS(49).randn(4, 3, 5).astype(np.float32),
                                   np.ones(3, np.float32),
                                   np.zeros(3, np.float32),
                                   np.zeros(3, np.float32),
                                   np.ones(3, np.float32)],
                                  {"axis_name": "dp"}, [0, 2]),
    }


CASES = _cases()

#: the neighbor samplers, held by structure and statistics
SAMPLERS = {
    "dgl_uniform": ("_contrib_dgl_csr_neighbor_uniform_sample",
                    [_graph(), np.array([0, 2, 5], np.float32)],
                    {"num_neighbor": 3, "max_num_vertices": 8}),
    "dgl_non_uniform": ("_contrib_dgl_csr_neighbor_non_uniform_sample",
                        [_graph(), RS(51).uniform(0.1, 1, 6)
                         .astype(np.float32),
                         np.array([1, 3], np.float32)],
                        {"num_neighbor": 4, "max_num_vertices": 9}),
}


def sampler_structure(adj, seeds, verts, neigh, num_neighbor, max_vertices):
    """The checks a sample must pass whatever the stream: each seed's
    picks are its neighbors, -1 exactly past its degree; the vertices are
    the sorted unique seeds and picks, -1 padded to ``max_vertices``."""
    adj = np.asarray(adj)
    seeds = np.asarray(seeds).astype(np.int64)
    verts = np.asarray(verts)
    neigh = np.asarray(neigh)
    assert neigh.shape == (len(seeds), num_neighbor), neigh.shape
    assert verts.shape == (max_vertices,), verts.shape
    for s, row in zip(seeds, neigh):
        deg = int((adj[s] != 0).sum())
        valid = np.arange(num_neighbor) < min(deg, num_neighbor)
        assert (row[~valid] == -1).all(), (s, row)
        assert all(adj[s, int(p)] != 0 for p in row[valid]), (s, row)
    want = np.unique(np.concatenate([seeds, neigh.reshape(-1)]))
    want = want[:max_vertices]
    want = np.concatenate([want, -np.ones(max_vertices - len(want))])
    np.testing.assert_array_equal(verts, want)
