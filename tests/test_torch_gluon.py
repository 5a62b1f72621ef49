"""The port's Gluon against the JAX package's, on the CPU.

Every layer of `gluon.nn` and every ported loss is built in both packages
under one prefix, given the same seeded numpy weights by name, and run on
the same inputs: outputs, input gradients, parameter gradients and
BatchNorm's moving statistics within 1e-5, the port's hybridized forward
equal to its imperative one bit for bit.  Then the Block machinery
(names, deferred shapes, hooks, `.params` files in both directions),
`export` served by both packages' `Predictor` within 1e-4 with matching
graph-pass reports, `Trainer` (the multi-tensor update against the
reference's, the stale-gradient guard, states, the refused kvstore) and
`gluon.utils`."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jx
import mxnet_tpu_torch as tx

TOL = 1e-5
PKGS = {"jax": jx, "torch": tx}


def _arr(pkg, a):
    a = np.asarray(a)
    if pkg is tx:
        return tx.nd.array(a, ctx=tx.cpu(), dtype=a.dtype)
    return jx.nd.array(a, dtype=a.dtype)


def _init(pkg, blk):
    if pkg is tx:
        blk.initialize(ctx=tx.cpu())
    else:
        blk.initialize()


def _values(params, seed):
    """Seeded values for every parameter, by name (variances positive)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(params):
        shape = params[name].shape
        v = rng.randn(*shape).astype(np.float32) * 0.5
        if name.endswith(("_var", "running_var")):
            v = np.abs(v) + 0.5
        out[name] = v
    return out


def _set(pkg, blk, values):
    for name, p in blk.collect_params().items():
        p.set_data(_arr(pkg, values[name]))


def _inputs(specs, seed):
    rng = np.random.RandomState(seed)
    out = []
    for s in specs:
        if s[0] == "ids":
            out.append(rng.randint(0, s[1], s[2]).astype(np.float32))
        else:
            out.append(rng.randn(*s).astype(np.float32))
    return out


def _run(pkg, make, xs, values, train, hybrid=False):
    """Outputs (predict mode), then outputs, moving statistics and
    gradients of a recorded forward with a fixed head gradient."""
    blk = make(pkg)
    _init(pkg, blk)
    nds = [_arr(pkg, x) for x in xs]
    blk(*nds)                                     # settles deferred shapes
    _set(pkg, blk, values)
    if hybrid:
        blk.hybridize()
    pred = blk(*nds)
    for x in nds:
        x.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = blk(*nds)
    hg = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    out.backward(_arr(pkg, hg))
    res = {"predict": pred.asnumpy(), "out": out.asnumpy()}
    for i, x in enumerate(nds):
        res[f"dx{i}"] = x.grad.asnumpy()
    for name, p in blk.collect_params().items():
        res[name] = p.data().asnumpy()
        if p.grad_req != "null":
            res["d" + name] = p.grad().asnumpy()
    return blk, res


def _layer(make_nn, *specs, train=True, seed=0):
    return (make_nn, specs, train, seed)


def _seq(nn):
    s = nn.Sequential(prefix="l_")
    with s.name_scope():
        s.add(nn.Dense(6, activation="relu"), nn.Dense(3))
    return s


def _hseq(nn):
    s = nn.HybridSequential(prefix="l_")
    with s.name_scope():
        s.add(nn.Dense(6), nn.BatchNorm(), nn.Activation("sigmoid"),
              nn.Dense(3, flatten=False))
    return s


LAYERS = {
    "dense": _layer(lambda nn: nn.Dense(5, prefix="l_"), (3, 2, 4)),
    "dense_tanh_noflatten_nobias": _layer(
        lambda nn: nn.Dense(5, activation="tanh", flatten=False,
                            use_bias=False, prefix="l_"), (3, 2, 4)),
    "dropout_predict": _layer(lambda nn: nn.Dropout(0.4, prefix="l_"),
                              (3, 4), train=False),
    "batchnorm": _layer(lambda nn: nn.BatchNorm(prefix="l_"), (4, 3, 5, 5)),
    "batchnorm_last_axis_no_affine": _layer(
        lambda nn: nn.BatchNorm(axis=-1, scale=False, center=False,
                                momentum=0.8, prefix="l_"), (6, 4)),
    "batchnorm_global_stats": _layer(
        lambda nn: nn.BatchNorm(use_global_stats=True, prefix="l_"),
        (4, 3, 2)),
    "instancenorm": _layer(lambda nn: nn.InstanceNorm(prefix="l_"),
                           (2, 3, 4, 5)),
    "layernorm": _layer(lambda nn: nn.LayerNorm(prefix="l_"), (2, 3, 6)),
    "embedding": _layer(lambda nn: nn.Embedding(10, 4, prefix="l_"),
                        ("ids", 10, (3, 5))),
    "flatten": _layer(lambda nn: nn.Flatten(prefix="l_"), (2, 3, 4)),
    "activation_softrelu": _layer(
        lambda nn: nn.Activation("softrelu", prefix="l_"), (3, 4)),
    "leakyrelu": _layer(lambda nn: nn.LeakyReLU(0.1, prefix="l_"), (3, 4)),
    "prelu": _layer(lambda nn: nn.PReLU(prefix="l_"), (3, 4)),
    "elu": _layer(lambda nn: nn.ELU(0.7, prefix="l_"), (3, 4)),
    "selu": _layer(lambda nn: nn.SELU(prefix="l_"), (3, 4)),
    "gelu": _layer(lambda nn: nn.GELU(prefix="l_"), (3, 4)),
    "swish": _layer(lambda nn: nn.Swish(1.5, prefix="l_"), (3, 4)),
    "hybrid_lambda": _layer(
        lambda nn: nn.HybridLambda(lambda F, x: F.relu(x) * 2,
                                   prefix="l_"), (3, 4)),
    "hybrid_lambda_by_name": _layer(
        lambda nn: nn.HybridLambda("tanh", prefix="l_"), (3, 4)),
    "lambda": _layer(lambda nn: nn.Lambda("sigmoid", prefix="l_"), (3, 4)),
    "sequential": _layer(_seq, (4, 5)),
    "hybridsequential": _layer(_hseq, (4, 5)),
    "conv1d": _layer(lambda nn: nn.Conv1D(4, 3, strides=2, padding=1,
                                          prefix="l_"), (2, 3, 9)),
    "conv2d": _layer(lambda nn: nn.Conv2D(4, (3, 2), strides=(2, 1),
                                          padding=(1, 0), dilation=(1, 2),
                                          activation="relu", prefix="l_"),
                     (2, 3, 8, 9)),
    "conv2d_groups_nobias": _layer(
        lambda nn: nn.Conv2D(6, 3, groups=3, use_bias=False, prefix="l_"),
        (2, 6, 7, 7)),
    "conv2d_nhwc": _layer(lambda nn: nn.Conv2D(4, 3, padding=1,
                                               layout="NHWC", prefix="l_"),
                          (2, 7, 6, 3)),
    "conv3d": _layer(lambda nn: nn.Conv3D(2, 3, padding=1, prefix="l_"),
                     (1, 2, 4, 5, 4)),
    "conv1dtranspose": _layer(
        lambda nn: nn.Conv1DTranspose(3, 3, strides=2, output_padding=1,
                                      prefix="l_"), (2, 4, 6)),
    "conv2dtranspose": _layer(
        lambda nn: nn.Conv2DTranspose(3, 3, strides=2, padding=1,
                                      output_padding=(1, 0), prefix="l_"),
        (2, 4, 5, 5)),
    "conv3dtranspose": _layer(
        lambda nn: nn.Conv3DTranspose(2, 2, strides=2, prefix="l_"),
        (1, 3, 3, 3, 3)),
    "maxpool1d": _layer(lambda nn: nn.MaxPool1D(3, 2, 1, prefix="l_"),
                        (2, 3, 10)),
    "maxpool2d_ceil": _layer(
        lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True, prefix="l_"),
        (2, 3, 10, 9)),
    "maxpool2d_nhwc": _layer(
        lambda nn: nn.MaxPool2D(3, 2, 1, layout="NHWC", prefix="l_"),
        (2, 9, 8, 3)),
    "maxpool3d": _layer(lambda nn: nn.MaxPool3D(2, prefix="l_"),
                        (1, 2, 4, 4, 4)),
    "avgpool1d": _layer(lambda nn: nn.AvgPool1D(2, prefix="l_"), (2, 3, 9)),
    "avgpool2d_ceil_pad": _layer(
        lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True, prefix="l_"),
        (2, 3, 10, 9)),
    "avgpool2d_exclude_pad": _layer(
        lambda nn: nn.AvgPool2D(3, 1, 1, count_include_pad=False,
                                prefix="l_"), (2, 3, 6, 6)),
    "avgpool3d_ceil": _layer(
        lambda nn: nn.AvgPool3D(2, ceil_mode=True, prefix="l_"),
        (1, 2, 5, 4, 5)),
    "globalmaxpool1d": _layer(lambda nn: nn.GlobalMaxPool1D(prefix="l_"),
                              (2, 3, 7)),
    "globalmaxpool2d": _layer(lambda nn: nn.GlobalMaxPool2D(prefix="l_"),
                              (2, 3, 5, 4)),
    "globalmaxpool3d": _layer(lambda nn: nn.GlobalMaxPool3D(prefix="l_"),
                              (1, 2, 3, 4, 3)),
    "globalavgpool1d": _layer(lambda nn: nn.GlobalAvgPool1D(prefix="l_"),
                              (2, 3, 7)),
    "globalavgpool2d": _layer(lambda nn: nn.GlobalAvgPool2D(prefix="l_"),
                              (2, 3, 5, 4)),
    "globalavgpool2d_nhwc": _layer(
        lambda nn: nn.GlobalAvgPool2D(layout="NHWC", prefix="l_"),
        (2, 5, 4, 3)),
    "globalavgpool3d": _layer(lambda nn: nn.GlobalAvgPool3D(prefix="l_"),
                              (1, 2, 3, 4, 3)),
    "reflectionpad2d": _layer(lambda nn: nn.ReflectionPad2D(2, prefix="l_"),
                              (1, 2, 5, 6)),
}


def _compare(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    make_nn, specs, train, seed = LAYERS[name]
    xs = _inputs(specs, seed)
    # the parameters' names and shapes, which both packages share
    tblk = make_nn(tx.gluon.nn)
    _init(tx, tblk)
    tblk(*[_arr(tx, x) for x in xs])
    values = _values(dict(tblk.collect_params().items()), seed + 1)
    _, want = _run(jx, lambda p: make_nn(p.gluon.nn), xs, values, train)
    tblk, got = _run(tx, lambda p: make_nn(p.gluon.nn), xs, values, train)
    _compare(got, want)
    if isinstance(tblk, tx.gluon.HybridBlock):
        _, hyb = _run(tx, lambda p: make_nn(p.gluon.nn), xs, values, train,
                      hybrid=True)
        for k in got:
            assert np.array_equal(hyb[k], got[k]), k


def test_dropout_draws_in_training_only():
    """Train mode keeps about 1 - p of the elements, scaled by 1 / (1 - p),
    from the device's stream; predict mode is the identity, hybridized or
    not.  The two packages' streams differ, so this holds the law."""
    blk = tx.gluon.nn.Dropout(0.3)
    x = _arr(tx, np.ones((200, 100), np.float32))
    with tx.autograd.record():
        y = blk(x).asnumpy()
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.02
    np.testing.assert_allclose(y[kept], 1 / 0.7, rtol=1e-6)
    blk.hybridize()
    assert np.array_equal(blk(x).asnumpy(), x.asnumpy())


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss(make, *specs):
    return (make, specs)


LOSSES = {
    "l2": _loss(lambda L: L.L2Loss(), (4, 3), (4, 3)),
    "l2_weight_sample_weight": _loss(lambda L: L.L2Loss(weight=0.5),
                                     (4, 3), (4, 3), (4, 1)),
    "l1": _loss(lambda L: L.L1Loss(), (4, 3), (4, 3)),
    "sigmoid_bce": _loss(lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                         (4, 3), ("bin", (4, 3))),
    "sigmoid_bce_pos_weight": _loss(lambda L: L.SigmoidBCELoss(),
                                    (4, 3), ("bin", (4, 3)), None,
                                    ("pos", (1, 3))),
    "sigmoid_bce_from_sigmoid": _loss(
        lambda L: L.SigmoidBCELoss(from_sigmoid=True), ("prob", (4, 3)),
        ("bin", (4, 3))),
    "softmax_ce": _loss(lambda L: L.SoftmaxCrossEntropyLoss(), (5, 4),
                        ("ids", 4, (5,))),
    "softmax_ce_dense_label": _loss(
        lambda L: L.SoftmaxCELoss(sparse_label=False), (5, 4),
        ("prob", (5, 4))),
    "softmax_ce_from_logits_axis1": _loss(
        lambda L: L.SoftmaxCELoss(axis=1, from_logits=True), (3, 4, 2),
        ("ids", 4, (3, 1, 2))),
    "softmax_ce_weighted": _loss(
        lambda L: L.SoftmaxCELoss(weight=2.0), (5, 4), ("ids", 4, (5,)),
        ("pos", (5, 1))),
    "kldiv": _loss(lambda L: L.KLDivLoss(from_logits=False), (4, 5),
                   ("prob", (4, 5))),
    "huber": _loss(lambda L: L.HuberLoss(rho=0.7), (4, 3), (4, 3)),
    "hinge": _loss(lambda L: L.HingeLoss(), (4, 3), ("sign", (4, 3))),
    "squared_hinge": _loss(lambda L: L.SquaredHingeLoss(margin=0.5), (4, 3),
                           ("sign", (4, 3))),
    "logistic_signed": _loss(lambda L: L.LogisticLoss(), (4, 3),
                             ("sign", (4, 3))),
    "logistic_binary": _loss(
        lambda L: L.LogisticLoss(label_format="binary"), (4, 3),
        ("bin", (4, 3))),
    "triplet": _loss(lambda L: L.TripletLoss(margin=0.3), (4, 5), (4, 5),
                     (4, 5)),
    "poisson_nll": _loss(lambda L: L.PoissonNLLLoss(), (4, 3),
                         ("count", (4, 3))),
    "poisson_nll_full_not_logits": _loss(
        lambda L: L.PoissonNLLLoss(from_logits=False, compute_full=True),
        ("pos", (4, 3)), ("count", (4, 3))),
    "cosine_embedding": _loss(lambda L: L.CosineEmbeddingLoss(margin=0.1),
                              (4, 5), (4, 5), ("sign", (4,))),
}


def _loss_inputs(specs, seed):
    rng = np.random.RandomState(seed)
    out = []
    for s in specs:
        if s is None:
            out.append(None)
            continue
        kind, shape = (s[0], s[-1]) if isinstance(s[0], str) else ("n", s)
        if kind == "ids":
            v = rng.randint(0, s[1], shape)
        elif kind == "bin":
            v = rng.randint(0, 2, shape)
        elif kind == "sign":
            v = rng.randint(0, 2, shape) * 2 - 1
        elif kind == "prob":
            v = rng.uniform(0.05, 1, shape)
            v = v / v.sum(axis=-1, keepdims=True)
        elif kind == "pos":
            v = rng.uniform(0.2, 2, shape)
        elif kind == "count":
            v = rng.randint(0, 5, shape)
        else:
            v = rng.randn(*shape)
        out.append(v.astype(np.float32))
    return out


def _run_loss(pkg, make, xs, hybrid=False):
    blk = make(pkg.gluon.loss)
    if hybrid:
        blk.hybridize()
    nds = [_arr(pkg, x) if x is not None else None for x in xs]
    nds[0].attach_grad()
    with pkg.autograd.record():
        out = blk(*nds)
    out.backward()
    return {"loss": out.asnumpy(), "dpred": nds[0].grad.asnumpy()}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference(name):
    make, specs = LOSSES[name]
    xs = _loss_inputs(specs, sorted(LOSSES).index(name))
    want = _run_loss(jx, make, xs)
    got = _run_loss(tx, make, xs)
    _compare(got, want)
    hyb = _run_loss(tx, make, xs, hybrid=True)
    for k in got:
        assert np.array_equal(hyb[k], got[k]), k


# ---------------------------------------------------------------------------
# Block machinery
# ---------------------------------------------------------------------------

def _nested(pkg):
    nn = pkg.gluon.nn

    class Net(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.body = nn.HybridSequential(prefix="")
                self.body.add(nn.Dense(4), nn.Dense(4))
                self.head = nn.Dense(2)
                self.extra = nn.HybridSequential()
                with self.extra.name_scope():
                    self.extra.add(nn.BatchNorm(), nn.Dense(3))

        def hybrid_forward(self, F, x):
            return self.head(self.body(x)) + self.extra(x).sum()

    return Net(prefix="net_")


def test_names_match_reference():
    """Per-parent counters for children, a ``prefix=""`` container that
    leaves its parent's scope current, and structural names."""
    nets = {k: _nested(p) for k, p in PKGS.items()}
    assert list(nets["torch"].collect_params().keys()) == \
        list(nets["jax"].collect_params().keys())
    assert list(nets["torch"]._collect_params_with_prefix()) == \
        list(nets["jax"]._collect_params_with_prefix())
    assert list(nets["torch"].collect_params("net_dense.*_weight")) == \
        list(nets["jax"].collect_params("net_dense.*_weight"))


def test_deferred_init_and_hooks():
    nn = tx.gluon.nn
    net = nn.Dense(3, prefix="d_")
    net.initialize(ctx=tx.cpu())
    with pytest.raises(tx.gluon.parameter.DeferredInitializationError):
        net.weight.data()
    seen = []
    h = net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
    net(_arr(tx, np.ones((2, 5), np.float32)))
    assert net.weight.shape == (3, 5) and seen == [(2, 3)]
    h.detach()
    net.hybridize()
    net(_arr(tx, np.ones((2, 5), np.float32)))
    assert seen == [(2, 3)]


def _zoo(pkg):
    return pkg.gluon.model_zoo.vision.resnet18_v1(classes=10, prefix="r_")


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.BatchNorm(),
                nn.Dense(4))
    return net


def test_params_file_carries_both_ways(tmp_path):
    """The JAX package's `save_parameters` blob loads in the port (and
    the port's in the JAX package), BatchNorm's statistics included; the
    forwards then agree."""
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    jnet, tnet = _mlp(jx), _mlp(tx)
    _init(jx, jnet)
    jnet(_arr(jx, x))
    _set(jx, jnet, _values(dict(jnet.collect_params().items()), 2))
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet.load_parameters(str(tmp_path / "j.params"), ctx=tx.cpu())
    want = jnet(_arr(jx, x)).asnumpy()
    np.testing.assert_allclose(tnet(_arr(tx, x)).asnumpy(), want,
                               rtol=TOL, atol=TOL)
    for p in tnet.collect_params().values():
        p.set_data(p.data() * 0.5)
    tnet.save_parameters(str(tmp_path / "t.params"))
    jnet.load_parameters(str(tmp_path / "t.params"))
    assert list(jnet.collect_params()) == list(tnet.collect_params())
    for (n, jp), tp in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        assert np.array_equal(jp.data().asnumpy(), tp.data().asnumpy()), n
    tnet.collect_params().save(str(tmp_path / "d.params"), "m_")
    back = _mlp(tx)
    back.collect_params().load(str(tmp_path / "d.params"), ctx=tx.cpu(),
                               restore_prefix="m_")
    for p, q in zip(back.collect_params().values(),
                    tnet.collect_params().values()):
        assert np.array_equal(p.data().asnumpy(), q.data().asnumpy())


def _export(pkg, net, path):
    from mxnet_tpu.symbol.symbol import _NAMES as jnames
    from mxnet_tpu_torch.symbol.symbol import _NAMES as tnames
    (jnames if pkg is jx else tnames).counters.clear()
    net.export(path)
    with open(f"{path}-symbol.json") as f:
        return f.read()


def test_export_serves_in_both_predictors(tmp_path, monkeypatch):
    """`export` gives the JAX package's JSON for the same net; the
    exported graph and `.params` serve through both packages' `Predictor`
    within 1e-4 of the Gluon forward, and the graph passes report alike
    (`fold_bn` folds every BatchNorm into its Convolution)."""
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    jnet, tnet = _zoo(jx), _zoo(tx)
    _init(jx, jnet)
    jnet(_arr(jx, x))
    vals = _values(dict(jnet.collect_params().items()), 9)
    _set(jx, jnet, vals)
    _init(tx, tnet)
    tnet(_arr(tx, x))
    _set(tx, tnet, vals)
    want_json = _export(jx, jnet, str(tmp_path / "j"))
    got_json = _export(tx, tnet, str(tmp_path / "t"))
    assert got_json == want_json
    gluon_out = tnet(_arr(tx, x)).asnumpy()
    with open(str(tmp_path / "t-0000.params"), "rb") as f:
        blob = f.read()
    tpred = tx.Predictor(got_json, blob, {"data": x.shape}, ctx=tx.cpu())
    tpred.forward(data=x)
    jpred = jx.Predictor(got_json, blob, {"data": x.shape})
    jpred.forward(data=x)
    scale = np.abs(gluon_out).max()
    for out in (tpred.get_output(0).asnumpy(), jpred.get_output(0).asnumpy()):
        np.testing.assert_allclose(out, gluon_out, rtol=1e-4,
                                   atol=1e-4 * scale)
    from mxnet_tpu import graph_opt as jopt
    from mxnet_tpu_torch import graph_opt as topt
    import torch
    shapes = {"data": x.shape}
    ref = jopt.optimize(jx.sym.load_json(got_json), train=False,
                        shapes=shapes)
    got = topt.optimize(tx.sym.load_json(got_json), shapes=shapes,
                        device=torch.device("cpu"))

    def reports(res):
        return [(r.name, r.nodes_before, r.nodes_after, r.rewrites,
                 r.parity, r.details) for r in res.reports]
    assert reports(got) == reports(ref)
    assert {r.name: r.rewrites for r in got.reports}["fold_bn"] == 20


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,params,fused", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, "1"),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, "0"),
    ("sgd", {"learning_rate": 0.2, "clip_gradient": 0.05}, "1"),
    ("adam", {"learning_rate": 0.01, "wd": 1e-2}, "1"),
])
def test_trainer_matches_reference(opt, params, fused, monkeypatch):
    """Three steps with lr_mult/wd_mult set on two parameters: weights,
    moving statistics and the loss within 1e-5 (the port's multi-tensor
    update, or with ``MXTPU_FUSED_STEP=0`` its per-parameter one)."""
    monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
    rng = np.random.RandomState(6)
    xs = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 4, (6,)).astype(np.float32) for _ in range(3)]
    res = {}
    for k, pkg in PKGS.items():
        net = _mlp(pkg)
        _init(pkg, net)
        net(_arr(pkg, xs[0]))
        if k == "jax":
            vals = _values(dict(net.collect_params().items()), 7)
        _set(pkg, net, vals)
        cp = net.collect_params()
        cp["m_dense0_weight"].lr_mult = 0.5
        cp["m_dense1_bias"].wd_mult = 0.0
        tr = pkg.gluon.Trainer(cp, opt, dict(params))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for x, y in zip(xs, ys):
            with pkg.autograd.record():
                loss = loss_fn(net(_arr(pkg, x)), _arr(pkg, y))
            loss.backward()
            tr.step(6)
            losses.append(loss.asnumpy())
        res[k] = {n: p.data().asnumpy() for n, p in cp.items()}
        res[k]["loss"] = np.stack(losses)
    _compare(res["torch"], res["jax"])


def test_trainer_guards_and_states(tmp_path):
    net = _mlp(tx)
    _init(tx, net)
    x = _arr(tx, np.ones((2, 5), np.float32))
    tr = tx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    with pytest.raises(tx.MXNetError, match="has not been updated"):
        net(x)
        tr.step(2)
    with tx.autograd.record():
        y = net(x).sum()
    y.backward()
    tr.step(2)
    with pytest.raises(tx.MXNetError, match="has not been updated"):
        tr.step(2)
    before = {n: p.data().asnumpy() for n, p in
              net.collect_params().items()}
    tr.step(2, ignore_stale_grad=True)
    for n, p in net.collect_params().items():
        assert np.array_equal(p.data().asnumpy(), before[n])
    assert tr.learning_rate == 0.1
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05
    tr.save_states(str(tmp_path / "s"))
    tr2 = tx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    tr2.load_states(str(tmp_path / "s"))
    assert sorted(tr2._updater.states) == sorted(tr._updater.states)
    for k, s in tr._updater.states.items():
        assert np.array_equal(tr2._updater.states[k].asnumpy(),
                              s.asnumpy())


def test_trainer_refuses_a_store():
    # (the name is kept from the refusal this test held before the dist
    # stores came.)  Replicas on several contexts reduce through the local
    # store; a dist store is created on one context too: one process is a
    # one-worker store, and the steps equal the JAX package's Trainer over
    # its own dist_sync store on the same inputs
    net = tx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=[tx.cpu(0), tx.cpu(1)])
    tr = tx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tr.allreduce_grads()
    assert tr._kvstore is not None and tr._kvstore.type == "device"
    rs = np.random.RandomState(4)
    w = rs.randn(2, 3).astype(np.float32)
    xs = [rs.randn(4, 3).astype(np.float32) for _ in range(3)]
    for update_on_kvstore in (None, True):
        _dist_trainer_steps(update_on_kvstore, w, xs)


def _dist_trainer_steps(update_on_kvstore, w, xs):
    res = {}
    for k, pkg in (("torch", tx), ("jax", jx)):
        d = pkg.gluon.nn.Dense(2, in_units=3, use_bias=False,
                               prefix="dist_")
        _init(pkg, d)
        d.weight.set_data(_arr(pkg, w))
        tr = pkg.gluon.Trainer(d.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore="dist_sync",
                               update_on_kvstore=update_on_kvstore)
        for x in xs:
            with pkg.autograd.record():
                loss = (d(_arr(pkg, x)) ** 2).sum()
            loss.backward()
            tr.step(4)
        assert tr._kvstore is not None
        assert (tr._kvstore.type, tr._kvstore.rank,
                tr._kvstore.num_workers) == ("dist_sync", 0, 1)
        res[k] = {"w": d.weight.data().asnumpy()}
    _compare(res["torch"], res["jax"])


# ---------------------------------------------------------------------------
# utils, model zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("even", [True, False])
def test_split_and_load_matches_reference(even):
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    n = 7 if even else 3
    got = tx.gluon.utils.split_and_load(x, [tx.cpu(i) for i in range(n)],
                                        even_split=even)
    want = jx.gluon.utils.split_and_load(x, [jx.cpu(i) for i in range(n)],
                                         even_split=even)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(tx.MXNetError):
        tx.gluon.utils.split_data(_arr(tx, x), 2)


def test_clip_global_norm_matches_reference():
    rng = np.random.RandomState(8)
    arrays = [rng.randn(3, 4).astype(np.float32) * 3,
              rng.randn(5).astype(np.float32)]
    res = {}
    for k, pkg in PKGS.items():
        nds = [_arr(pkg, a) for a in arrays]
        norm = pkg.gluon.utils.clip_global_norm(nds, 1.5)
        res[k] = (norm, [a.asnumpy() for a in nds])
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], rtol=1e-6)
    for g, w in zip(res["torch"][1], res["jax"][1]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_check_sha1(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"abc")
    h = "a9993e364706816aba3e25717850c26c9cd0d89d"
    assert tx.gluon.utils.check_sha1(str(p), h)
    assert not tx.gluon.utils.check_sha1(str(p), "0" * 40)


def test_model_zoo_names_and_pretrained():
    vision = tx.gluon.model_zoo.vision
    names = [f"resnet{n}_v{v}" for v in (1, 2) for n in (18, 34, 50, 101,
                                                        152)]
    for n in names:
        assert callable(getattr(vision, n))
    net = vision.get_model("ResNet50_v2", classes=7, prefix="z_")
    ref = jx.gluon.model_zoo.vision.get_model("resnet50_v2", classes=7,
                                              prefix="z_")
    assert list(net.collect_params()) == list(ref.collect_params())
    with pytest.raises(tx.MXNetError, match="pretrained"):
        vision.resnet18_v1(pretrained=True)
    with pytest.raises(ValueError):
        vision.get_model("vgg17")


# ---------------------------------------------------------------------------
# CTCLoss, hybridized training on the CPU, get_symbol
# ---------------------------------------------------------------------------

def _ctc_batch(layout, label_layout, seed):
    """Activations in ``layout`` (T = 8, N = 4, 5 classes with the blank
    last), -1-padded labels in ``label_layout`` (sample 0's longer than
    its input allows), input and label lengths, and sample weights."""
    rng = np.random.RandomState(seed)
    T, N, C, L = 8, 4, 5, 4
    pred = rng.randn(T, N, C).astype(np.float32)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    lens = np.array([4, 2, 0, 3], np.float32)
    label = np.full((N, L), -1, np.float32)
    for n, k in enumerate(lens.astype(int)):
        label[n, :k] = rng.randint(0, C - 1, k)
    if label_layout == "TN":
        label = label.T.copy()
    pred_lens = np.array([3, 8, 6, 7], np.float32)
    weight = rng.uniform(0.5, 2, (N,)).astype(np.float32)
    return pred, label, pred_lens, lens, weight


@pytest.mark.parametrize("layout,label_layout,inputs,weight", [
    ("NTC", "NT", "labels", None), ("TNC", "NT", "pred", None),
    ("NTC", "TN", "both", None), ("TNC", "TN", "both", 0.5),
    ("NTC", "NT", "sample_weight", None)])
def test_ctc_loss_block_matches_reference(layout, label_layout, inputs,
                                          weight):
    """`gluon.loss.CTCLoss` against the JAX package's at 1e-5 (the loss
    and the prediction's gradient): layouts NTC/TNC, labels NT/TN, padded
    labels alone, with the prediction lengths, with both lengths, with a
    weight and with sample weights."""
    pred, label, pred_lens, lens, sw = _ctc_batch(layout, label_layout, 3)
    args = {"labels": [pred, label],
            "pred": [pred, label, pred_lens],
            "both": [pred, label, pred_lens, lens],
            "sample_weight": [pred, label, None, None, sw]}[inputs]
    got = {}
    for pkg in (jx, tx):
        blk = pkg.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                     weight=weight)
        nds = [_arr(pkg, a) if a is not None else None for a in args]
        nds[0].attach_grad()
        with pkg.autograd.record():
            out = blk(*nds)
        out.backward()
        got[pkg] = (out.asnumpy(), nds[0].grad.asnumpy())
    for g, w in zip(got[tx], got[jx]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_ctc_loss_block_needs_pred_lengths_with_label_lengths():
    pred, label, _, lens, _ = _ctc_batch("NTC", "NT", 0)
    for pkg in (jx, tx):
        blk = pkg.gluon.loss.CTCLoss()
        with pytest.raises(ValueError, match="pred_lengths"):
            blk(_arr(pkg, pred), _arr(pkg, label), None, _arr(pkg, lens))


def _conv_bn_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="h_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Dense(3))
    return net


@pytest.mark.parametrize("compile_env", ["1", "0"])
def test_hybridized_training_on_cpu_stays_eager(compile_env, monkeypatch):
    """On the CPU (and with MXTPU_GRAPH_COMPILE=0) a hybridized block under
    `autograd.record` in train mode runs eagerly and captures nothing:
    its loss, gradients and moving statistics equal the imperative net's
    bit for bit over two steps, and both match the JAX package's within
    1e-5."""
    monkeypatch.setenv("MXTPU_GRAPH_COMPILE", compile_env)
    rng = np.random.RandomState(11)
    xs = [rng.randn(4, 2, 5, 5).astype(np.float32) for _ in range(2)]
    ys = [rng.randint(0, 3, 4).astype(np.float32) for _ in range(2)]
    runs = {}
    for name, pkg, hybrid in (("imperative", tx, False),
                              ("hybridized", tx, True),
                              ("reference", jx, True)):
        net = _conv_bn_net(pkg)
        _init(pkg, net)
        net(_arr(pkg, xs[0]))
        _set(pkg, net, _values(net.collect_params(), 12))
        if hybrid:
            net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        rec = []
        for x, y in zip(xs, ys):
            with pkg.autograd.record():
                loss = loss_fn(net(_arr(pkg, x)), _arr(pkg, y))
            loss.backward()
            rec.append(loss.asnumpy())
            rec += [p.grad().asnumpy() for p in
                    net.collect_params().values() if p.grad_req != "null"]
            trainer.step(4)
        rec += [p.data().asnumpy() for p in net.collect_params().values()]
        runs[name] = rec
        if pkg is tx and hybrid:
            assert net._cached_op.num_programs == 0
            assert net._cached_op.num_train_programs == 0
    for h, i in zip(runs["hybridized"], runs["imperative"]):
        assert np.array_equal(h, i)
    for t, j in zip(runs["imperative"], runs["reference"]):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_get_symbol_raises_like_reference():
    for pkg in (jx, tx):
        x = _arr(pkg, np.ones((2, 2), np.float32))
        with pytest.raises(pkg.MXNetError):
            pkg.autograd.get_symbol(x)
    assert issubclass(tx.autograd.NotImplementedForSymbolError,
                      tx.MXNetError)


class _StandInGraph:
    """A CUDA graph's contract on the CPU: ``fn`` runs at capture and again
    at every replay, its new values copied into the first outputs (which
    stay the same tensors, as a graph's static outputs do).  A capture
    computes nothing, so the tensors in ``kept`` get their values back
    after it (BatchNorm's moving statistics)."""
    kept = []

    def __init__(self, fn, device, generator=None, pool=None):
        self._fn = fn
        saved = [t.clone() for t in self.kept]
        self._first = fn()
        with torch.no_grad():
            for t, v in zip(self.kept, saved):
                t.copy_(v)
        self.outputs = self._first

    def replay(self):
        new = self._fn()
        with torch.no_grad():
            for dst, src in zip(self.outputs, new):
                if dst is not None:
                    dst.copy_(src)
        if isinstance(self._first, list):
            self._first[:] = new
        return self.outputs


def _stand_in_capture(monkeypatch):
    """`CachedOp` captures on the CPU, through `_StandInGraph`."""
    from mxnet_tpu_torch import cached_op
    monkeypatch.setattr(cached_op, "_captures", lambda device: True)
    monkeypatch.setattr(cached_op, "CapturedGraph", _StandInGraph)
    monkeypatch.setattr(cached_op, "warm_up", lambda fn, device: fn())
    monkeypatch.setattr(cached_op.torch.cuda, "graph_pool_handle",
                        lambda: None)


def _keep_moving_stats(monkeypatch, net):
    monkeypatch.setattr(_StandInGraph, "kept", [
        p.data().data for p in net.collect_params().values()
        if p.grad_req == "null"])


def test_training_capture_replays_one_tape_node(monkeypatch):
    """The recorded train-mode path of `CachedOp` with a stand-in for the
    CUDA graph (the card alone captures): the first call runs eagerly, the
    second captures, later calls replay as one node of the tape; loss,
    gradients and BatchNorm's statistics equal the imperative net's over
    three steps.  A call while an earlier one's backward is pending takes
    a program of its own; a backward after its program ran again raises."""
    _stand_in_capture(monkeypatch)
    rng = np.random.RandomState(13)
    xs = [rng.randn(4, 2, 5, 5).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 3, 4).astype(np.float32) for _ in range(3)]
    runs = {}
    for hybrid in (False, True):
        net = _conv_bn_net(tx)
        _init(tx, net)
        net(_arr(tx, xs[0]))
        _set(tx, net, _values(net.collect_params(), 12))
        if hybrid:
            net.hybridize()
            _keep_moving_stats(monkeypatch, net)
        trainer = tx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        loss_fn = tx.gluon.loss.SoftmaxCrossEntropyLoss()
        rec = []
        for x, y in zip(xs, ys):
            with tx.autograd.record():
                loss = loss_fn(net(_arr(tx, x)), _arr(tx, y))
            loss.backward()
            trainer.step(4)
            rec.append(loss.asnumpy())
            rec += [p.data().asnumpy() for p in
                    net.collect_params().values()]
        runs[hybrid] = (rec, net)
    for h, i in zip(runs[True][0], runs[False][0]):
        np.testing.assert_allclose(h, i, rtol=1e-6, atol=1e-7)
    net = runs[True][1]
    assert net._cached_op.num_train_programs == 1
    x = _arr(tx, xs[0])
    with tx.autograd.record():
        first = net(x)
        second = net(x)
    assert net._cached_op.num_train_programs == 2
    first.backward()
    second.backward()
    with tx.autograd.record():
        held = net(x)
    held.backward(retain_graph=True)
    with tx.autograd.record():
        net(x).backward()
    assert net._cached_op.num_train_programs == 2
    with pytest.raises(tx.MXNetError, match="run again"):
        held.backward()


def test_captured_call_refuses_create_graph(monkeypatch):
    """A ``create_graph`` gradient through a captured training call raises
    (the captured backward is not differentiable; the JAX package raises
    for its CachedOp node), while the same net's eager first call and the
    imperative net give second-order gradients."""
    _stand_in_capture(monkeypatch)
    x = _arr(tx, np.random.RandomState(5).randn(4, 2, 5, 5)
             .astype(np.float32))
    penalties = []
    for hybrid in (False, True):
        net = _conv_bn_net(tx)
        _init(tx, net)
        net(x)
        _set(tx, net, _values(net.collect_params(), 12))
        if hybrid:
            net.hybridize()
            _keep_moving_stats(monkeypatch, net)
        w = net[0].weight.data()
        with tx.autograd.record():
            out = net(x)
            g, = tx.autograd.grad((out * out).sum(), [w], create_graph=True)
            penalty = (g * g).sum()
        penalty.backward()
        penalties.append(net[0].weight.grad().asnumpy())
    np.testing.assert_allclose(penalties[1], penalties[0], rtol=1e-6,
                               atol=1e-7)
    assert np.abs(penalties[1]).max() > 0
    for _ in range(2):
        with tx.autograd.record():
            out = net(x)
            loss = (out * out).sum()
            assert net._cached_op.num_train_programs == 1
            with pytest.raises(tx.MXNetError, match="higher-order"):
                tx.autograd.grad(loss, [w], create_graph=True)
        del out, loss
    with tx.autograd.record():
        net(x).sum().backward()


def test_training_programs_bounded_and_dropped_with_their_parameters(
        monkeypatch):
    """Calls made while earlier ones' backwards are pending capture up to
    `MAX_TRAIN_PROGRAMS` programs per signature and run eagerly past it,
    the gradients and moving statistics equal to the imperative net's;
    parameters rebound to new tensors drop every program."""
    from mxnet_tpu_torch import cached_op
    _stand_in_capture(monkeypatch)
    rng = np.random.RandomState(21)
    calls = 4
    xs = [_arr(tx, rng.randn(4, 2, 5, 5).astype(np.float32))
          for _ in range(calls)]
    runs = {}
    for hybrid in (False, True):
        net = _conv_bn_net(tx)
        _init(tx, net)
        net(xs[0])
        _set(tx, net, _values(net.collect_params(), 12))
        if hybrid:
            net.hybridize()
            _keep_moving_stats(monkeypatch, net)
        rec = []
        for _ in range(2):
            with tx.autograd.record():
                outs = [net(x) for x in xs]
                heads = [(o * o).sum() for o in outs]
            tx.autograd.backward(heads)
            rec += [o.asnumpy() for o in outs]
            rec += [p.grad().asnumpy() for p in
                    net.collect_params().values() if p.grad_req != "null"]
        rec += [p.data().asnumpy() for p in net.collect_params().values()]
        runs[hybrid] = (rec, net)
    for h, i in zip(runs[True][0], runs[False][0]):
        np.testing.assert_allclose(h, i, rtol=1e-6, atol=1e-6)
    op = runs[True][1]._cached_op
    assert op.num_train_programs == cached_op.MAX_TRAIN_PROGRAMS < calls
    net = runs[True][1]
    net(xs[0])
    assert op.num_programs == 1
    net.collect_params().reset_ctx(tx.cpu())
    _keep_moving_stats(monkeypatch, net)
    for want in (0, 1):
        with tx.autograd.record():
            loss = net(xs[0]).sum()
        loss.backward()
        assert op.num_train_programs == want
    assert op.num_programs == 0
