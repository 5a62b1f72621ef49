"""The port's training slice on the CPU: a 2-layer BERT masked-LM graph
trained through `mxnet_tpu_torch.mod.Module` against the JAX package's
`Module` on the same graph JSON, weights and batch, and the pieces under
it (SoftmaxOutput's defined gradient, Dropout, the executor's grad_req,
`simple_bind`, the optimizers) against their JAX counterparts.

The encoder's attention is the `_fused_attention` op: Pallas in interpret
mode on the JAX side, the Hopper kernels' plain versions here."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import graph_opt as jgraph_opt
from mxnet_tpu import serialization as jser
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.registry import Attrs as JAttrs

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import graph_opt
from mxnet_tpu_torch.model_zoo import bert_mlm, random_params
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.registry import Attrs
from mxnet_tpu_torch.serialization import loads_ndarrays, params_from_numpy

CFG = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
           max_len=128, dropout=0.0)
B, L = 2, 128
DATA = [("data", (B, L)), ("positions", (1, L))]
LABEL = [("mlm_label", (B, L))]
SHAPES = dict(DATA + LABEL)
# the reference's attention-gradient tolerance (tests/test_pallas.py:101),
# relative to each gradient's largest magnitude
GRAD_TOL = 2e-3
SGD_TOL = 1e-4
OPT_TOL = 1e-6
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _batch(seed):
    """Token ids, positions, and labels holding the token at 15 % of the
    positions and -1 elsewhere (BERT's masked-LM loss)."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, CFG["vocab"], (B, L)).astype(np.float32)
    label = np.where(rng.rand(B, L) < 0.15, data, -1.0).astype(np.float32)
    return data, np.arange(L, dtype=np.float32)[None], label


def _worst(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def model():
    sym = bert_mlm(mx.sym, **CFG)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in SHAPES}, seed=0)
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in params.items()})
    return sym, params, blob


def _jax_module(sym, params):
    mod = mx.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=mx.cpu())
    mod.bind(DATA, LABEL)
    mod.init_params(arg_params={n: mx.nd.array(a) for n, a in params.items()})
    return mod


def _port_module(json_str, arg_params):
    mod = mt.mod.Module(mt.sym.load_json(json_str),
                        data_names=("data", "positions"),
                        label_names=("mlm_label",), context=mt.cpu())
    mod.bind(DATA, LABEL)
    mod.init_params(arg_params=arg_params)
    return mod


@pytest.fixture(scope="module")
def reference(model):
    """The JAX Module's outputs and gradients after one forward/backward,
    its weights after 3 SGD steps, and its training pass reports."""
    sym, params, _ = model
    mod = _jax_module(sym, params)
    batch = mx.io.DataBatch([mx.nd.array(a) for a in _batch(1)[:2]],
                            [mx.nd.array(_batch(1)[2])])
    mod.forward(batch, is_train=True)
    out = mod.get_outputs()[0].asnumpy()
    mod.backward()
    grads = {n: g.asnumpy() for n, g in mod._exec.grad_dict.items()}
    sgd = _jax_module(sym, params)
    sgd.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    for step in range(3):
        data, pos, label = _batch(10 + step)
        sgd.forward(mx.io.DataBatch([mx.nd.array(data), mx.nd.array(pos)],
                                    [mx.nd.array(label)]), is_train=True)
        sgd.backward()
        sgd.update()
    weights = {n: a.asnumpy() for n, a in sgd.get_params()[0].items()}
    _, reports = jgraph_opt.training_result(sym)
    return out, grads, weights, {r.name: r.rewrites for r in reports}


def _port_step(mod, seed):
    data, pos, label = _batch(seed)
    mod.forward(mt.io.DataBatch([data, pos], [label]), is_train=True)
    mod.backward()


def test_graph_json_is_the_same_in_both_packages(model):
    sym = model[0]
    assert bert_mlm(mt.sym, **CFG).tojson() == sym.tojson()
    ops = [n.op for n in mt.sym.load_json(sym.tojson())._nodes()
           if not n.is_var]
    assert ops.count("_fused_attention") == CFG["num_layers"]
    assert "batch_dot" not in ops and ops[-1] == "SoftmaxOutput"


@pytest.mark.parametrize("weights", ["blob", "numpy"])
def test_outputs_and_every_gradient_match_reference(model, reference,
                                                    weights):
    """(a): SoftmaxOutput's probabilities and one backward's gradient of
    every parameter, the tied `word_embed_weight` (Embedding + decoder)
    included."""
    sym, params, blob = model
    arg = ({k[4:]: v for k, v in loads_ndarrays(blob).items()}
           if weights == "blob" else params_from_numpy(params, mt.cpu()))
    mod = _port_module(sym.tojson(), arg)
    _port_step(mod, 1)
    ref_out, ref_grads = reference[0], reference[1]
    out = mod.get_outputs()[0].asnumpy()
    assert out.shape == (B * L, CFG["vocab"]) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref_out, rtol=GRAD_TOL, atol=GRAD_TOL)
    grads = {n: g.asnumpy() for n, g in mod._exec.grad_dict.items()}
    assert set(grads) == set(params) and set(params) <= set(ref_grads)
    assert "word_embed_weight" in grads and "mlm_decoder_bias" in grads
    # a key bias shifts all of a row's scores alike, which softmax ignores:
    # its gradient is zero in exact arithmetic and roundoff in both
    # packages, so it is held to the scale of the largest gradient instead
    scale = max(np.abs(g).max() for g in ref_grads.values())
    zero = [n for n in grads if n.endswith("_key_bias")]
    assert len(zero) == CFG["num_layers"]
    for n in zero:
        assert max(np.abs(grads[n]).max(), np.abs(ref_grads[n]).max()) < \
            1e-6 * scale, n
    worst = {n: _worst(grads[n], ref_grads[n]) for n in grads
             if n not in zero}
    assert max(worst.values()) < GRAD_TOL, sorted(worst.items(),
                                                  key=lambda kv: -kv[1])[:3]


def test_sgd_weights_after_three_steps_match_reference(model, reference):
    """(b): momentum 0.9, wd 1e-4, rescale_grad 1/batch from Module."""
    sym, params, _ = model
    mod = _port_module(sym.tojson(), params_from_numpy(params, mt.cpu()))
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    assert mod._optimizer.rescale_grad == 1.0 / B
    for step in range(3):
        _port_step(mod, 10 + step)
        mod.update()
    got = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    assert set(got) == set(reference[2])
    for n, want in reference[2].items():
        np.testing.assert_allclose(got[n], want, rtol=SGD_TOL, atol=SGD_TOL,
                                   err_msg=n)


def test_training_pass_reports_match_reference(model, reference):
    """(d): the JAX training pipeline rewrites nothing on this graph, and
    the port reports the same passes."""
    ref = reference[3]
    assert ref == {"eliminate": 0, "cse": 0, "dead_aux": 0}
    _, reports = graph_opt.training_result(mt.sym.load_json(
        model[0].tojson()))
    assert {r.name: r.rewrites for r in reports} == ref
    assert graph_opt.train_passes() == tuple(ref)


@pytest.mark.parametrize("unified", ["1", "0"])
def test_training_pass_list_follows_the_reference_switch(unified,
                                                         monkeypatch):
    """``MXTPU_UNIFIED_STEP`` picks the same pass list in both packages."""
    monkeypatch.setenv("MXTPU_UNIFIED_STEP", unified)
    assert graph_opt.train_passes() == jgraph_opt.train_passes()
    assert graph_opt.train_passes() == (
        graph_opt.TRAIN_PASSES_UNIFIED if unified == "1"
        else graph_opt.TRAIN_PASSES)


def test_loss_falls_under_adam(model):
    sym, params, _ = model
    mod = _port_module(sym.tojson(), params_from_numpy(params, mt.cpu()))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=dict(learning_rate=1e-3))
    data, pos, label = _batch(3)
    keep = label.reshape(-1) >= 0
    losses = []
    for _ in range(4):
        mod.forward(mt.io.DataBatch([data, pos], [label]), is_train=True)
        prob = mod.get_outputs()[0].asnumpy()
        losses.append(-np.log(prob[keep, label.reshape(-1)[keep]
                                   .astype(int)]).mean())
        mod.backward()
        mod.update()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# SoftmaxOutput's defined gradient
# ---------------------------------------------------------------------------

SMO_CASES = [
    dict(normalization="valid", use_ignore=True, ignore_label=-1),
    dict(normalization="valid"),
    dict(normalization="batch", use_ignore=True, ignore_label=2),
    dict(normalization="null", grad_scale=0.5),
    dict(normalization="null", use_ignore=True, smooth_alpha=0.1),
    dict(normalization="batch", out_grad=True),
    dict(normalization="batch", multi_output=True),
    dict(normalization="valid", multi_output=True, use_ignore=True,
         ignore_label=0),
    dict(soft_labels=True, grad_scale=2.0),
]


@pytest.mark.parametrize("attrs", SMO_CASES)
def test_softmax_output_backward_matches_jax_vjp(attrs):
    attrs = dict(attrs)
    soft = attrs.pop("soft_labels", False)
    multi = attrs.get("multi_output", False)
    rng = np.random.RandomState(11)
    shape = (4, 5, 3) if multi else (6, 5)
    data = rng.randn(*shape).astype(np.float32)
    if soft:
        label = rng.dirichlet(np.ones(shape[-1]), shape[0]).astype(
            np.float32)
    else:
        lab_shape = (shape[0],) + shape[2:] if multi else shape[:-1]
        label = rng.randint(-1, 5, lab_shape).astype(np.float32)
    head = rng.randn(*shape).astype(np.float32)
    out_ref, vjp = jax.vjp(
        lambda d: jnn._softmax_output(JAttrs(attrs), d, jnp.asarray(label)),
        jnp.asarray(data))
    (g_ref,) = vjp(jnp.asarray(head))
    x = torch.from_numpy(data).requires_grad_(True)
    out = tnn._softmax_output(Attrs(attrs), x, torch.from_numpy(label))
    out.backward(torch.from_numpy(head))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-6)


def test_softmax_output_label_shape_is_inferred():
    x = mt.sym.var("x")
    for multi, data, label in ((False, (6, 5), (6,)),
                               (True, (4, 5, 3), (4, 3))):
        out = mt.sym.SoftmaxOutput(x, multi_output=multi, name="sm")
        arg_shapes, out_shapes, _ = out.infer_shape(x=data)
        assert out.list_arguments() == ["x", "sm_label"]
        assert arg_shapes == [data, label] and out_shapes == [data]


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    """Held by statistics: the streams are not JAX's."""
    x = torch.ones(200, 500)
    gen = mt.random.generator("cpu")
    out = tnn._dropout(Attrs(p=p, __train=True), gen, x)
    kept = out != 0
    rate = kept.float().mean().item()
    # 100000 Bernoulli draws: the keep rate is within 5 standard errors
    assert abs(rate - (1 - p)) < 5 * (p * (1 - p) / x.numel()) ** 0.5
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / (1 - p), rtol=1e-6)
    # axes share one mask value along each listed axis
    shared = tnn._dropout(Attrs(p=p, axes=(1,), __train=True), gen, x)
    assert (shared == shared[:, :1]).all()


def test_dropout_is_the_identity_outside_training():
    x = torch.randn(8, 8)
    assert tnn._dropout(Attrs(p=0.5), None, x) is x
    assert tnn._dropout(Attrs(p=0.0, __train=True), None, x) is x
    always = tnn._dropout(Attrs(p=0.5, mode="always"),
                          mt.random.generator("cpu"), x)
    assert (always == 0).any()


def test_seed_makes_masks_repeat():
    x = torch.ones(64, 64)
    draws = []
    for _ in range(2):
        mt.random.seed(7)
        draws.append(tnn._dropout(Attrs(p=0.5, __train=True),
                                  mt.random.generator("cpu"), x))
    assert torch.equal(draws[0], draws[1])


# ---------------------------------------------------------------------------
# Executor, simple_bind, entry points
# ---------------------------------------------------------------------------

def _small_graph(pkg):
    x = pkg.sym.var("x")
    fc = pkg.sym.FullyConnected(x, num_hidden=3, name="fc")
    return pkg.sym.SoftmaxOutput(fc, normalization="batch", name="sm")


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_grad_req_matches_reference(req):
    rng = np.random.RandomState(12)
    vals = {"x": rng.randn(4, 6).astype(np.float32),
            "fc_weight": rng.randn(3, 6).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32),
            "sm_label": np.array([0, 2, 1, 2], np.float32)}
    grad_req = {"x": "null", "fc_weight": req, "fc_bias": "write",
                "sm_label": "null"}
    got = {}
    for name, pkg, ctx in (("jax", mx, mx.cpu()), ("port", mt, mt.cpu())):
        # gradient buffers start at ones, so 'add' and 'null' show
        ones = {n: np.ones(s, np.float32)
                for n, s in (("fc_weight", (3, 6)), ("fc_bias", (3,)))}
        exe = _small_graph(pkg).bind(
            ctx, args={n: pkg.nd.array(a, ctx=ctx) for n, a in vals.items()},
            args_grad={n: pkg.nd.array(a, ctx=ctx) for n, a in ones.items()},
            grad_req=grad_req)
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
        got[name] = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    assert set(got["port"]) == set(got["jax"])
    for n in got["jax"]:
        np.testing.assert_allclose(got["port"][n], got["jax"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    if req == "null":
        assert (got["port"]["fc_weight"] == 1.0).all()


def test_backward_after_an_inference_forward():
    """Allowed, as in the reference: the forward runs again to record the
    tape."""
    exe = _small_graph(mt).simple_bind(ctx=mt.cpu(), x=(4, 6))
    exe.arg_dict["x"].data.normal_()
    exe.arg_dict["fc_weight"].data.normal_()
    exe.forward(is_train=False, sm_label=np.array([0, 1, 2, 0]))
    exe.backward()
    g1 = exe.grad_dict["fc_weight"].asnumpy()
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_allclose(exe.grad_dict["fc_weight"].asnumpy(), g1,
                               rtol=1e-6, atol=1e-7)
    assert np.abs(g1).max() > 0


def test_simple_bind_allocates_args_grads_and_outputs():
    exe = _small_graph(mt).simple_bind(ctx=mt.cpu(), grad_req="write",
                                       x=(4, 6))
    assert exe.arg_names == ["x", "fc_weight", "fc_bias", "sm_label"]
    assert {n: a.shape for n, a in exe.arg_dict.items()} == {
        "x": (4, 6), "fc_weight": (3, 6), "fc_bias": (3,), "sm_label": (4,)}
    assert set(exe.grad_dict) == set(exe.arg_names)
    assert all(a.context == mt.cpu() for a in exe.grad_arrays)
    assert exe.forward()[0].shape == (4, 3)
    null = _small_graph(mt).simple_bind(ctx=mt.cpu(), grad_req="null",
                                        x=(4, 6))
    assert null.grad_dict == {} and null._grad_arg_names == []
    assert mt.sym.var("x").attr_dict() == {}
    assert _small_graph(mt).attr_dict()["fc"] == {"num_hidden": "3"}


@pytest.mark.parametrize("entry", ["Module", "simple_bind"])
def test_training_entry_points_without_ctx_need_cuda(entry, monkeypatch):
    """No training entry point runs on the CPU unless asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "Module": lambda: mt.mod.Module(_small_graph(mt), data_names=("x",),
                                        label_names=("sm_label",)),
        "simple_bind": lambda: _small_graph(mt).simple_bind(x=(4, 6)),
    }
    with pytest.raises(mt.MXNetError, match=f"{entry}: .*ctx=mx.cpu"):
        calls[entry]()


def test_module_prunes_grad_req_and_initializes(model):
    sym = mt.sym.load_json(model[0].tojson())
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=mt.cpu(),
                        fixed_param_names=["position_embed_weight"])
    mod.bind(DATA, LABEL)
    mod.init_params(mt.init.Normal(0.02))
    grads = set(mod._exec.grad_dict)
    assert not grads & {"data", "positions", "mlm_label",
                        "position_embed_weight"}
    args, _ = mod.get_params()
    assert set(args) == set(model[1])
    assert (args["layer0_ln1_gamma"].asnumpy() == 1).all()
    assert (args["layer0_ffn1_bias"].asnumpy() == 0).all()
    w = args["layer0_ffn1_weight"].asnumpy()
    assert abs(w.std() - 0.02) < 0.002 and abs(w.mean()) < 0.002


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_adam_update_op_matches_reference():
    rng = np.random.RandomState(13)
    w, g, m, v = (rng.randn(5, 7).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    attrs = dict(lr=0.01, wd=0.1, rescale_grad=0.5, clip_gradient=0.3,
                 beta1=0.8, beta2=0.95, epsilon=1e-6)
    jw, jm, jv = mx.nd.array(w), mx.nd.array(m), mx.nd.array(v)
    mx.nd.adam_update(jw, mx.nd.array(g), jm, jv, out=jw, **attrs)
    tw, tm, tv = (mt.nd.array(a, ctx=mt.cpu()) for a in (w, m, v))
    mt.nd.adam_update(tw, mt.nd.array(g, ctx=mt.cpu()), tm, tv, out=tw,
                      **attrs)
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=OPT_TOL, atol=OPT_TOL)


def test_adam_optimizer_matches_reference_over_three_steps():
    """Bias correction folded into lr over t = 1, 2, 3, and the wd_mult
    rule: no weight decay for `_bias`/`_beta` names."""
    rng = np.random.RandomState(14)
    names = {0: "fc_weight", 1: "fc_bias", 2: "ln_beta", 3: "ln_gamma"}
    w0 = {i: rng.randn(4, 3).astype(np.float32) for i in names}
    grads = [{i: rng.randn(4, 3).astype(np.float32) for i in names}
             for _ in range(3)]
    kw = dict(learning_rate=0.01, wd=0.1, beta1=0.9, beta2=0.99,
              epsilon=1e-7, rescale_grad=0.5, param_idx2name=names)
    jopt = mx.optimizer.create("adam", **kw)
    topt = mt.optimizer.create("adam", **kw)
    assert topt.wd_mult == jopt.wd_mult == {"fc_bias": 0.0, "ln_beta": 0.0}
    jup, tup = mx.optimizer.get_updater(jopt), mt.optimizer.get_updater(topt)
    jw = {i: mx.nd.array(a) for i, a in w0.items()}
    tw = {i: mt.nd.array(a, ctx=mt.cpu()) for i, a in w0.items()}
    for g in grads:
        for i in names:
            jup(i, mx.nd.array(g[i]), jw[i])
            tup(i, mt.nd.array(g[i], ctx=mt.cpu()), tw[i])
    assert topt._index_update_count == {i: 3 for i in names}
    for i in names:
        np.testing.assert_allclose(tw[i].asnumpy(), jw[i].asnumpy(),
                                   rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=names[i])


def test_sgd_mom_update_op_matches_reference():
    rng = np.random.RandomState(15)
    w, g, mom = (rng.randn(6).astype(np.float32) for _ in range(3))
    attrs = dict(lr=0.1, wd=0.01, momentum=0.9, rescale_grad=2.0)
    jw, jm = mx.nd.array(w), mx.nd.array(mom)
    mx.nd.sgd_mom_update(jw, mx.nd.array(g), jm, out=jw, **attrs)
    tw, tm = mt.nd.array(w, ctx=mt.cpu()), mt.nd.array(mom, ctx=mt.cpu())
    mt.nd.sgd_mom_update(tw, mt.nd.array(g, ctx=mt.cpu()), tm, out=tw,
                         **attrs)
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=OPT_TOL,
                               atol=OPT_TOL)
    np.testing.assert_allclose(tm.asnumpy(), jm.asnumpy(), rtol=OPT_TOL,
                               atol=OPT_TOL)
