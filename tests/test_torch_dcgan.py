"""MXNet's DCGAN (`model_zoo.dcgan`, the reference's ``example/gan/dcgan.py``)
trained through the port's two ``mod.Module``s against the JAX package on
the CPU: a narrow network (ngf = ndf = 8, 64x64 images, batch 4) over 3
generator/discriminator iterations of the reference's loop, from the same
numpy weights, noise and images.  The JAX package has no DCGAN builder,
so this file builds its graph with `mxnet_tpu.sym`; the two graphs'
JSON must be the same.

Tolerance: after 3 Adam steps (lr 0.0002) every weight agrees within
``WEIGHT_TOL`` = 5e-6 (2.5 % of a step) and D's outputs within
``OUT_TOL`` = 1e-5, in float32 in both packages.  The port runs on
ATen's own CPU convolutions here, not oneDNN's: oneDNN's results move at
rounding level from one process to the next, and Adam's first steps,
about lr·sign(g), turn that into differences of lr on the elements whose
gradient is near 0 (8e-4 in some runs), where ATen's are the same
in every run.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.model_zoo import DCGAN, dcgan
from mxnet_tpu_torch.symbol import symbol as tsym

NGF = NDF = 8
BATCH, Z, NC, SIDE = 4, 100, 3, 64
STEPS = 3
WEIGHT_TOL = 5e-6
OUT_TOL = 1e-5


@pytest.fixture(autouse=True)
def aten_convolutions(monkeypatch):
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


@pytest.fixture(autouse=True)
def fresh_names():
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _jax_dcgan(ngf, ndf, nc, eps=1e-5 + 1e-12):
    """The reference's ``make_dcgan_sym`` written out with `mxnet_tpu.sym`."""
    sym = mx.sym
    rand = sym.Variable("rand")
    g1 = sym.Deconvolution(rand, name="g1", kernel=(4, 4),
                           num_filter=ngf * 8, no_bias=True)
    gbn1 = sym.BatchNorm(g1, name="gbn1", fix_gamma=True, eps=eps)
    gact1 = sym.Activation(gbn1, name="gact1", act_type="relu")
    g2 = sym.Deconvolution(gact1, name="g2", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf * 4, no_bias=True)
    gbn2 = sym.BatchNorm(g2, name="gbn2", fix_gamma=True, eps=eps)
    gact2 = sym.Activation(gbn2, name="gact2", act_type="relu")
    g3 = sym.Deconvolution(gact2, name="g3", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf * 2, no_bias=True)
    gbn3 = sym.BatchNorm(g3, name="gbn3", fix_gamma=True, eps=eps)
    gact3 = sym.Activation(gbn3, name="gact3", act_type="relu")
    g4 = sym.Deconvolution(gact3, name="g4", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf, no_bias=True)
    gbn4 = sym.BatchNorm(g4, name="gbn4", fix_gamma=True, eps=eps)
    gact4 = sym.Activation(gbn4, name="gact4", act_type="relu")
    g5 = sym.Deconvolution(gact4, name="g5", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=nc, no_bias=True)
    gout = sym.Activation(g5, name="gact5", act_type="tanh")

    data = sym.Variable("data")
    label = sym.Variable("label")
    d1 = sym.Convolution(data, name="d1", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf, no_bias=True)
    dact1 = sym.LeakyReLU(d1, name="dact1", act_type="leaky", slope=0.2)
    d2 = sym.Convolution(dact1, name="d2", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 2, no_bias=True)
    dbn2 = sym.BatchNorm(d2, name="dbn2", fix_gamma=True, eps=eps)
    dact2 = sym.LeakyReLU(dbn2, name="dact2", act_type="leaky", slope=0.2)
    d3 = sym.Convolution(dact2, name="d3", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 4, no_bias=True)
    dbn3 = sym.BatchNorm(d3, name="dbn3", fix_gamma=True, eps=eps)
    dact3 = sym.LeakyReLU(dbn3, name="dact3", act_type="leaky", slope=0.2)
    d4 = sym.Convolution(dact3, name="d4", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 8, no_bias=True)
    dbn4 = sym.BatchNorm(d4, name="dbn4", fix_gamma=True, eps=eps)
    dact4 = sym.LeakyReLU(dbn4, name="dact4", act_type="leaky", slope=0.2)
    d5 = sym.Convolution(dact4, name="d5", kernel=(4, 4), num_filter=1,
                         no_bias=True)
    d5 = sym.Flatten(d5)
    dloss = sym.LogisticRegressionOutput(data=d5, label=label, name="dloss")
    return gout, dloss


def _weights(sym, shapes, seed):
    """Normal(0.02) weights, gamma 1 and beta 0, from a numpy seed."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    out = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            out[name] = np.ones(shp, np.float32)
        elif name.endswith("_beta"):
            out[name] = np.zeros(shp, np.float32)
        else:
            out[name] = (rs.randn(*shp) * 0.02).astype(np.float32)
    return out


def _modules(pkg, symG, symD, wG, wD, ctx):
    opt = {"learning_rate": DCGAN["lr"], "wd": 0.0, "beta1": DCGAN["beta1"]}
    modG = pkg.mod.Module(symG, data_names=("rand",), label_names=None,
                          context=ctx)
    modG.bind(data_shapes=[("rand", (BATCH, Z, 1, 1))])
    modG.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                 for k, v in wG.items()})
    modG.init_optimizer(optimizer="adam", optimizer_params=opt)
    modD = pkg.mod.Module(symD, data_names=("data",),
                          label_names=("label",), context=ctx)
    modD.bind(data_shapes=[("data", (BATCH, NC, SIDE, SIDE))],
              label_shapes=[("label", (BATCH,))], inputs_need_grad=True)
    modD.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                 for k, v in wD.items()})
    modD.init_optimizer(optimizer="adam", optimizer_params=opt)
    return modG, modD


def _iteration(pkg, modG, modD, noise, real, ctx):
    """One iteration of the reference's loop: D on the fake batch (label
    0), its gradients kept; D on the real batch (label 1), the kept
    gradients added, one D update; G through D's input gradient on the
    fake batch (label 1).  Returns D's outputs on fake, real, and fake
    for G."""
    label = pkg.nd.zeros((BATCH,), ctx=ctx)
    modG.forward(pkg.io.DataBatch([noise], None), is_train=True)
    outG = modG.get_outputs()
    modD.forward(pkg.io.DataBatch(outG, [label]), is_train=True)
    modD.backward()
    out_fake = modD.get_outputs()[0].asnumpy()
    gradD = [g.copy() for g in modD._exec.grad_arrays if g is not None]
    label[:] = 1
    modD.forward(pkg.io.DataBatch([real], [label]), is_train=True)
    modD.backward()
    out_real = modD.get_outputs()[0].asnumpy()
    for gr, gf in zip([g for g in modD._exec.grad_arrays if g is not None],
                      gradD):
        gr += gf
    modD.update()
    modD.forward(pkg.io.DataBatch(outG, [label]), is_train=True)
    modD.backward()
    out_g = modD.get_outputs()[0].asnumpy()
    modG.backward(modD.get_input_grads())
    modG.update()
    return out_fake, out_real, out_g


def _train(pkg, symG, symD, ctx):
    shapesG = {"rand": (BATCH, Z, 1, 1)}
    shapesD = {"data": (BATCH, NC, SIDE, SIDE), "label": (BATCH,)}
    modG, modD = _modules(pkg, symG, symD, _weights(symG, shapesG, 1),
                          _weights(symD, shapesD, 2), ctx)
    rs = np.random.RandomState(3)
    outs = []
    for _ in range(STEPS):
        noise = pkg.nd.array(rs.randn(BATCH, Z, 1, 1).astype(np.float32),
                             ctx=ctx)
        real = pkg.nd.array(np.tanh(rs.randn(BATCH, NC, SIDE, SIDE))
                            .astype(np.float32), ctx=ctx)
        outs.append(_iteration(pkg, modG, modD, noise, real, ctx))
    weights = {**modG.get_params()[0], **modD.get_params()[0]}
    return outs, {k: v.asnumpy() for k, v in weights.items()}


def test_dcgan_graph_is_the_reference_graph():
    tg, td = dcgan(mt.sym, NGF, NDF, NC)
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    jg, jd = _jax_dcgan(NGF, NDF, NC)
    assert json.loads(tg.tojson()) == json.loads(jg.tojson())
    assert json.loads(td.tojson()) == json.loads(jd.tojson())
    _, out, _ = tg.infer_shape(rand=(BATCH, Z, 1, 1))
    assert out == [(BATCH, NC, SIDE, SIDE)]


def test_dcgan_trains_like_the_reference():
    tg, td = dcgan(mt.sym, NGF, NDF, NC)
    jg, jd = _jax_dcgan(NGF, NDF, NC)
    t_outs, t_w = _train(mt, tg, td, mt.cpu())
    j_outs, j_w = _train(mx, jg, jd, mx.cpu())
    for step, (t, j) in enumerate(zip(t_outs, j_outs)):
        for k in range(3):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=OUT_TOL,
                                       err_msg=f"iteration {step} out {k}")
    assert sorted(t_w) == sorted(j_w)
    for name in t_w:
        np.testing.assert_allclose(t_w[name], j_w[name], rtol=0,
                                   atol=WEIGHT_TOL, err_msg=name)
    # the weights moved: Adam's first steps are about lr each
    moved = max(np.abs(t_w[n] - v).max() for n, v in
                _weights(tg, {"rand": (BATCH, Z, 1, 1)}, 1).items())
    assert moved > DCGAN["lr"]
