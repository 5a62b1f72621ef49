"""The port's vision model zoo against the JAX package's, on the CPU.

Every name of the reference's ``_models`` registry builds, in both
packages, a net with the same parameter names (structural and full), and
``pretrained=True`` raises in the port as it does in the JAX package (no
weights are held or fetched).  Then each family is built in both packages
under one prefix, starts from the JAX package's Xavier weights carried
across by structural name, and runs the same seeded batch of 2 at the
smallest input its fixed pools allow, 10 classes: the predict-mode
forward within FWD_TOL of the largest output (the port's hybridized
forward equal to its imperative one bit for bit on the CPU); under
`autograd.record` in train mode the output and the
`SoftmaxCrossEntropyLoss` of each sample (within FWD_TOL, an output of
the whole net) and every gradient (within GRAD_TOL; Inception-v3's all
together by their norm, BY_NORM, and so its weights after the step); then one `Trainer`
step of SGD with momentum 0.9 and wd 1e-4, the new weights within
WEIGHT_TOL (each relative to its largest magnitude, or to ZERO_FLOOR of
the net's largest where that is more).  The
tolerances are `tests/test_torch_resnet.py`'s.  Dropout's masks are fed
to both packages from one numpy stream (the two packages' generators
differ), so the train-mode runs see the same masks.

The MobileNets and Inception-v3 take their gradient step with BatchNorm
on its moving statistics (frozen-BatchNorm fine-tuning), as ResNet-50 does
in `tests/test_torch_resnet.py`: in train mode at batch 2, a ReLU input
that a BatchNorm puts within fp32 rounding of zero routes a gradient
elsewhere, so no two fp32 computations agree.  Against the same step in
float64 (`tools/torch_zoo_grad_diag.py`), the worst fp32 gradient of
MobileNet v2 read 1.4e-1 in the port (one ReLU6 input of 273,280
flipped) and 1.4e-4 in the JAX package (none flipped); of Inception-v3,
1.4e-1 in the port and 8.9e-2 in the JAX package (56 and 81 flips;
frozen: 9.0e-4 and 1.4e-5).  Their train-mode forward and loss are held
all the same.

Inception-v3 runs whole at 299 x 299, in
`tests/test_torch_zoo_inception.py` (a file of its own, so that it runs
beside the others).  AlexNet, VGG-11, SqueezeNet 1.0
and 1.1, MobileNet 0.25 and MobileNet v2 0.25 run at their published
layer widths; VGG with BatchNorm and DenseNet run narrow through their
classes' own arguments (``VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
batch_norm=True)``, ``DenseNet(8, 4, [2, 2])``), as the full widths take
minutes on the CPU.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

FWD_TOL = 1e-4
GRAD_TOL = 2e-3
WEIGHT_TOL = 1e-4
#: a gradient (a weight after the step) is held relative to its largest
#: magnitude, or to ZERO_FLOOR of the net's largest where that is more.
#: Some gradients are zero in exact arithmetic, so their own magnitude is
#: rounding: a convolution bias that feeds a train-mode BatchNorm (VGG with
#: BatchNorm), and a BatchNorm scale whose channel reaches the loss only
#: through train-mode BatchNorms while its bias is 0 (DenseNet's stem:
#: 2.7e-6 against 0.90 at the largest, `tools/torch_zoo_grad_diag.py`).
#: Biases start at 0, so after one step theirs is as small as their
#: gradient
ZERO_FLOOR = 1e-3
#: nets whose gradients (and weights after the step) are held together,
#: by their norm, as phase 8 of chip_smoke.py holds ResNet-50's: even with
#: BatchNorm on its moving statistics, Inception-v3's 94 BatchNorm + ReLU
#: pairs leave some ReLU inputs within fp32 rounding of zero, which route a
#: gradient elsewhere in one package and not in the other: one BatchNorm
#: bias's gradient read 9.1e-4 of its largest magnitude from the JAX
#: package's, all gradients together 2.6e-6 of their norm
#: (`tools/torch_zoo_grad_diag.py`)
BY_NORM = {"inceptionv3"}
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
BATCH, CLASSES = 2, 10

#: name -> (constructor over a vision package, input side, whether the
#: gradient step normalizes by batch statistics)
FAMILIES = {
    "alexnet": (lambda v: v.alexnet(classes=CLASSES, prefix="m_"), 64, True),
    "vgg11": (lambda v: v.vgg11(classes=CLASSES, prefix="m_"), 32, True),
    "vgg_bn_narrow": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                      classes=CLASSES, batch_norm=True,
                                      prefix="m_"), 32, True),
    "densenet_narrow": (lambda v: v.DenseNet(8, 4, [2, 2], classes=CLASSES,
                                             prefix="m_"), 56, True),
    "squeezenet1.0": (lambda v: v.squeezenet1_0(classes=CLASSES,
                                                prefix="m_"), 224, True),
    "squeezenet1.1": (lambda v: v.squeezenet1_1(classes=CLASSES,
                                                prefix="m_"), 224, True),
    "inceptionv3": (lambda v: v.inception_v3(classes=CLASSES, prefix="m_"),
                    299, False),
    "mobilenet0.25": (lambda v: v.mobilenet0_25(classes=CLASSES,
                                                prefix="m_"), 64, False),
    "mobilenetv2_0.25": (lambda v: v.mobilenet_v2_0_25(classes=CLASSES,
                                                       prefix="m_"), 64,
                         False),
}


def _tarr(a):
    return tx.nd.array(a, ctx=tx.cpu(), dtype=a.dtype)


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of its largest magnitude"


@contextlib.contextmanager
def _fed_masks(seed=0):
    """Dropout in both packages multiplies by masks drawn, call by call,
    from one seeded numpy stream per package (kept with probability
    1 - p, scaled by 1 / (1 - p)); predict mode stays the identity."""
    streams = {"jax": np.random.RandomState(seed),
               "torch": np.random.RandomState(seed)}

    def mask(pkg, attrs, shape):
        p = attrs.get_float("p", 0.5)
        keep = streams[pkg].rand(*shape) >= p
        return keep.astype(np.float32) / (1.0 - p)

    def off(attrs):
        return not attrs.get_bool("__train", False) or \
            attrs.get_float("p", 0.5) == 0.0

    def jax_dropout(attrs, key, data):
        return data if off(attrs) else \
            data * jnp.asarray(mask("jax", attrs, data.shape))

    def torch_dropout(attrs, generator, data):
        return data if off(attrs) else \
            data * torch.from_numpy(mask("torch", attrs, tuple(data.shape)))

    jop, top = jreg.get_op("Dropout"), treg.get_op("Dropout")
    saved = jop.fn, top.fn
    jop.fn, top.fn = jax_dropout, torch_dropout
    try:
        yield
    finally:
        jop.fn, top.fn = saved


def _nets(name):
    make, side, _ = FAMILIES[name]
    rng = np.random.RandomState(0)
    x = rng.randn(BATCH, 3, side, side).astype(np.float32)
    jx.random.seed(0)
    jnet = make(jx.gluon.model_zoo.vision)
    jnet.initialize(jx.init.Xavier(magnitude=2))
    jnet(jx.nd.array(x))
    tnet = make(tx.gluon.model_zoo.vision)
    tnet.initialize(ctx=tx.cpu())
    tnet(_tarr(x))
    tparams = tnet._collect_params_with_prefix()
    jparams = jnet._collect_params_with_prefix()
    assert list(tparams) == list(jparams)
    for k, p in jparams.items():
        tparams[k].set_data(_tarr(p.data().asnumpy()))
    return jnet, tnet, x


def _norm_err(got, want):
    """|got - want| over |want|, all arrays of the dicts together."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _train_step(pkg, net, x, y, train=True):
    arr = _tarr if pkg is tx else jx.nd.array
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record(train_mode=train):
        out = net(arr(x))
        loss = loss_fn(out, arr(y))
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), loss.asnumpy(), grads


def check_family(name):
    """The family's predict-mode and train-mode forwards and one gradient
    step against the JAX package's (the module docstring)."""
    jnet, tnet, x = _nets(name)
    want = jnet(jx.nd.array(x)).asnumpy()
    got = tnet(_tarr(x)).asnumpy()
    assert got.shape == (BATCH, CLASSES)
    _close(got, want, FWD_TOL, "predict-mode forward")
    tnet.hybridize()
    assert np.array_equal(tnet(_tarr(x)).asnumpy(), got)

    y = np.random.RandomState(1).randint(0, CLASSES, BATCH) \
        .astype(np.float32)
    jtr = jx.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ttr = tx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    with _fed_masks():
        jout, jl, jg = _train_step(jx, jnet, x, y)
        tout, tl, tg = _train_step(tx, tnet, x, y)
    _close(tout, jout, FWD_TOL, "train-mode forward")
    np.testing.assert_allclose(tl, jl, rtol=FWD_TOL, atol=FWD_TOL)
    if not FAMILIES[name][2]:
        _, jl, jg = _train_step(jx, jnet, x, y, train=False)
        _, tl, tg = _train_step(tx, tnet, x, y, train=False)
        np.testing.assert_allclose(tl, jl, rtol=FWD_TOL, atol=FWD_TOL)
    assert sorted(tg) == sorted(jg)
    if name in BY_NORM:
        assert _norm_err(tg, jg) <= GRAD_TOL, \
            f"gradients: {_norm_err(tg, jg):.3g} of their norm"
    else:
        floor = ZERO_FLOOR * max(float(np.abs(g).max())
                                 for g in jg.values())
        for k in jg:
            scale = max(float(np.abs(jg[k]).max()), floor)
            err = float(np.abs(tg[k] - jg[k]).max()) / scale
            assert err <= GRAD_TOL, f"gradient {k}: {err:.3g} of {scale:.3g}"
    jtr.step(BATCH)
    ttr.step(BATCH)
    tw = {k: p.data().asnumpy()
          for k, p in tnet._collect_params_with_prefix().items()}
    jw = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    if name in BY_NORM:
        assert _norm_err(tw, jw) <= WEIGHT_TOL, \
            f"after the step: {_norm_err(tw, jw):.3g} of the weights' norm"
        return
    floor = ZERO_FLOOR * max(float(np.abs(w).max()) for w in jw.values())
    for k, w in jw.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(tw[k] - w).max()) / scale
        assert err <= WEIGHT_TOL, f"after the step, {k}: {err:.3g}"


@pytest.mark.parametrize("name", sorted(set(FAMILIES) - {"inceptionv3"}))
def test_family_matches_reference(name):
    check_family(name)


@pytest.mark.parametrize("name", sorted(
    jx.gluon.model_zoo.vision._models))
def test_registry_names_match_reference(name):
    vision = tx.gluon.model_zoo.vision
    assert name in vision._models
    net = vision.get_model(name.upper(), classes=7, prefix="z_")
    ref = jx.gluon.model_zoo.vision.get_model(name, classes=7, prefix="z_")
    assert list(net.collect_params()) == list(ref.collect_params())
    assert list(net._collect_params_with_prefix()) == \
        list(ref._collect_params_with_prefix())
    with pytest.raises(tx.MXNetError, match="pretrained"):
        vision.get_model(name, pretrained=True)


def test_mobilenet_relu6_is_clip():
    """MobileNet v2's RELU6 block: clip to [0, 6], its gradient passing at
    both bounds (exactly on 0 and 6), as in the JAX package."""
    xs = np.array([[-1.0, 0.0, 3.0, 6.0, 7.5]], np.float32)
    got = []
    for pkg, arr in ((jx, jx.nd.array), (tx, _tarr)):
        blk = pkg.gluon.model_zoo.vision.mobilenet.RELU6()
        x = arr(xs)
        x.attach_grad()
        with pkg.autograd.record():
            y = blk(x)
        y.backward()
        got.append((y.asnumpy(), x.grad.asnumpy()))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1], got[0][1])
    np.testing.assert_array_equal(got[1][1], [[0, 1, 1, 1, 0]])
