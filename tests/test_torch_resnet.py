"""ResNet v1 through the port's Gluon against the JAX package's, on the CPU.

`resnet18_v1` and `resnet50_v1` (10 classes) start from the JAX package's
initial weights: ResNet-18's carried through the JAX package's
`save_parameters` file and the port's `load_parameters`, ResNet-50's as
numpy arrays by structural name (`serialization.params_from_numpy` +
``set_data``).  At [2, 3, 32, 32] the forward agrees within 1e-4 of the
largest output, hybridized too.  Then three `Trainer` steps of SGD with
momentum 0.9 and wd 1e-4 (the settings of
example/image-classification/train_cifar10.py) under
`SoftmaxCrossEntropyLoss`, each step taken from the reference's state
(weights, moving statistics, momenta): the loss within 1e-5, every
gradient within 2e-3 of its largest magnitude, the new weights and moving
statistics within 1e-4.

Where the training steps run, and why: in train mode, BatchNorm
normalizes over batch x height x width values, and at [2, 3, 32, 32]
stage 4 is 1 x 1, so it normalizes 2 values per channel.  There, both
packages' fp32 gradients of ResNet-18 lie 2e-2 and more from the same
step in float64, so no fp32 pair can agree within 2e-3.  ResNet-18 trains
in train mode at [2, 3, 64, 64] (8 values; both within 2e-5 of float64).
Random-init ResNet-50's train-mode gradients stay 2e-2 to 1e2 from
float64 in both packages at every CPU-sized batch tried, as fp32 rounding
flips ReLUs in the last stage; it takes its steps with BatchNorm on its
moving statistics (frozen-BatchNorm fine-tuning), where the step is well
conditioned.  Conv biases that feed a train-mode BatchNorm have a
gradient that is zero in exact arithmetic: none is in ResNet-18, and
ResNet-50's steps do not normalize by batch statistics.

A ReLU or max-pool input within fp32 rounding of its switching point
sends a gradient elsewhere in any two fp32 computations: with batch seed
1 at [2, 3, 64, 64], the stem convolution's gradient lies 1.4e-2 from the
float64 step in the reference and 9e-3 in the port (no max-pool argmax
differs there; ReLUs do).  Each step therefore first holds the
reference's fp32 gradients within 2e-3 of the same step in float64 (the
port's float64 copy of the net, from the same state), and fails as an
ill-conditioned batch otherwise; the batch seeds below are ones whose
three steps pass that check (ResNet-18 from 7, ResNet-50 from 2)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
from mxnet_tpu_torch.serialization import params_from_numpy

FWD_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-3
WEIGHT_TOL = 1e-4
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
BATCH, STEPS = 2, 3
#: depth -> (training image side, BatchNorm on batch statistics, the first
#: step's batch seed)
TRAIN = {18: (64, True, 7), 50: (32, False, 2)}


def _batch(side, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, 3, side, side).astype(np.float32),
            rng.randint(0, 10, (BATCH,)).astype(np.float32))


def _tarr(a):
    return tx.nd.array(a, ctx=tx.cpu())


def _float64_copy(depth, x):
    net = getattr(tx.gluon.model_zoo.vision, f"resnet{depth}_v1")(
        classes=10, prefix="r_")
    net.initialize(ctx=tx.cpu())
    net(_tarr(x))
    net.cast("float64")
    return net


def _nets(depth, tmp_path):
    jx.random.seed(0)
    jnet = getattr(jx.gluon.model_zoo.vision, f"resnet{depth}_v1")(
        classes=10, prefix="r_")
    jnet.initialize(jx.init.Xavier(magnitude=2))
    x0 = _batch(32, 0)[0]
    jnet(jx.nd.array(x0))
    tnet = getattr(tx.gluon.model_zoo.vision, f"resnet{depth}_v1")(
        classes=10, prefix="r_")
    if depth == 18:
        path = str(tmp_path / "r18.params")
        jnet.save_parameters(path)
        tnet.load_parameters(path, ctx=tx.cpu())
    else:
        tnet.initialize(ctx=tx.cpu())
        tnet(_tarr(x0))
        carried = params_from_numpy(
            {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()},
            tx.cpu())
        for k, p in tnet._collect_params_with_prefix().items():
            p.set_data(carried[k])
    return jnet, tnet


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of its largest magnitude"


def _sync(jnet, tnet):
    """The port net's weights and moving statistics set to the
    reference's."""
    tparams = tnet._collect_params_with_prefix()
    for k, p in jnet._collect_params_with_prefix().items():
        tparams[k].set_data(_tarr(p.data().asnumpy()))


def _sync_momenta(jtr, ttr):
    for i, s in jtr._updaters[0].states.items():
        with torch.no_grad():
            ttr._updater.states[i].data.copy_(
                torch.from_numpy(s.asnumpy().copy()))


def _grads(pkg, net, x, y, train, dtype="float32"):
    if pkg is tx:
        def arr(a):
            return tx.nd.array(a, ctx=tx.cpu(), dtype=dtype)
    else:
        arr = jx.nd.array
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record(train_mode=train):
        loss = loss_fn(net(arr(x)), arr(y))
    loss.backward()
    return loss.asnumpy(), {
        k: p.grad().asnumpy()
        for k, p in net._collect_params_with_prefix().items()
        if p.grad_req != "null"}


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_v1_forward_and_training_match_reference(depth, tmp_path):
    jnet, tnet = _nets(depth, tmp_path)
    x0 = _batch(32, 0)[0]
    want = jnet(jx.nd.array(x0)).asnumpy()
    got = tnet(_tarr(x0)).asnumpy()
    _close(got, want, FWD_TOL, "forward")
    tnet.hybridize()
    assert np.array_equal(tnet(_tarr(x0)).asnumpy(), got)

    side, train, seed = TRAIN[depth]
    exact = _float64_copy(depth, x0)
    jtr = jx.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ttr = tx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    jparams = jnet._collect_params_with_prefix()
    tparams = tnet._collect_params_with_prefix()
    assert list(tparams) == list(jparams)
    for i in range(STEPS):
        x, y = _batch(side, seed + i)
        _sync(jnet, exact)
        _, dg = _grads(tx, exact, x, y, train, "float64")
        if i:
            _sync(jnet, tnet)
            _sync_momenta(jtr, ttr)
        jl, jg = _grads(jx, jnet, x, y, train)
        for k in jg:
            _close(jg[k], dg[k], GRAD_TOL,
                   f"ill-conditioned batch: step {i}, the reference's {k} "
                   "against float64")
        tl, tg = _grads(tx, tnet, x, y, train)
        jtr.step(BATCH)
        ttr.step(BATCH)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert sorted(tg) == sorted(jg)
        for k in jg:
            _close(tg[k], jg[k], GRAD_TOL, f"step {i} grad {k}")
        for k, p in jparams.items():
            _close(tparams[k].data().asnumpy(), p.data().asnumpy(),
                   WEIGHT_TOL, f"step {i} {k}")
    means = [p.data().asnumpy() for k, p in tparams.items()
             if k.endswith("running_mean")]
    assert means and all((np.abs(m).max() > 0) == train for m in means)
