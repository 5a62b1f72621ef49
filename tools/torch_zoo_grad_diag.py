#!/usr/bin/env python3
"""Why `tests/test_torch_zoo.py` holds some families' gradient step as it
does: on the CPU, at the test's own recipe (the JAX package's Xavier
weights from seed 0 carried into both packages, its seeded batch of 2 at
the family's input side, 10 classes, Dropout masks fed to both packages
from one numpy stream), one `SoftmaxCrossEntropyLoss` step's gradients of
the JAX package and of the port in fp32, each against the port's float64
copy of the same step, with BatchNorm on batch statistics ("train") and
on its moving statistics ("frozen").

For each family and mode it prints the three worst parameters by the
port's error and, beside each, the JAX package's error against float64
and the port's against the JAX package's (each relative to the float64
gradient's largest magnitude, or to 1e-3 of the net's largest where that
is more, as the test measures), then every gradient's error together,
relative to their norm, and the largest and smallest of the parameters'
largest gradient magnitudes.  In train mode it also counts, for each
package, the ReLU and ReLU6 inputs that fall on the other side of a
switching point (0, and 6 for ReLU6) than in float64, and the inputs'
largest error relative to their largest magnitude: one such flip routes
a gradient elsewhere.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/torch_zoo_grad_diag.py [family ...]`` (the test's family names;
``mobilenetv2_0.25`` and ``inceptionv3`` by default, about 3 minutes).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import mxnet_tpu as jx  # noqa: E402
import mxnet_tpu_torch as tx  # noqa: E402
import test_torch_zoo as zoo  # noqa: E402


def _grads(pkg, net, x, y, train, dtype="float32"):
    if pkg is tx:
        def arr(a):
            return tx.nd.array(a, ctx=tx.cpu(), dtype=dtype)
    else:
        arr = jx.nd.array
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with zoo._fed_masks():
        with pkg.autograd.record(train_mode=train):
            loss = loss_fn(net(arr(x)), arr(y))
    loss.backward()
    return {k: p.grad().asnumpy().astype(np.float64)
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _relu_inputs(pkg, net, x, dtype="float32"):
    """The input of every ReLU and ReLU6 block of one train-mode forward,
    with the mask of inputs a gradient passes."""
    seen = []

    def hook(blk, args, out):
        a = args[0].asnumpy().astype(np.float64)
        six = type(blk).__name__ == "RELU6"
        seen.append((a, (a >= 0) & (a <= 6) if six else a > 0))

    handles = []

    def attach(blk):
        if type(blk).__name__ == "RELU6" or \
                getattr(blk, "_act", None) == "relu":
            handles.append(blk.register_forward_hook(hook))
    net.apply(attach)
    arr = (lambda a: tx.nd.array(a, ctx=tx.cpu(), dtype=dtype)) \
        if pkg is tx else jx.nd.array
    with zoo._fed_masks():
        with pkg.autograd.record(train_mode=True):
            net(arr(x))
    for h in handles:
        h.detach()
    return seen


def _flips(name):
    jnet, tnet, x = zoo._nets(name)
    want = _relu_inputs(tx, _float64_copy(name, jnet, x), x, "float64")
    for label, pkg, net in (("port", tx, tnet), ("jax", jx, jnet)):
        got = _relu_inputs(pkg, net, x)
        flips = sum(int((g[1] != w[1]).sum()) for g, w in zip(got, want))
        err = max(float(np.abs(g[0] - w[0]).max() / np.abs(w[0]).max())
                  for g, w in zip(got, want))
        print(f"  {label}: {flips} ReLU inputs flipped of "
              f"{sum(w[0].size for w in want)}; their largest error "
              f"{err:.3g}", flush=True)


def _float64_copy(name, jnet, x):
    net = zoo.FAMILIES[name][0](tx.gluon.model_zoo.vision)
    net.initialize(ctx=tx.cpu())
    net(zoo._tarr(x))
    params = net._collect_params_with_prefix()
    for k, p in jnet._collect_params_with_prefix().items():
        params[k].set_data(zoo._tarr(p.data().asnumpy()))
    net.cast("float64")
    return net


def diagnose(name):
    for mode, train in (("train", True), ("frozen", False)):
        jnet, tnet, x = zoo._nets(name)
        exact = _float64_copy(name, jnet, x)
        y = np.random.RandomState(1).randint(0, zoo.CLASSES, zoo.BATCH) \
            .astype(np.float32)
        want = _grads(tx, exact, x, y, train, "float64")
        jg = _grads(jx, jnet, x, y, train)
        tg = _grads(tx, tnet, x, y, train)
        mags = {k: float(np.abs(w).max()) for k, w in want.items()}
        floor = zoo.ZERO_FLOOR * max(mags.values())

        def err(a, b, k):
            return float(np.abs(a[k] - b[k]).max()) / max(mags[k], floor)

        rows = sorted(((err(tg, want, k), err(jg, want, k),
                        err(tg, jg, k), k) for k in want), reverse=True)
        print(f"{name} {mode}:")
        for r in rows[:3]:
            print("  port-f64 %.3g  jax-f64 %.3g  port-jax %.3g  %s" % r)
        print("  all together: port-f64 %.3g  jax-f64 %.3g  port-jax %.3g"
              % (zoo._norm_err(tg, want), zoo._norm_err(jg, want),
                 zoo._norm_err(tg, jg)))
        print("  largest gradient magnitudes: max %.3g, min %.3g" %
              (max(mags.values()), min(mags.values())), flush=True)
        if train:
            _flips(name)


def main():
    for name in sys.argv[1:] or ["mobilenetv2_0.25", "inceptionv3"]:
        diagnose(name)


if __name__ == "__main__":
    main()
