#!/usr/bin/env python3
"""Why `chip_smoke.py` phase 8 holds ResNet-50's training step as it does:
three measurements on one NVIDIA Hopper card, at phase 8's shapes
(resnet50_v1, 1000 classes, 224 x 224, batch 32, fp32 with TF32 off, the
phase's seeded weights and batches).

* ``grads``: one step's gradients against the same step in float64, in
  train mode, with cuDNN's default algorithms, its deterministic ones and
  with cuDNN off: the worst parameters (error relative to each
  gradient's largest magnitude) and the error of all gradients together
  (relative to their norm).
* ``stem``: with BatchNorm on its moving statistics, the stem
  convolution's weight gradient from the float64 step's own input and
  output gradient, reduced in fp32 and in float64, beside the error of
  that output gradient itself.
* ``lr``: the loss over phase 8's 12 steps at lr 0.05, momentum 0.9, wd
  1e-4, under three initializers and with a linear lr ramp over 6 or 12
  steps or a constant 0.0125, most of them twice.

Run from the repository root: ``python3 tools/torch_resnet_diag.py
[grads] [stem] [lr]`` (all three by default, about 40 s on an H100).
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402


def _batch():
    """Phase 8's first training batch (after its four serving requests)."""
    rng = np.random.RandomState(cs.SEED)
    for _ in range(4):
        rng.uniform(-1, 1, (cs.RESNET_BATCH, 3, 224, 224))
    gpu = mt.gpu(0)
    return [(mt.nd.array(rng.uniform(-1, 1, (32, 3, 224, 224)), ctx=gpu),
             mt.nd.array(rng.randint(0, 1000, (32,)), ctx=gpu))
            for _ in range(2)]


def _net(x, init=None):
    mt.random.seed(cs.SEED)
    net = cs.vision.resnet50_v1(classes=1000, prefix="resnet50_v1_")
    net.initialize(init or mt.init.Xavier(magnitude=2), ctx=mt.gpu(0))
    net(x)
    return net


def grads():
    (x, y), _ = _batch()
    exact = _net(x)
    exact.cast("float64")
    want = cs._gluon_grads(exact, x.astype("float64"), y.astype("float64"))
    del exact
    zero = cs._bias_feeds_bn(_net(x))
    for tag in ("default", "deterministic", "no-cudnn"):
        torch.backends.cudnn.deterministic = tag == "deterministic"
        torch.backends.cudnn.enabled = tag != "no-cudnn"
        got = cs._gluon_grads(_net(x), x, y)
        errs = sorted(((float((got[n] - w).abs().max())
                        / float(want[zero.get(n, n)].abs().max()), n)
                       for n, w in want.items()), reverse=True)
        num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
        den = sum(float((w ** 2).sum()) for w in want.values())
        print(tag, [(f"{e:.2e}", n) for e, n in errs[:4]],
              f"norm {(num / den) ** 0.5:.3e}", flush=True)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.enabled = True


def stem():
    from torch.nn.grad import conv2d_weight
    (x, y), _ = _batch()

    def run(net, xx, yy):
        kept = {}
        h = net.features[0].register_forward_hook(
            lambda b, a, o: kept.update(x=a[0].data.detach(), z=o.data))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        with mt.autograd.record(train_mode=False):
            out = net(xx)
            kept["z"].retain_grad()
            loss = loss_fn(out, yy)
        loss.backward()
        h.detach()
        return net.features[0].weight.grad().data, kept["x"], \
            kept["z"].grad

    g32, _, dz32 = run(_net(x), x, y)
    exact = _net(x)
    exact.cast("float64")
    g64, x64, dz64 = run(exact, x.astype("float64"), y.astype("float64"))
    w = g64.shape
    r64 = conv2d_weight(x64, w, dz64, stride=2, padding=3)
    r32 = conv2d_weight(x64.float(), w, dz64.float(), stride=2, padding=3)
    print(f"stem weight gradient {cs._rel(g32, g64):.3e}; its output "
          f"gradient {cs._rel(dz32, dz64):.3e}; cuDNN's wgrad in fp32 on "
          f"the float64 step's inputs {cs._rel(r32, r64):.3e}", flush=True)


def lr():
    data = _batch()
    runs = [("xavier_avg_m2", None, 0, 0.05), ("xavier_avg_m2", None, 0,
                                                0.05),
            ("uniform_default", mt.init.Uniform(), 0, 0.05),
            ("he_normal", mt.init.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2),
             0, 0.05),
            ("ramp12", None, 12, 0.05), ("ramp12", None, 12, 0.05),
            ("ramp12", None, 12, 0.05), ("ramp6", None, 6, 0.05),
            ("ramp6", None, 6, 0.05), ("lr0.0125", None, 0, 0.0125),
            ("lr0.0125", None, 0, 0.0125)]
    for tag, init, ramp, rate in runs:
        net = _net(data[0][0], init)
        opt = dict(cs.RESNET_SGD, learning_rate=rate)
        if ramp:
            opt["lr_scheduler"] = mt.lr_scheduler.FactorScheduler(
                step=10 ** 6, base_lr=rate, warmup_steps=ramp,
                warmup_begin_lr=0.0)
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", opt)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for k in range(12):
            x, y = data[k % 2]
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(32)
            losses.append(round(float(loss.mean().asscalar()), 3))
        print(tag, losses, f"first 2 {np.mean(losses[:2]):.3f}, last 2 "
              f"{np.mean(losses[-2:]):.3f}", flush=True)


if __name__ == "__main__":
    cs.phase_device()
    for name in sys.argv[1:] or ("grads", "stem", "lr"):
        {"grads": grads, "stem": stem, "lr": lr}[name]()
