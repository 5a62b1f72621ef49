"""The port's fused ``RNN`` op (`mxnet_tpu_torch/ops/rnn_op.py`) against
the JAX package's on the CPU, from the same seeded numpy inputs: every
mode at 1 and 2 layers, one and two directions, with and without
``state_outputs``; its gradients through both packages' executors; its
dropout between layers by the statistics of the masks (the two packages'
random streams differ); and the op against its own step loop
(`rnn_forward_plain`), which ``chip_smoke.py`` holds it to on the card."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_op

# the reference's single-op tolerance (tests/test_torch_ops.py)
TOL = 1e-5
# gradients, relative to each one's largest magnitude (at least 1): the
# same 1e-5 after T <= 8 recurrent steps of float32 sums taken in another
# order (JAX's scan, PyTorch's RNN); measured at most 2.2e-7 here
GRAD_TOL = 1e-5
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
T, N, I, H = 6, 3, 5, 4


def _inputs(mode, layers, bidir, seed, t=T):
    rng = np.random.RandomState(seed)
    d = 2 if bidir else 1
    size = rnn_op.param_size(mode, layers, I, H, d)
    arrays = [rng.randn(t, N, I).astype(np.float32),
              (rng.uniform(-0.5, 0.5, size)).astype(np.float32),
              (0.5 * rng.randn(layers * d, N, H)).astype(np.float32)]
    if mode == "lstm":
        arrays.append((0.5 * rng.randn(layers * d, N, H)).astype(np.float32))
    return arrays


def _attrs(mode, layers, bidir, state_outputs, **extra):
    return dict(mode=mode, state_size=H, num_layers=layers,
                bidirectional=bidir, state_outputs=state_outputs, **extra)


CASES = list(itertools.product(MODES, (1, 2), (False, True), (False, True)))


@pytest.mark.parametrize("mode,layers,bidir,state_outputs", CASES)
def test_rnn_op_matches_reference(mode, layers, bidir, state_outputs):
    arrays = _inputs(mode, layers, bidir, CASES.index(
        (mode, layers, bidir, state_outputs)))
    attrs = _attrs(mode, layers, bidir, state_outputs)
    want = jreg.apply_op("RNN", [jnp.asarray(a) for a in arrays],
                         dict(attrs), rng_key=jax.random.PRNGKey(0))
    got = treg.apply_op("RNN", [torch.from_numpy(a) for a in arrays],
                        dict(attrs), generator=torch.Generator())
    assert len(got) == len(want) == (
        (3 if mode == "lstm" else 2) if state_outputs else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False)])
def test_rnn_op_shape_inference_matches_reference(mode, bidir):
    shapes = [a.shape for a in _inputs(mode, 2, bidir, 0)]
    attrs = _attrs(mode, 2, bidir, True)
    want, _ = jreg.eval_shape_op("RNN", shapes, [jnp.float32] * len(shapes),
                                 dict(attrs))
    got, _ = treg.eval_shape_op("RNN", shapes,
                                [torch.float32] * len(shapes), dict(attrs))
    assert got == [tuple(w) for w in want]


def _executor_grads(pkg, mode, layers, bidir, arrays, head_grads):
    """The op's outputs and input gradients through ``pkg``'s executor,
    the parameters and states found by shape inference from the data."""
    args = [pkg.sym.var("data"), pkg.sym.var("parameters"),
            pkg.sym.var("state")] + \
        ([pkg.sym.var("state_cell")] if mode == "lstm" else [])
    net = pkg.sym.RNN(*args, **_attrs(mode, layers, bidir, True),
                      name="rnn")
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    ex = net.simple_bind(ctx=ctx, grad_req="write", data=arrays[0].shape)
    names = net.list_arguments()
    outs = ex.forward(is_train=True, **dict(zip(names, arrays)))
    ex.backward([pkg.nd.array(g, ctx=ctx) for g in head_grads])
    return ([o.asnumpy() for o in outs],
            {n: ex.grad_dict[n].asnumpy() for n in names})


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 2, True), ("lstm", 1, False), ("gru", 2, False),
    ("gru", 1, True), ("rnn_tanh", 2, True), ("rnn_relu", 2, False)])
def test_rnn_op_gradients_match_reference(mode, layers, bidir):
    arrays = _inputs(mode, layers, bidir, 11)
    rng = np.random.RandomState(12)
    d = 2 if bidir else 1
    head = [rng.randn(T, N, d * H).astype(np.float32)] + \
        [rng.randn(layers * d, N, H).astype(np.float32)
         for _ in range(len(arrays) - 2)]
    ref_out, ref = _executor_grads(mx, mode, layers, bidir, arrays, head)
    out, got = _executor_grads(mt, mode, layers, bidir, arrays, head)
    for o, w in zip(out, ref_out):
        np.testing.assert_allclose(o, w, rtol=TOL, atol=TOL)
    assert sorted(got) == sorted(ref)
    for name in ref:
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def _dropout_ratio(apply, p, train):
    """A 2-layer ``rnn_relu`` whose second layer passes its input through
    (identity i2h, zero h2h and biases) on a first layer whose outputs
    are positive: the output over the same net's output at p = 0 is the
    mask between the layers, 0 or 1/(1 - p)."""
    t, n, h = 8, 16, 32
    rng = np.random.RandomState(5)
    size = rnn_op.param_size("rnn_relu", 2, h, h, 1)
    flat = np.zeros(size, np.float32)
    flat[:2 * h * h] = rng.uniform(0.0, 0.1, 2 * h * h)   # layer 0 weights
    flat[2 * h * h:3 * h * h] = np.eye(h, dtype=np.float32).ravel()
    data = rng.uniform(0.5, 1.0, (t, n, h)).astype(np.float32)
    state = np.zeros((2, n, h), np.float32)
    base = dict(mode="rnn_relu", state_size=h, num_layers=2)
    out = apply([data, flat, state], dict(base, p=p, __train=train))
    ref = apply([data, flat, state], dict(base, p=0.0, __train=train))
    assert (ref > 0).all()
    return out / ref


@pytest.mark.parametrize("pkg_name", ["mxnet_tpu", "mxnet_tpu_torch"])
def test_rnn_op_dropout_between_layers(pkg_name):
    p = 0.3

    def apply(arrays, attrs):
        if pkg_name == "mxnet_tpu":
            return np.asarray(jreg.apply_op(
                "RNN", [jnp.asarray(a) for a in arrays], attrs,
                rng_key=jax.random.PRNGKey(3))[0])
        gen = torch.Generator().manual_seed(3)
        return treg.apply_op("RNN", [torch.from_numpy(a) for a in arrays],
                             attrs, generator=gen)[0].numpy()

    ratio = _dropout_ratio(apply, p, train=True)
    kept = ratio > 0
    assert abs(kept.mean() - (1 - p)) < 0.03, kept.mean()
    np.testing.assert_allclose(ratio[kept], 1.0 / (1.0 - p), rtol=1e-5)
    # at inference the op drops nothing
    np.testing.assert_allclose(_dropout_ratio(apply, p, train=False), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 2, True), ("gru", 2, False), ("rnn_tanh", 1, True),
    ("rnn_relu", 2, True)])
@pytest.mark.parametrize("p", [0.0, 0.4])
def test_rnn_op_matches_its_step_loop(mode, layers, bidir, p):
    """PyTorch's RNN against the step loop in float64, outputs, states
    and gradients; with p > 0 both draw the same masks from one seed."""
    arrays = [torch.from_numpy(a).double().requires_grad_()
              for a in _inputs(mode, layers, bidir, 21)]
    d = 2 if bidir else 1
    params = rnn_op.unpack_params(arrays[1], mode, layers, I, H, d)
    states = (arrays[2], arrays[3] if mode == "lstm" else None)
    res = []
    for fn in (rnn_op.rnn_forward, rnn_op.rnn_forward_plain):
        gen = torch.Generator().manual_seed(9)
        outs = [o for o in fn(mode, arrays[0], states, params, bidir, p,
                              gen) if o is not None]
        loss = sum((o * torch.linspace(-1, 1, o.numel(), dtype=o.dtype)
                    .reshape(o.shape)).sum() for o in outs)
        res.append(([o.detach() for o in outs],
                    torch.autograd.grad(loss, arrays)))
    (outs, grads), (ref_outs, ref_grads) = res
    for g, w in zip(outs + list(grads), ref_outs + list(ref_grads)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_rnn_op_default_cell_state_is_zero():
    """An LSTM without ``state_cell`` starts from zeros, as the JAX op's
    `rnn_forward` does."""
    arrays = _inputs("lstm", 1, False, 4)
    x, flat, h0 = (torch.from_numpy(a) for a in arrays[:3])
    params = rnn_op.unpack_params(flat, "lstm", 1, I, H, 1)
    got = rnn_op.rnn_forward("lstm", x, (h0, None), params)
    want = rnn_op.rnn_forward("lstm", x, (h0, torch.zeros_like(h0)), params)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
