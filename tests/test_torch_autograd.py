"""The port's `autograd` against the JAX package's: each case runs the same
code on the same seeded numpy inputs through both packages' `nd` and
`autograd` (the port on the CPU) and holds every array it returns within
1e-5.  The cases follow tests/test_autograd.py: write and add gradients,
head gradients, `autograd.grad`, ``create_graph``, `mark_variables`,
`Function`, pause/detach, train and predict modes, multi-output ops and
slicing."""
import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx

TOL = 1e-5
PKGS = {"jax": jx, "torch": tx}


def _arr(pkg, a):
    a = np.asarray(a, dtype=np.float32)
    return pkg.nd.array(a, ctx=pkg.cpu()) if pkg is tx else pkg.nd.array(a)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def case_simple(pkg):
    x = _arr(pkg, _rand(0, 2, 3))
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x + 2 * x).sum()
    y.backward()
    return [y, x.grad]


def case_chain_fanout(pkg):
    x = _arr(pkg, _rand(1, 4))
    x.attach_grad()
    with pkg.autograd.record():
        a = x * 2
        b = a * a
        c = (a + b - 1.5) / (b + 2)
    c.backward()
    return [c, x.grad]


def case_nn_ops(pkg):
    """A small classifier: FC -> relu -> FC -> log_softmax -> pick."""
    nd = pkg.nd
    x, w1, b1 = (_arr(pkg, _rand(2, 5, 6)), _arr(pkg, _rand(3, 4, 6)),
                 _arr(pkg, _rand(4, 4)))
    w2 = _arr(pkg, _rand(5, 3, 4))
    label = _arr(pkg, [0, 2, 1, 1, 0])
    for v in (x, w1, b1, w2):
        v.attach_grad()
    with pkg.autograd.record():
        h = nd.Activation(nd.FullyConnected(x, w1, b1, num_hidden=4),
                          act_type="relu")
        o = nd.FullyConnected(h, w2, num_hidden=3, no_bias=True)
        loss = -nd.pick(nd.log_softmax(o), label, axis=-1)
    loss.backward()
    return [loss, x.grad, w1.grad, b1.grad, w2.grad]


def case_head_grads(pkg):
    x = _arr(pkg, _rand(6, 3, 2))
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
    y.backward(_arr(pkg, _rand(7, 3, 2)))
    return [x.grad]


def case_grad_req_add(pkg):
    x = _arr(pkg, _rand(8, 3))
    x.attach_grad(grad_req="add")
    for k in (1.0, 2.5):
        with pkg.autograd.record():
            y = (x * x * k).sum()
        y.backward()
    return [x.grad]


def case_pause_detach(pkg):
    x = _arr(pkg, _rand(9, 4))
    x.attach_grad()
    with pkg.autograd.record():
        with pkg.autograd.pause():
            z = x * 3
        y = (x * z + x.detach() * x).sum()
    y.backward()
    return [x.grad]


def case_autograd_grad(pkg):
    """`autograd.grad` returns the gradients and leaves the buffers (and
    ``_fresh_grad``) alone; a variable the head does not use gets
    zeros."""
    x, w, u = (_arr(pkg, _rand(10, 3)), _arr(pkg, _rand(11, 3)),
               _arr(pkg, _rand(12, 3)))
    for v in (x, w, u):
        v.attach_grad()
    with pkg.autograd.record():
        y = (x * w * w).sum()
    gx, gw, gu = pkg.autograd.grad(y, [x, w, u])
    assert not x._fresh_grad
    return [gx, gw, gu, x.grad, w.grad]


def case_grad_head_grads_retain(pkg):
    x = _arr(pkg, _rand(13, 2, 2))
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x
    hg = _arr(pkg, _rand(14, 2, 2))
    g1 = pkg.autograd.grad(y, x, head_grads=hg, retain_graph=True)[0]
    g2 = pkg.autograd.grad(y, x, head_grads=hg * 2)[0]
    return [g1, g2]


def case_create_graph(pkg):
    """Second derivative through `grad(create_graph=True)`: z = gx·x with
    gx = 3x² gives dz/dx = 9x²."""
    x = _arr(pkg, _rand(15, 4))
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
        gx = pkg.autograd.grad(y, [x], create_graph=True)[0]
        z = (gx * x).sum()
    z.backward()
    return [gx, x.grad]


def case_backward_create_graph(pkg):
    """`backward(create_graph=True)` leaves a differentiable gradient in
    the buffer."""
    x = _arr(pkg, _rand(16, 3))
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x * x).sum()
    pkg.autograd.backward([y], create_graph=True)
    first = x.grad.asnumpy()
    with pkg.autograd.record():
        h = (x.grad * x.grad).sum()
    h.backward()
    return [first, x.grad]


def case_mark_variables(pkg):
    w = _arr(pkg, _rand(17, 2, 3))
    gw = _arr(pkg, np.zeros((2, 3)))
    pkg.autograd.mark_variables([w], [gw])
    with pkg.autograd.record():
        y = (pkg.nd.sigmoid(w) * w).sum()
    y.backward()
    return [gw]


def case_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = _arr(pkg, _rand(18, 5))
    x.attach_grad()
    with pkg.autograd.record():
        y = Sigmoid()(x * 2)
        z = (y * y).sum()
    z.backward()
    return [y, x.grad]


def case_modes(pkg):
    ag = pkg.autograd
    flags = []
    with ag.record():
        flags.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            flags.append((ag.is_recording(), ag.is_training()))
        with ag.pause():
            flags.append((ag.is_recording(), ag.is_training()))
    with ag.record(train_mode=False):
        flags.append((ag.is_recording(), ag.is_training()))
    with ag.train_mode():
        flags.append((ag.is_recording(), ag.is_training()))
    flags.append((ag.is_recording(), ag.is_training()))
    assert flags == [(True, True), (True, False), (False, False),
                     (True, False), (False, True), (False, False)]
    x = _arr(pkg, _rand(19, 50))
    with ag.record(train_mode=False):
        d = pkg.nd.Dropout(x, p=0.5)
    return [d]


def case_multi_output(pkg):
    x = _arr(pkg, _rand(20, 4, 6))
    x.attach_grad()
    with pkg.autograd.record():
        a, b, c = pkg.nd.split(x, num_outputs=3, axis=1)
        y = a * b + c
    y.backward(_arr(pkg, _rand(21, 4, 2)))
    return [y, x.grad]


def case_slicing(pkg):
    x = _arr(pkg, _rand(22, 4, 5))
    x.attach_grad()
    with pkg.autograd.record():
        y = (x[1:3].reshape((-1,)) * 2).sum() + (x[0] * x[3]).sum()
    y.backward()
    return [x.grad]


def case_operators(pkg):
    """Arithmetic, comparison and in-place operators with arrays and
    numbers on either side."""
    a, b = _arr(pkg, _rand(23, 3, 4)), _arr(pkg, _rand(24, 1, 4))
    out = [a + b, a - 1.5, 2 - a, a * b, 3 * a, a / (b * b + 1),
           1 / (a * a + 1), -a, abs(a), a ** 2, a > b, a <= 0.1, a == a,
           a != b, 0.5 > a, a.sum(axis=1), a.mean(), a.max(axis=0),
           a.T, a.reshape((2, -1)), a[1], a[:, 1:3]]
    c = a.copy()
    c += 1
    c *= b
    c[0] = 7.0
    c[1, 2:] = _arr(pkg, [9.0, 8.0])
    return out + [c, a]


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_matches_reference(case):
    got = {k: CASES[case](pkg) for k, pkg in PKGS.items()}
    assert len(got["torch"]) == len(got["jax"])
    for t, j in zip(got["torch"], got["jax"]):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_backward_without_record_raises():
    x = _arr(tx, [1.0, 2.0])
    x.attach_grad()
    y = x * 2
    with pytest.raises(tx.MXNetError):
        y.backward()


def test_ops_outside_record_build_no_graph():
    """Outside `record`, ops on a variable run under no_grad: no graph is
    kept."""
    x = _arr(tx, [1.0, 2.0])
    x.attach_grad()
    y = x * x
    assert not y.data.requires_grad
    with tx.autograd.record():
        z = x * x
    assert z.data.requires_grad
