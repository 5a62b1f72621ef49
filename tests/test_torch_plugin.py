"""The port's torch plugin (`plugin.torch_bridge`, ``mx.th``) against the
JAX package's, on the CPU.

* The JAX package's own `tests/test_plugin.py` runs on the port
  (`torch_ps_parity.port_tests`), each test under ``with cpu():``.
* A `TorchBlock` around a torch ``nn.Sequential`` inside a Gluon net
  gives both packages' outputs and gradients (the input's and every
  parameter's) within ``TOL``; in the port the torch module receives the
  NDArray's own tensor (the same ``data_ptr``); `TorchLoss` alike.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
import torch_ps_parity as parity

TOL = 1e-6

globals().update(parity.port_tests("test_plugin.py"))


class _Seen(torch.nn.Module):
    """Passes its input through, noting the storage it was given."""

    def __init__(self):
        super().__init__()
        self.ptrs = []

    def forward(self, x):
        self.ptrs.append(x.data_ptr())
        return x


def _torch_net(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(_Seen(), torch.nn.Linear(6, 8),
                               torch.nn.Tanh(), torch.nn.Linear(8, 3))


def _run(pkg, x_np, seed=0):
    net = pkg.gluon.nn.Sequential(prefix="net_")
    seq = _torch_net(seed)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, in_units=5, prefix="pre_"))
        net.add(pkg.plugin.TorchBlock(seq, prefix="tb_"))
    kw = dict(ctx=tx.cpu()) if pkg is tx else {}
    net.initialize(**kw)
    dense = net[0]
    rng = np.random.RandomState(3)
    dense.weight.set_data(pkg.nd.array(
        rng.randn(6, 5).astype(np.float32), **kw))
    dense.bias.set_data(pkg.nd.array(rng.randn(6).astype(np.float32), **kw))
    x = pkg.nd.array(x_np, **kw)
    x.attach_grad()
    with pkg.autograd.record():
        hidden = dense(x)
        out = net[1](hidden)
        loss = pkg.plugin.TorchLoss(torch.nn.MSELoss())(
            out, pkg.nd.array(np.ones((4, 3), np.float32), **kw))
    loss.backward()
    grads = {n[len(net.prefix):]: p.grad().asnumpy()
             for n, p in net.collect_params().items()}
    return (out.asnumpy(), float(loss.asnumpy()), x.grad.asnumpy(), grads,
            seq[0].ptrs, hidden)


def test_torch_block_in_a_gluon_net_matches_reference():
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    j = _run(jx, x)
    with tx.cpu():
        t = _run(tx, x)
    for a, b, what in ((t[0], j[0], "output"), (t[2], j[2], "x.grad")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max(),
                                   err_msg=what)
    assert abs(t[1] - j[1]) <= TOL * abs(j[1])
    assert sorted(t[3]) == sorted(j[3]) and len(t[3]) == 6
    for n in j[3]:
        np.testing.assert_allclose(t[3][n], j[3][n], rtol=0,
                                   atol=TOL * np.abs(j[3][n]).max(),
                                   err_msg=n)
    # the torch module ran on the Dense output's own tensor
    assert t[4] == [t[5].data.data_ptr()]


def test_tensor_bridge_shares_storage():
    with tx.cpu():
        a = tx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        t = tx.th.ndarray_to_torch(a)
        assert t.data_ptr() == a.data.data_ptr()
        b = tx.th.torch_to_ndarray(t)
        assert b.data.data_ptr() == t.data_ptr() and b.context == tx.cpu()
    assert tx.th is tx.torch and tx.th.TorchBlock is tx.plugin.TorchBlock


def test_torch_loss_cross_entropy_matches_reference():
    pred = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    label = np.array([0, 3, 2], np.float32)
    outs = []
    for pkg in (jx, tx):
        kw = dict(ctx=tx.cpu()) if pkg is tx else {}
        p = pkg.nd.array(pred, **kw)
        p.attach_grad()
        with pkg.autograd.record():
            loss = pkg.plugin.TorchLoss(torch.nn.CrossEntropyLoss())(
                p, pkg.nd.array(label, **kw))
        loss.backward()
        outs.append((float(loss.asnumpy()), p.grad.asnumpy()))
    assert outs[1][0] == pytest.approx(outs[0][0], rel=TOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0,
                               atol=TOL * np.abs(outs[0][1]).max())
