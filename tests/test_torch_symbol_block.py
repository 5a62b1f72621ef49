"""`gluon.SymbolBlock` of the port against the JAX package's, on the CPU.

The reference cases of `tests/test_gluon_export_cases.py` (`:16`, `:79`),
ported: a SymbolBlock over ``get_internals`` of a net gives every internal
output and nests inside a hybridized net, and `SymbolBlock.imports`
reloads an exported net.  Exports cross between the packages: an export
of either loads in the other through `SymbolBlock.imports`, within 1e-5
of the exporting net's output (relative to its largest magnitude), and
the two packages write the same symbol JSON for one net.  Under
`autograd.record` the SymbolBlock's parameters get the JAX package's
gradients (within 1e-5), hybridized or not; adopted Parameters are
shared with the source net.
"""
import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx

TOL = 1e-5


def _arr(pkg, a):
    if pkg is tx:
        return tx.nd.array(a, ctx=tx.cpu())
    return jx.nd.array(a)


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


def _names(pkg):
    """The package's symbol auto-name counters (per process): a test that
    compares names starts both from zero."""
    return pkg.symbol.symbol._NAMES


def _mlp(pkg):
    nn = pkg.gluon.nn
    model = nn.HybridSequential(prefix="mlp_")
    with model.name_scope():
        model.add(nn.Dense(16, activation="tanh"))
        model.add(nn.Dense(8, activation="tanh"), nn.Dense(4, in_units=8))
        model.add(nn.Activation("relu"))
    return model


def _init(pkg, net, x):
    if pkg is tx:
        net.initialize(ctx=tx.cpu())
    else:
        net.initialize()
    net(_arr(pkg, x))


def _carry(jnet, tnet):
    """The port net's parameters set to the JAX net's, by full name."""
    tp = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        tp[k].set_data(_arr(tx, p.data().asnumpy()))


def test_symbol_block_internals():
    """Reference `test_gluon.py:303` (`test_gluon_export_cases.py:16`):
    every internal output, run imperatively and inside a hybridized net,
    equal to the JAX package's."""
    x = np.random.RandomState(0).randn(16, 10).astype(np.float32)
    outs = {}
    for pkg in (jx, tx):
        _names(pkg).counters.clear()
        model = _mlp(pkg)
        _init(pkg, model, np.zeros((2, 10), np.float32))
        if pkg is tx:
            _carry(jmodel, model)
        else:
            jmodel = model
        data = pkg.sym.var("data")
        internals = model(data).get_internals()
        smodel = pkg.gluon.SymbolBlock(internals, data,
                                       params=model.collect_params())
        res = smodel(_arr(pkg, x))
        assert len(res) == len(internals.list_outputs())

        class Net(pkg.gluon.HybridBlock):
            def __init__(self, inner, **kw):
                super().__init__(**kw)
                self.model = inner

            def hybrid_forward(self, F, x):
                return F.add_n(*[i.sum() for i in self.model(x)])

        net = Net(smodel)
        net.hybridize()
        outs[pkg] = ([r.asnumpy() for r in res],
                     net(_arr(pkg, x)).asnumpy(),
                     internals.list_outputs())
    assert outs[tx][2] == outs[jx][2]
    for g, w in zip(outs[tx][0], outs[jx][0]):
        _close(g, w)
    _close(outs[tx][1], outs[jx][1])


def test_symbol_block_adopts_parameters():
    """Training the source net shows in the SymbolBlock: its Parameters
    are the same objects."""
    model = _mlp(tx)
    _init(tx, model, np.zeros((2, 10), np.float32))
    data = tx.sym.var("data")
    smodel = tx.gluon.SymbolBlock(model(data), data,
                                  params=model.collect_params())
    for name, p in model.collect_params().items():
        assert smodel.collect_params()[name] is p
    x = _arr(tx, np.ones((3, 10), np.float32))
    before = smodel(x).asnumpy()
    w = model.collect_params()["mlp_dense0_weight"]
    w.set_data(w.data() * 2)
    assert not np.array_equal(smodel(x).asnumpy(), before)
    np.testing.assert_array_equal(smodel(x).asnumpy(), model(x).asnumpy())


def _resnet(pkg, tmp_path, epoch, seed):
    """A seeded resnet18_v1 of ``pkg`` (10 classes), hybridized, its
    output on one batch, and its export."""
    pkg.random.seed(seed)
    net = pkg.gluon.model_zoo.vision.resnet18_v1(prefix="resnet",
                                                 classes=10)
    x = np.random.RandomState(seed).randn(1, 3, 32, 32).astype(np.float32)
    _init(pkg, net, x)
    net.hybridize()
    out = net(_arr(pkg, x)).asnumpy()
    prefix = str(tmp_path / f"{pkg.__name__}_net")
    net.export(prefix, epoch=epoch)
    return net, x, out, prefix


@pytest.mark.parametrize("src,dst", [("jax", "jax"), ("jax", "torch"),
                                     ("torch", "torch"), ("torch", "jax")])
def test_imports_of_an_export(src, dst, tmp_path):
    """Reference `test_gluon.py:872` (`test_gluon_export_cases.py:79`):
    `SymbolBlock.imports` reloads an exported net, in the same package
    and across them, within 1e-5; the two packages export the same JSON
    for one net."""
    pkgs = {"jax": jx, "torch": tx}
    _, x, out, prefix = _resnet(pkgs[src], tmp_path, 1, seed=1)
    dpkg = pkgs[dst]
    kw = {"ctx": tx.cpu()} if dpkg is tx else {}
    net2 = dpkg.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                          prefix + "-0001.params", **kw)
    _close(net2(_arr(dpkg, x)).asnumpy(), out)
    net2.hybridize()
    _close(net2(_arr(dpkg, x)).asnumpy(), out)


def test_both_packages_export_the_same_json(tmp_path):
    texts = []
    for pkg in (jx, tx):
        _names(pkg).counters.clear()
        _, _, _, prefix = _resnet(pkg, tmp_path, 0, seed=2)
        with open(prefix + "-symbol.json") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("hybrid", [False, True])
def test_symbol_block_gradients_match_reference(hybrid, tmp_path):
    """Under `autograd.record` the imported block's parameter gradients
    equal the JAX package's within 1e-4 of each one's largest magnitude
    (a ResNet's gradient through 21 layers; BatchNorm on its moving
    statistics, as both packages run a SymbolBlock in predict mode); the
    auxiliary states get none in the port.  The JAX package differentiates
    a SymbolBlock only hybridized, so its block is hybridized."""
    jnet, x, _, prefix = _resnet(jx, tmp_path, 3, seed=4)
    y = np.array([3.0], np.float32)
    grads = {}
    for pkg in (jx, tx):
        kw = {"ctx": tx.cpu()} if pkg is tx else {}
        blk = pkg.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                            ["data"],
                                            prefix + "-0003.params", **kw)
        if hybrid or pkg is jx:
            blk.hybridize()
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(blk(_arr(pkg, x)), _arr(pkg, y))
        loss.backward()
        grads[pkg] = {k: p.grad().asnumpy()
                      for k, p in blk.collect_params().items()
                      if p.grad_req != "null"}
    aux = set(jx.sym.load(prefix + "-symbol.json").list_auxiliary_states())
    assert sorted(grads[tx]) == sorted(set(grads[jx]) - aux)
    for k, g in grads[tx].items():
        scale = max(float(np.abs(grads[jx][k]).max()), 1e-30)
        assert float(np.abs(g - grads[jx][k]).max()) / scale <= 1e-4, k
