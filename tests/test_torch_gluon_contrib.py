"""The port's `gluon.contrib` against the JAX package's, on the CPU.

* The JAX package's own `tests/test_gluon_contrib.py` runs on the port
  (`torch_ps_parity.port_copy` points its imports at `mxnet_tpu_torch`),
  each test under ``with cpu():``.
* Every block and cell of `gluon.contrib` is built in both packages
  under one prefix, given the same seeded numpy weights by name, and run
  on the same inputs: outputs, the input's gradient and every
  parameter's gradient of a fixed random projection within ``TOL`` of
  the reference's largest magnitude; the port's hybridized forward gives
  its eager one.  `LSTMPCell` is unrolled 3 steps.
* `VariationalDropoutCell` draws one mask per sequence from the port's
  generator; `LSTMPCell`'s graph gets the same `pallas_select` report in
  both packages (no rewrite: its ``split`` is not the matcher's
  ``SliceChannel``).
"""
import importlib

import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
import torch_ps_parity as parity

TOL = 1e-5


globals().update(parity.port_tests("test_gluon_contrib.py"))


# -- both packages on the same weights ---------------------------------------

def _arr(pkg, a):
    a = np.asarray(a)
    if pkg is tx:
        return tx.nd.array(a, ctx=tx.cpu(), dtype=a.dtype)
    return jx.nd.array(a, dtype=a.dtype)


def _close(got, ref, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30) if ref.size else 1.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= TOL * scale, f"{what}: {err} against {scale}"


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _run(pkg, make, inputs, values, call, hybridize=False, seed=7):
    """Outputs, input gradients and parameter gradients (by name) of
    ``call(blk, *inputs)`` under a fixed projection of every output."""
    blk = make(pkg)
    with (tx.cpu() if pkg is tx else _null()):
        blk.initialize(ctx=tx.cpu()) if pkg is tx else blk.initialize()
        xs = [_arr(pkg, x) for x in inputs]
        call(blk, *xs)                 # settles deferred shapes
        for name, p in blk.collect_params().items():
            p.set_data(_arr(pkg, values(name, p.shape)))
            p.grad_req = "write"
        if hybridize:
            blk.hybridize()
        for x in xs:
            x.attach_grad()
        rng = np.random.RandomState(seed)
        with pkg.autograd.record():
            outs = _flat(call(blk, *xs))
            loss = None
            for o in outs:
                proj = _arr(pkg, rng.randn(*o.shape).astype(np.float32))
                term = (o * proj).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs],
                {n: p.grad().asnumpy()
                 for n, p in blk.collect_params().items()})


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _values(seed):
    cache = {}

    def values(name, shape):
        if name not in cache:
            rng = np.random.RandomState(
                (seed + sum(map(ord, name))) % (2 ** 31))
            v = rng.randn(*shape).astype(np.float32) * 0.3
            if name.endswith(("running_var", "moving_var")):
                v = np.abs(v) + 0.5
            cache[name] = v
        return cache[name]
    return values


_REFERENCE = {}


def _parity(make, inputs, call=lambda b, *x: b(*x), hybridize=False,
            key=None):
    """The port against the JAX package (whose results are kept by
    ``key``: the hybridized and eager port runs share them)."""
    values = _values(11)
    j = _REFERENCE.get(key)
    if j is None:
        j = _run(jx, make, inputs, values, call)
        if key is not None:
            _REFERENCE[key] = j
    t = _run(tx, make, inputs, values, call, hybridize=hybridize)
    for k, (a, b) in enumerate(zip(t[0], j[0])):
        _close(a, b, f"output {k}")
    for k, (a, b) in enumerate(zip(t[1], j[1])):
        _close(a, b, f"input gradient {k}")
    assert sorted(t[2]) == sorted(j[2])
    for n in j[2]:
        _close(t[2][n], j[2][n], f"gradient of {n}")
    return t


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dense_pair(pkg, cls):
    net = cls(axis=1, prefix="conc_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(4, in_units=3),
                pkg.gluon.nn.Dense(6, in_units=3))
    return net


BLOCKS = {
    "HybridConcurrent": (lambda p: _dense_pair(
        p, p.gluon.contrib.nn.HybridConcurrent), [_rand(2, 3)]),
    "Concurrent": (lambda p: _dense_pair(
        p, p.gluon.contrib.nn.Concurrent), [_rand(2, 3)]),
    "Identity": (lambda p: p.gluon.contrib.nn.Identity(prefix="idn_"),
                 [_rand(2, 3)]),
    "SyncBatchNorm": (lambda p: p.gluon.contrib.nn.SyncBatchNorm(
        in_channels=3, num_devices=2, prefix="sbn_"), [_rand(4, 3, 5, 5)]),
    "PixelShuffle1D": (lambda p: p.gluon.contrib.nn.PixelShuffle1D(
        3, prefix="ps1_"), [_rand(2, 6, 5)]),
    "PixelShuffle2D": (lambda p: p.gluon.contrib.nn.PixelShuffle2D(
        (2, 3), prefix="ps2_"), [_rand(2, 12, 3, 4)]),
    "PixelShuffle3D": (lambda p: p.gluon.contrib.nn.PixelShuffle3D(
        2, prefix="ps3_"), [_rand(2, 16, 2, 3, 2)]),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("hybridize", [False, True])
def test_block_matches_reference(name, hybridize):
    make, inputs = BLOCKS[name]
    _parity(make, inputs, hybridize=hybridize, key=name)


def test_sparse_embedding_matches_reference():
    ids = np.array([[1, 3, 3], [0, 9, 1]], np.float32)

    def make(p):
        return p.gluon.contrib.nn.SparseEmbedding(10, 4, prefix="emb_")

    values = _values(3)
    outs = []
    for pkg in (jx, tx):
        blk = make(pkg)
        with (tx.cpu() if pkg is tx else _null()):
            blk.initialize(ctx=tx.cpu()) if pkg is tx else blk.initialize()
            # the inner Embedding is named by each package's own counter
            (p,) = blk.collect_params().values()
            p.set_data(_arr(pkg, values("weight", p.shape)))
            with pkg.autograd.record():
                out = blk(_arr(pkg, ids))
                loss = (out * _arr(pkg, _rand(2, 3, 4, seed=5))).sum()
            loss.backward()
            grad = list(blk.collect_params().values())[0].grad().asnumpy()
        outs.append((out.asnumpy(), grad))
    _close(outs[1][0], outs[0][0], "lookup")
    _close(outs[1][1], outs[0][1], "gradient")
    untouched = [r for r in range(10) if r not in (0, 1, 3, 9)]
    assert not outs[1][1][untouched].any()


def _cell_call(steps, layout="NTC"):
    def call(cell, x):
        outs, states = cell.unroll(steps, x, layout=layout,
                                   merge_outputs=True)
        return [outs] + list(states)
    return call


CELLS = {
    f"Conv{d}D{kind}Cell": (d, kind)
    for d in (1, 2, 3) for kind in ("RNN", "LSTM", "GRU")}
_SPATIAL = {1: (5,), 2: (4, 3), 3: (3, 2, 3)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_conv_cell_matches_reference(name):
    d, _ = CELLS[name]
    spatial = _SPATIAL[d]

    def make(p):
        cls = getattr(p.gluon.contrib.rnn, name)
        return cls((2,) + spatial, 3, 3, 3, prefix="cc_")

    _parity(make, [_rand(2, 2, 2, *spatial)], call=_cell_call(2))


def test_lstmp_cell_unrolled_matches_reference():
    def make(p):
        return p.gluon.contrib.rnn.LSTMPCell(8, 4, prefix="lstmp_")

    _parity(make, [_rand(2, 3, 6)], call=_cell_call(3), key="lstmp")
    _parity(make, [_rand(2, 3, 6)], call=_cell_call(3), hybridize=True,
            key="lstmp")


def test_variational_dropout_cell_without_dropout_matches_reference():
    def make(p):
        base = p.gluon.contrib.rnn.LSTMPCell(8, 4, prefix="vd_")
        return p.gluon.contrib.rnn.VariationalDropoutCell(base)

    _parity(make, [_rand(2, 3, 6)], call=_cell_call(3))


def test_variational_dropout_cell_one_mask_per_sequence():
    """The mask is drawn once per sequence (the same units are dropped at
    every step), from the port's generator, and drawn anew after
    ``reset``."""
    with tx.cpu():
        base = tx.gluon.rnn.RNNCell(6, activation="relu", prefix="vr_")
        cell = tx.gluon.contrib.rnn.VariationalDropoutCell(
            base, drop_inputs=0.5)
        cell.initialize(ctx=tx.cpu())
        x = tx.nd.ones((4, 6))
        tx.random.seed(3)
        with tx.autograd.record():
            cell.reset()
            s = cell.begin_state(batch_size=4)
            cell(x, s)
            first = cell._mask_inputs.asnumpy()
            cell(x, s)
            again = cell._mask_inputs.asnumpy()
            cell.reset()
            cell(x, cell.begin_state(batch_size=4))
            other = cell._mask_inputs.asnumpy()
    np.testing.assert_array_equal(first, again)
    assert set(np.unique(first)) <= {0.0, 2.0}
    assert 0 < (first == 0).sum() < first.size
    assert not np.array_equal(first, other)


def test_interval_sampler_matches_reference():
    for args in ((13, 3), (13, 3, False), (10, 10), (7, 1)):
        assert list(tx.gluon.contrib.data.IntervalSampler(*args)) == \
            list(jx.gluon.contrib.data.IntervalSampler(*args))
        assert len(tx.gluon.contrib.data.IntervalSampler(*args)) == \
            len(jx.gluon.contrib.data.IntervalSampler(*args))


def _lstmp_graph(pkg, steps=3):
    cell = pkg.gluon.contrib.rnn.LSTMPCell(8, 4, input_size=6,
                                           prefix="lstmp_")
    # the cell's own graph code with F = sym, step by step (a Gluon cell
    # cannot be traced whole into a Symbol in the JAX package: its call
    # reads the input's context)
    params = {n: pkg.sym.var(p.name) for n, p in cell._reg_params.items()}
    states = [pkg.sym.var("r0"), pkg.sym.var("c0")]
    outs = []
    for i in range(steps):
        out, states = cell.hybrid_forward(pkg.sym, pkg.sym.var(f"t{i}"),
                                          states, **params)
        outs.append(out)
    return pkg.sym.Group(outs + states)


def test_lstmp_graph_gets_the_same_pallas_select_report(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    reports = {}
    for tag, pkg in (("jax", jx), ("torch", tx)):
        graph_opt = importlib.import_module(pkg.__name__ + ".graph_opt")
        sym = _lstmp_graph(pkg)
        res = graph_opt.optimize(sym, train=False,
                                 shapes=dict({f"t{i}": (2, 6)
                                              for i in range(3)},
                                             r0=(2, 4), c0=(2, 8)))
        reports[tag] = [r for r in res.reports if r.name == "pallas_select"]
    assert len(reports["jax"]) == len(reports["torch"]) == 1
    j, t = reports["jax"][0], reports["torch"][0]
    assert j.rewrites == t.rewrites == 0
    assert j.details == t.details
