"""The port's `gluon.rnn` against the JAX package's on the CPU: every cell
stepped and unrolled (NTC and TNC, merged or not, with ``valid_length``)
and every fused layer (`RNN`, `LSTM`, `GRU` at 1 and 2 layers, one and
two directions, with and without states) built in both packages under one
prefix with the same seeded weights by name, on the same inputs:
outputs, states and the gradients of inputs and parameters within 1e-5;
parameter names equal; `.params` files in both directions; the
hybridized layer equal to the imperative one."""
import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx

TOL = 1e-5
PKGS = {"jax": jx, "torch": tx}


def _arr(pkg, a):
    a = np.asarray(a, np.float32)
    return tx.nd.array(a, ctx=tx.cpu()) if pkg is tx else jx.nd.array(a)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy()


def _build(pkg, make, seed=0):
    """``make(pkg)`` initialized on the CPU, every parameter set to seeded
    values by name; returns the block."""
    blk = make(pkg)
    if pkg is tx:
        blk.collect_params().initialize(ctx=tx.cpu())
    else:
        blk.collect_params().initialize()
    rng = np.random.RandomState(seed)
    for name in sorted(blk.collect_params()):
        p = blk.collect_params()[name]
        p.set_data(_arr(pkg, 0.4 * rng.randn(*p.shape)))
    return blk


def _close(got, want, tol=TOL):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


CELLS = {
    "rnn_tanh": lambda g: g.rnn.RNNCell(6, input_size=5, prefix="c_"),
    "rnn_relu": lambda g: g.rnn.RNNCell(6, activation="relu",
                                        input_size=5, prefix="c_"),
    "lstm": lambda g: g.rnn.LSTMCell(6, input_size=5, prefix="c_"),
    "gru": lambda g: g.rnn.GRUCell(6, input_size=5, prefix="c_"),
}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_step_and_names_match_reference(kind):
    x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    res, names = [], []
    for pkg in (jx, tx):
        cell = _build(pkg, lambda p: CELLS[kind](p.gluon))
        names.append(sorted(cell.collect_params()))
        ctx = {"ctx": tx.cpu()} if pkg is tx else {}
        states = cell.begin_state(batch_size=3, **ctx)
        for _ in range(2):
            out, states = cell(_arr(pkg, x), states)
        res.append((_np(out), _np(states)))
    assert names[0] == names[1] == sorted(
        f"c_{k}_{g}" for k in ("i2h", "h2h") for g in ("weight", "bias"))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [True, False])
def test_cell_unroll_matches_reference(kind, layout, merge):
    shape = (3, 4, 5) if layout == "NTC" else (4, 3, 5)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    res = []
    for pkg in (jx, tx):
        cell = _build(pkg, lambda p: CELLS[kind](p.gluon))
        outs, states = cell.unroll(4, _arr(pkg, x), layout=layout,
                                   merge_outputs=merge)
        res.append((_np(outs), _np(states)))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_unroll_valid_length_matches_reference(kind, layout):
    """Outputs past each length are zero and each state is the state at
    that sample's length, in both packages alike."""
    rng = np.random.RandomState(3)
    shape = (4, 6, 5) if layout == "NTC" else (6, 4, 5)
    x = rng.randn(*shape).astype(np.float32)
    lengths = np.array([3, 6, 1, 5], np.float32)
    res = []
    for pkg in (jx, tx):
        cell = _build(pkg, lambda p: CELLS[kind](p.gluon))
        outs, states = cell.unroll(6, _arr(pkg, x), layout=layout,
                                   merge_outputs=True,
                                   valid_length=_arr(pkg, lengths))
        res.append((_np(outs), _np(states)))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])
    outs = res[1][0]
    for i, n in enumerate(lengths.astype(int)):
        pad = outs[i, n:] if layout == "NTC" else outs[n:, i]
        assert (pad == 0).all()
    # unmerged, the masked sequence comes back per step
    cell = _build(tx, lambda p: CELLS[kind](p.gluon))
    steps, _ = cell.unroll(6, _arr(tx, x), layout=layout,
                           merge_outputs=False,
                           valid_length=_arr(tx, lengths))
    axis = layout.find("T")
    _close(np.stack(_np(steps), axis=axis), outs)


@pytest.mark.parametrize("valid", [False, True])
def test_bidirectional_cell_matches_reference(valid):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 4).astype(np.float32)
    lengths = np.array([5, 2, 4], np.float32)
    res = []
    for pkg in (jx, tx):
        g = pkg.gluon
        cell = _build(pkg, lambda p: p.gluon.rnn.BidirectionalCell(
            p.gluon.rnn.LSTMCell(3, input_size=4, prefix="l_"),
            p.gluon.rnn.GRUCell(3, input_size=4, prefix="r_")))
        assert isinstance(cell, g.rnn.BidirectionalCell)
        outs, states = cell.unroll(
            5, _arr(pkg, x), merge_outputs=True,
            valid_length=_arr(pkg, lengths) if valid else None)
        res.append((_np(outs), _np(states)))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])
    assert res[1][0].shape == (3, 5, 6) and len(res[1][1]) == 3


def test_sequential_and_modifier_cells_match_reference():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 5).astype(np.float32)

    def make(p):
        r = p.gluon.rnn
        seq = r.SequentialRNNCell()
        seq.add(r.LSTMCell(5, input_size=5, prefix="s0_"))
        seq.add(r.DropoutCell(0.5))
        seq.add(r.ResidualCell(r.GRUCell(5, input_size=5, prefix="s1_")))
        seq.add(r.ZoneoutCell(r.RNNCell(5, input_size=5, prefix="s2_"),
                              zoneout_outputs=0.3, zoneout_states=0.3))
        return seq

    res, names = [], []
    for pkg in (jx, tx):
        seq = _build(pkg, make)
        names.append(sorted(seq.collect_params()))
        outs, states = seq.unroll(4, _arr(pkg, x), merge_outputs=True)
        res.append((_np(outs), _np(states)))
    assert names[0] == names[1]
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])


def test_zoneout_cell_in_training_keeps_previous_values():
    rng = np.random.RandomState(6)
    x = _arr(tx, rng.randn(8, 5, 6))
    cell = _build(tx, lambda p: p.gluon.rnn.ZoneoutCell(
        p.gluon.rnn.RNNCell(16, input_size=6, prefix="z_"),
        zoneout_outputs=0.5))
    with tx.autograd.train_mode():
        train, _ = cell.unroll(5, x, merge_outputs=False)
    plain, _ = cell.unroll(5, x, merge_outputs=False)
    train, plain = _np(train), _np(plain)
    stale = 0
    for t in range(1, 5):
        fresh = np.isclose(train[t], plain[t])
        kept = np.isclose(train[t], train[t - 1])
        assert (fresh | kept).all()
        stale += (kept & ~fresh).sum()
    assert stale > 0


LAYERS = [("RNN", 1, False, "TNC"), ("RNN", 2, True, "NTC"),
          ("LSTM", 2, False, "TNC"), ("LSTM", 2, True, "NTC"),
          ("GRU", 1, True, "TNC"), ("GRU", 2, False, "NTC")]


def _layer(name, layers, bidir, layout, **kw):
    return lambda p: getattr(p.gluon.rnn, name)(
        4, num_layers=layers, bidirectional=bidir, layout=layout,
        input_size=3, prefix="ly_", **kw)


@pytest.mark.parametrize("name,layers,bidir,layout", LAYERS)
@pytest.mark.parametrize("with_states", [False, True])
def test_layer_matches_reference(name, layers, bidir, layout, with_states):
    rng = np.random.RandomState(7)
    shape = (5, 2, 3) if layout == "TNC" else (2, 5, 3)
    x = rng.randn(*shape).astype(np.float32)
    d = 2 if bidir else 1
    n_states = 2 if name == "LSTM" else 1
    s0 = [rng.randn(layers * d, 2, 4).astype(np.float32)
          for _ in range(n_states)]
    head = rng.randn(*(shape[:2] + (4 * d,))).astype(np.float32)
    res, names = [], []
    for pkg in (jx, tx):
        layer = _build(pkg, _layer(name, layers, bidir, layout))
        names.append(sorted(layer.collect_params()))
        xs = _arr(pkg, x)
        xs.attach_grad()
        with pkg.autograd.record():
            if with_states:
                out, states = layer(xs, [_arr(pkg, s) for s in s0])
            else:
                out, states = layer(xs), []
            loss = (out * _arr(pkg, head)).sum()
            for s in states:
                loss = loss + s.sum()
        loss.backward()
        grads = {n: p.grad().asnumpy()
                 for n, p in layer.collect_params().items()}
        res.append((_np(out), _np(states), xs.grad.asnumpy(), grads))
    assert names[0] == names[1]
    assert names[1] == sorted(
        f"ly_{j}{i}_{k}_{g}" for i in range(layers)
        for j in "lr"[:d] for k in ("i2h", "h2h") for g in ("weight", "bias"))
    (ro, rs, rx, rg), (go, gs, gx, gg) = res
    _close(go, ro)
    _close(gs, rs)
    _close(gx, rx)
    for n in rg:
        _close(gg[n], rg[n])


@pytest.mark.parametrize("name,layers,bidir,layout", LAYERS[1:4])
def test_hybridized_layer_equals_imperative(name, layers, bidir, layout):
    rng = np.random.RandomState(8)
    shape = (5, 2, 3) if layout == "TNC" else (2, 5, 3)
    x = _arr(tx, rng.randn(*shape))
    layer = _build(tx, _layer(name, layers, bidir, layout))
    want = layer(x).asnumpy()
    layer.hybridize()
    np.testing.assert_array_equal(layer(x).asnumpy(), want)
    assert layer._cached_op is not None


def test_layer_dropout_between_layers_only_in_training():
    rng = np.random.RandomState(9)
    x = _arr(tx, rng.randn(6, 4, 3))
    layer = _build(tx, _layer("LSTM", 2, False, "TNC", dropout=0.5))
    plain = _build(tx, _layer("LSTM", 2, False, "TNC"))
    np.testing.assert_array_equal(layer(x).asnumpy(), plain(x).asnumpy())
    with tx.autograd.train_mode():
        a, b = layer(x).asnumpy(), layer(x).asnumpy()
    assert not np.allclose(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_layer_params_file_loads_in_either_package(tmp_path, writer):
    reader = "torch" if writer == "jax" else "jax"
    src = _build(PKGS[writer], _layer("GRU", 2, True, "NTC"), seed=10)
    fname = str(tmp_path / "gru.params")
    src.save_parameters(fname)
    dst = _layer("GRU", 2, True, "NTC")(PKGS[reader])
    ctx = {"ctx": tx.cpu()} if reader == "torch" else {}
    dst.load_parameters(fname, **ctx)
    x = np.random.RandomState(11).randn(2, 5, 3).astype(np.float32)
    _close(dst(_arr(PKGS[reader], x)).asnumpy(),
           src(_arr(PKGS[writer], x)).asnumpy())


def test_layer_deferred_input_size_and_begin_state():
    layer = tx.gluon.rnn.LSTM(6, num_layers=2, prefix="df_")
    layer.initialize(ctx=tx.cpu())
    x = _arr(tx, np.ones((4, 3, 7)))
    out = layer(x)
    assert out.shape == (4, 3, 6)
    assert layer.collect_params()["df_l0_i2h_weight"].shape == (24, 7)
    assert layer.collect_params()["df_l1_i2h_weight"].shape == (24, 6)
    states = layer.begin_state(batch_size=3, ctx=tx.cpu())
    assert [s.shape for s in states] == [(2, 3, 6), (2, 3, 6)]
    out, new = layer(x, states)
    assert [s.shape for s in new] == [(2, 3, 6), (2, 3, 6)]
    assert repr(layer) == "LSTM(7 -> 6, TNC, num_layers=2)"


def test_lstm_layer_trains():
    layer = tx.gluon.rnn.LSTM(8, input_size=3, prefix="tr_")
    layer.initialize(ctx=tx.cpu())
    trainer = tx.gluon.Trainer(layer.collect_params(), "adam",
                               {"learning_rate": 0.05})
    rng = np.random.RandomState(0)
    x = _arr(tx, rng.rand(6, 4, 3))
    target = _arr(tx, rng.rand(6, 4, 8))
    losses = []
    for _ in range(10):
        with tx.autograd.record():
            loss = ((layer(x) - target) ** 2).mean()
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asscalar()))
    assert losses[-1] < losses[0]


def test_concat_nd_on_both_fronts():
    """``F.concat_nd`` (how the fused layers pack their weights) as an
    NDArray call and as a Symbol node give the JAX package's concat."""
    rng = np.random.RandomState(12)
    parts = [rng.randn(2, n).astype(np.float32) for n in (3, 1, 4)]
    want = jx.nd.concat_nd([jx.nd.array(p) for p in parts],
                           axis=1).asnumpy()
    np.testing.assert_array_equal(
        tx.nd.concat_nd([_arr(tx, p) for p in parts], axis=1).asnumpy(),
        want)
    sym = tx.sym.concat_nd([tx.sym.var(f"x{i}") for i in range(3)], axis=1)
    ex = sym.simple_bind(ctx=tx.cpu(), grad_req="null",
                         **{f"x{i}": p.shape for i, p in enumerate(parts)})
    out = ex.forward(**{f"x{i}": p for i, p in enumerate(parts)})
    np.testing.assert_array_equal(out[0].asnumpy(), want)


def test_gluon_rnn_exports_match_reference():
    assert tx.gluon.rnn.__all__ == jx.gluon.rnn.__all__
    for name in jx.gluon.rnn.__all__:
        assert hasattr(tx.gluon.rnn, name), name
    seq = tx.gluon.rnn.HybridSequentialRNNCell()
    seq.add(tx.gluon.rnn.LSTMCell(4, input_size=2))
    seq.hybridize()
    assert len(seq) == 1
    with pytest.raises(tx.MXNetError):
        tx.gluon.rnn.BidirectionalCell(
            tx.gluon.rnn.LSTMCell(2), tx.gluon.rnn.LSTMCell(2))(None, [])
