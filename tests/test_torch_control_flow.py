"""Control flow in the port against the JAX package, case for case with
`tests/test_control_flow_sym.py`: ``sym.contrib.foreach``,
``while_loop`` and ``cond`` (the `_foreach`, `_while_loop` and `_cond`
registry ops) and their imperative ``nd.contrib`` forms, built with each
package from the same code and fed the same numpy inputs; plus MXNet's PTB
LSTM LM cut to vocab 50, 2 x 8 hidden, T = 6, batch 4 with its time loop
as a ``foreach`` scan, against its `cell.unroll` form and against the JAX
package, and its greedy decode as a ``while_loop``.

Tolerances: forward results within FWD_TOL = 1e-5 of the reference's
largest magnitude, gradients through a loop within GRAD_TOL = 1e-4 of
theirs; the lowered-against-imperative cases of one package bit-equal, as
the JAX package's own tests hold them.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.symbol import symbol as jsym
from mxnet_tpu.symbol import contrib as jcontrib

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.model_zoo import (foreach_lm, greedy_decoder,
                                       lm_weight_names, lstm_lm, lstm_step,
                                       random_params)
from mxnet_tpu_torch.symbol import contrib as tcontrib
from mxnet_tpu_torch.symbol import symbol as tsym

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LM = dict(num_layers=2, num_hidden=8, num_embed=8, vocab=50)
T, B = 6, 4


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max() if ref.size else 0.0, 1e-30)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} against {scale}"


def _in_pkg(pkg, fn):
    """``fn(pkg)`` with the port's default context the CPU."""
    if pkg is mt:
        with mt.cpu():
            return fn(pkg)
    return fn(pkg)


def _both(fn):
    """``fn(pkg)`` for the JAX package, then the port, with every
    auto-name counter from zero."""
    out = []
    for pkg, names, cf in ((mx, jsym._NAMES, jcontrib),
                           (mt, tsym._NAMES, tcontrib)):
        names.counters.clear()
        cf._CF_UID = itertools.count()
        out.append(_in_pkg(pkg, fn))
    return out


def _bind_forward(pkg, sym, args, **kw):
    ex = sym.bind(pkg.cpu(), args={k: pkg.nd.array(v) for k, v in
                                   args.items()}, grad_req="null", **kw)
    return [o.asnumpy() for o in ex.forward()]


# ---------------------------------------------------------------------------
# the cases of tests/test_control_flow_sym.py, through both packages
# ---------------------------------------------------------------------------

def test_sym_foreach_cumsum_matches_eager():
    x = np.random.RandomState(9).randn(5, 3).astype(np.float32)
    s0 = np.zeros(3, np.float32)

    def run(pkg):
        def body(item, state):
            new = state + item
            return new, new
        outs, final = pkg.sym.contrib.foreach(body, pkg.sym.var("data"),
                                              pkg.sym.var("init"))
        g = pkg.sym.Group([outs, final])
        got = _bind_forward(pkg, g, {"data": x, "init": s0})
        e_outs, _ = pkg.nd.contrib.foreach(
            lambda item, st: (st + item, st + item), pkg.nd.array(x),
            pkg.nd.array(s0))
        return got + [e_outs.asnumpy()]

    ref, got = _both(run)
    _close(got[0], np.cumsum(x, 0), FWD_TOL)
    _close(got[1], x.sum(0), FWD_TOL)
    for g, r in zip(got, ref):
        _close(g, r, FWD_TOL)
    assert np.array_equal(got[0], got[2])


def test_sym_foreach_closes_over_weights_and_differentiates():
    """An RNN-style foreach over an outer weight: the loss and the
    gradients of data, init state and weight against the JAX package."""
    rs = np.random.RandomState(9)
    x = rs.randn(4, 2, 3).astype(np.float32)
    s0 = rs.randn(2, 3).astype(np.float32)
    w = (rs.randn(3, 3) * 0.5).astype(np.float32)

    def run(pkg):
        S = pkg.sym
        wv = S.var("w")

        def body(item, state):
            new = S.tanh(S.dot(state, wv) + item)
            return new, new
        outs, final = S.contrib.foreach(body, S.var("data"), S.var("init"))
        loss = S.sum(outs) + S.sum(final)
        args = {"data": x, "init": s0, "w": w}
        ex = loss.bind(pkg.cpu(), args={k: pkg.nd.array(v)
                                        for k, v in args.items()},
                       args_grad={k: pkg.nd.zeros(v.shape)
                                  for k, v in args.items()})
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return y, {k: ex.grad_dict[k].asnumpy() for k in args}

    (ry, rg), (gy, gg) = _both(run)
    _close(gy, ry, FWD_TOL)
    for k in rg:
        _close(gg[k], rg[k], GRAD_TOL, k)


def test_sym_while_loop_counts_and_pads():
    def run(pkg):
        S = pkg.sym

        def func(s, i):
            s2 = s + i
            return s2, [s2, i + 1]
        outs, final = S.contrib.while_loop(
            lambda s, i: S.sum(s) < 6.0, func, [S.var("s"), S.var("i")],
            max_iterations=8)
        return _bind_forward(pkg, S.Group([outs] + final),
                             {"s": np.zeros(1, np.float32),
                              "i": np.ones(1, np.float32)})

    ref, got = _both(run)
    np.testing.assert_array_equal(got[0].ravel(), [1, 3, 6, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got[1], [6.0])
    np.testing.assert_array_equal(got[2], [4.0])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("swap", [False, True], ids=["then", "else"])
def test_sym_cond_selects_branch(swap):
    xv = np.full((2, 2), 2.0, np.float32)
    yv = np.full((2, 2), 1.0, np.float32)
    if swap:
        xv, yv = yv, xv

    def run(pkg):
        S = pkg.sym
        x, y = S.var("x"), S.var("y")
        out = S.contrib.cond(S.sum(x) > S.sum(y), lambda: x * 2,
                             lambda: y * 3)
        return _bind_forward(pkg, out, {"x": xv, "y": yv})[0]

    ref, got = _both(run)
    np.testing.assert_array_equal(got, np.full((2, 2), 4.0 if not swap
                                               else 6.0, np.float32))
    np.testing.assert_array_equal(got, ref)


def test_sym_foreach_multiple_data_and_states():
    rs = np.random.RandomState(9)
    x1 = rs.randn(3, 2).astype(np.float32)
    x2 = (rs.rand(3, 2) + 0.5).astype(np.float32)

    def run(pkg):
        S = pkg.sym

        def body(items, states):
            a, b = items
            u, v = states
            return [a + u, b * v], [u + a, v * b]
        outs, finals = S.contrib.foreach(
            body, [S.var("d1"), S.var("d2")], [S.var("s1"), S.var("s2")])
        return _bind_forward(pkg, S.Group(list(outs) + list(finals)), {
            "d1": x1, "d2": x2, "s1": np.zeros(2, np.float32),
            "s2": np.ones(2, np.float32)})

    ref, got = _both(run)
    for g, r in zip(got, ref):
        _close(g, r, FWD_TOL)
    _close(got[2], x1.sum(0), FWD_TOL)
    _close(got[3], x2.prod(0), FWD_TOL)


def _cumsum_graph(pkg):
    S = pkg.sym
    outs, final = S.contrib.foreach(lambda item, st: (st + item, st + item),
                                    S.var("data"), S.var("init"))
    return S.Group([outs, final])


def test_sym_foreach_json_roundtrip_and_interchange():
    """The same code writes the same JSON in both packages, and each
    package runs the JSON the other wrote (nested graph JSON in attrs)."""
    ref_json, got_json = _both(lambda pkg: _cumsum_graph(pkg).tojson())
    assert got_json == ref_json
    x = np.random.RandomState(9).randn(4, 2).astype(np.float32)
    feed = {"data": x, "init": np.zeros(2, np.float32)}
    for pkg, text in ((mt, ref_json), (mx, got_json), (mt, got_json)):
        got = _in_pkg(pkg, lambda p: _bind_forward(
            p, p.sym.load_json(text), feed)[0])
        _close(got, np.cumsum(x, 0), FWD_TOL)


def test_sym_foreach_body_with_aux_states():
    x = np.random.RandomState(9).randn(3, 2, 4).astype(np.float32)

    def run(pkg):
        S = pkg.sym

        def body(item, state):
            h = S.BatchNorm(item, name="bn", use_global_stats=True)
            return h + state, state + 1.0
        outs, final = S.contrib.foreach(body, S.var("data"), S.var("init"))
        g = S.Group([outs, final])
        assert "bn_moving_mean" in g.list_inputs()
        return _bind_forward(pkg, g, {
            "data": x, "init": np.zeros((2, 4), np.float32),
            "bn_gamma": np.ones(4, np.float32),
            "bn_beta": np.zeros(4, np.float32),
            "bn_moving_mean": np.zeros(4, np.float32),
            "bn_moving_var": np.ones(4, np.float32)})[0]

    ref, got = _both(run)
    bn = x / np.sqrt(1.0 + 1e-3)
    _close(got, np.stack([bn[t] + t for t in range(3)]), FWD_TOL)
    _close(got, ref, FWD_TOL)


def test_sym_while_loop_empty_outputs_returns_list():
    def run(pkg):
        S = pkg.sym
        outs, final = S.contrib.while_loop(
            lambda lv: lv < 3.0, lambda lv: ([], lv + 1.0), S.var("v"),
            max_iterations=5)
        assert outs == []
        return _bind_forward(pkg, final, {"v": np.zeros(1, np.float32)})[0]

    ref, got = _both(run)
    np.testing.assert_array_equal(got, [3.0])
    np.testing.assert_array_equal(got, ref)


def test_symbol_rmod():
    ref, got = _both(lambda pkg: _bind_forward(
        pkg, 5.0 % pkg.sym.var("x"),
        {"x": np.array([3.0, 2.0], np.float32)})[0])
    np.testing.assert_array_equal(got, [2.0, 1.0])
    np.testing.assert_array_equal(got, ref)


def _cumtanh(pkg):
    class CumTanh(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x, s0):
            outs, _ = F.contrib.foreach(
                lambda item, st: (F.tanh(st + item),) * 2, x, s0)
            return outs
    return CumTanh()


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_hybrid_block_foreach_both_modes(hybridize):
    """`F.contrib.foreach` in a HybridBlock: imperative (F = nd) and
    symbolic (F = sym) give the same numbers, in both packages."""
    xv = np.random.RandomState(9).randn(4, 2).astype(np.float32)

    def run(pkg):
        net = _cumtanh(pkg)
        if hybridize:
            net.hybridize()
        x, s = pkg.nd.array(xv), pkg.nd.zeros((2,))
        eager = net(x, s).asnumpy()
        sym_out = net(pkg.sym.var("x"), pkg.sym.var("s"))
        ex = sym_out.bind(pkg.cpu(), args={"x": x, "s": s}, grad_req="null")
        return eager, ex.forward()[0].asnumpy()

    (re, rs_), (ge, gs) = _both(run)
    _close(ge, gs, FWD_TOL)
    _close(ge, re, FWD_TOL)
    _close(gs, rs_, FWD_TOL)


def test_sym_foreach_nested():
    x = np.random.RandomState(9).randn(3, 4).astype(np.float32)

    def run(pkg):
        S = pkg.sym

        def outer_body(row, state):
            inner_outs, inner_final = S.contrib.foreach(
                lambda e, s: (s + e, s + e), row, state * 0)
            return inner_outs, state + inner_final
        outs, final = S.contrib.foreach(outer_body, S.var("data"),
                                        S.var("init"))
        return _bind_forward(pkg, S.Group([outs, final]),
                             {"data": x, "init": np.zeros((), np.float32)})

    ref, got = _both(run)
    _close(got[0], np.cumsum(x, 1), FWD_TOL)
    _close(got[1], x.sum(), FWD_TOL)
    for g, r in zip(got, ref):
        _close(g, r, FWD_TOL)


def test_sym_foreach_lstm_cell_matches_unroll():
    """Scanning an LSTMCell equals its static unroll, in both packages."""
    Tn, Bn, In = 4, 2, 3
    rsw = np.random.RandomState(12)
    x = rsw.randn(Tn, Bn, In).astype(np.float32)

    def run(pkg):
        S = pkg.sym
        cell = pkg.rnn.LSTMCell(num_hidden=5, prefix="lstm_")
        outs, _ = S.contrib.foreach(lambda item, st: cell(item, st),
                                    S.var("data"), [S.var("h0"),
                                                    S.var("c0")])
        cell2 = pkg.rnn.LSTMCell(num_hidden=5, prefix="lstm_")
        u_outs, _ = cell2.unroll(Tn, S.var("data"), layout="TNC",
                                 begin_state=[S.var("h0"), S.var("c0")],
                                 merge_outputs=True)
        shapes = dict(zip(outs.list_arguments(), outs.infer_shape(
            data=(Tn, Bn, In), h0=(Bn, 5), c0=(Bn, 5))[0]))
        r = np.random.RandomState(13)
        args = {"data": x, "h0": np.zeros((Bn, 5), np.float32),
                "c0": np.zeros((Bn, 5), np.float32)}
        for n in sorted(shapes):
            if n not in args:
                args[n] = (r.randn(*shapes[n]) * 0.3).astype(np.float32)
        return (_bind_forward(pkg, outs, args)[0],
                _bind_forward(pkg, u_outs, args)[0])

    (rf, ru), (gf, gu) = _both(run)
    _close(gf, gu, FWD_TOL)
    _close(gf, rf, FWD_TOL)


def test_sym_while_loop_differentiable():
    """s <- s*a while i < 3: final = s0*a^3, d/da = 3 a^2 s0, d/ds0 =
    a^3, through the masked fixed-trip scan in both packages."""
    s0v, av = 2.0, 1.5

    def run(pkg):
        S = pkg.sym
        a = S.var("a")
        _o, final = S.contrib.while_loop(
            lambda sv, iv: iv < 3.0, lambda sv, iv: ([], [sv * a, iv + 1.0]),
            [S.var("s"), S.var("i")], max_iterations=6)
        loss = S.sum(final[0])
        args = {"s": np.array([s0v], np.float32),
                "i": np.zeros(1, np.float32), "a": np.array([av], np.float32)}
        ex = loss.bind(pkg.cpu(), args={k: pkg.nd.array(v) for k, v in
                                        args.items()},
                       args_grad={k: pkg.nd.zeros((1,)) for k in args})
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return y, ex.grad_dict["a"].asnumpy(), ex.grad_dict["s"].asnumpy()

    ref, got = _both(run)
    _close(got[0], np.float32(s0v * av ** 3), FWD_TOL)
    _close(got[1], [3 * av ** 2 * s0v], GRAD_TOL)
    _close(got[2], [av ** 3], GRAD_TOL)
    for g, r in zip(got, ref):
        _close(g, r, GRAD_TOL)


def _foreach_rnn(pkg, Bn, H):
    S = pkg.sym
    seq = S.transpose(S.var("data"), axes=(1, 0, 2))
    w, u = S.var("rw"), S.var("ru")

    def body(item, state):
        new = S.tanh(S.FullyConnected(item, w, num_hidden=H, no_bias=True)
                     + S.FullyConnected(state, u, num_hidden=H,
                                        no_bias=True))
        return new, new
    _o, final = S.contrib.foreach(body, seq, S.zeros(shape=(Bn, H)))
    fc = S.FullyConnected(final, num_hidden=2, name="head")
    return S.SoftmaxOutput(fc, name="softmax")


def _rnn_data():
    rs = np.random.RandomState(3)
    X = rs.randn(160, 5, 4).astype(np.float32)
    return X, (X[:, :, 0].mean(1) > 0).astype(np.float32)


def test_module_fit_trains_foreach_rnn():
    """The reference test's settings (10 epochs of Adam at lr 0.02) train
    the port's foreach RNN past 0.9 accuracy, the cell weights allocated
    by the body-shape back-fill.  The initializer draws from the port's
    generator, seeded here: unseeded, its state is whatever the tests run
    before this one in the same process left (1 of 12 seeds lands at
    exactly 0.9)."""
    X, y = _rnn_data()
    mt.random.seed(0)
    with mt.cpu():
        it = mt.io.NDArrayIter(X, y, batch_size=8,
                               label_name="softmax_label")
        mod = mt.mod.Module(_foreach_rnn(mt, 8, 16), context=mt.cpu())
        mod.fit(it, num_epoch=10, optimizer="adam",
                optimizer_params={"learning_rate": 0.02})
        acc = mod.score(it, "acc")[0][1]
    assert acc > 0.9, acc


def test_module_fit_foreach_rnn_matches_reference():
    """Two epochs of SGD from the same weights: every weight within
    GRAD_TOL of the JAX package's (the step is a gradient through the
    loop)."""
    X, y = _rnn_data()
    r = np.random.RandomState(4)
    params = {"rw": (r.randn(16, 4) * 0.3).astype(np.float32),
              "ru": (r.randn(16, 16) * 0.3).astype(np.float32),
              "head_weight": (r.randn(2, 16) * 0.3).astype(np.float32),
              "head_bias": np.zeros(2, np.float32)}

    def run(pkg):
        it = pkg.io.NDArrayIter(X, y, batch_size=8,
                                label_name="softmax_label")
        mod = pkg.mod.Module(_foreach_rnn(pkg, 8, 16), context=pkg.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: pkg.nd.array(v) for k, v in params.items()})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    ref, got = _both(run)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], GRAD_TOL, k)


def _cond_rnn(pkg, Bn, H):
    """`_foreach_rnn` whose body halves its new state where the state's
    sum is negative: a ``_cond`` inside the scan."""
    S = pkg.sym
    seq = S.transpose(S.var("data"), axes=(1, 0, 2))
    w, u = S.var("rw"), S.var("ru")

    def body(item, state):
        h = S.tanh(S.FullyConnected(item, w, num_hidden=H, no_bias=True)
                   + S.FullyConnected(state, u, num_hidden=H,
                                      no_bias=True))
        new = S.contrib.cond(S.sum(h) > 0, lambda: h, lambda: h * 0.5)
        return new, new
    _o, final = S.contrib.foreach(body, seq, S.zeros(shape=(Bn, H)))
    fc = S.FullyConnected(final, num_hidden=2, name="head")
    return S.SoftmaxOutput(fc, name="softmax")


def test_cond_inside_foreach_leaves_the_one_graph_paths():
    """A ``_cond`` in a scan body makes the scan node uncapturable: the
    graph is not one CUDA graph, its inference program runs the island
    plan with the scan eagerly (equal to the whole graph), the module's
    fused step refuses it before building anything, and its ``fit``
    (the classic step) trains as the JAX package's does, every weight
    within GRAD_TOL."""
    from mxnet_tpu_torch import graph_compile as tgc
    X, y = _rnn_data()
    r = np.random.RandomState(4)
    params = {"rw": (r.randn(16, 4) * 0.3).astype(np.float32),
              "ru": (r.randn(16, 16) * 0.3).astype(np.float32),
              "head_weight": (r.randn(2, 16) * 0.3).astype(np.float32),
              "head_bias": np.zeros(2, np.float32)}
    with mt.cpu():
        sym = _cond_rnn(mt, 8, 16)
        assert "_cond" in tgc.graph_ops(sym)
        assert not tgc.one_graph(sym)
        prog = tgc.GraphProgram(sym, False, {"data": (8, 5, 4),
                                             "softmax_label": (8,)})
        assert not prog.one_graph and not prog.has_islands
        feed = {k: torch.from_numpy(v) for k, v in params.items()}
        feed["data"] = torch.from_numpy(X[:8])
        feed["softmax_label"] = torch.from_numpy(y[:8])
        whole, _ = prog.forward(feed)
        islands = prog._forward_islands({**feed, **prog.const_feed})
        _close(islands[0].numpy(), whole[0].numpy(), FWD_TOL)
        it = mt.io.NDArrayIter(X, y, batch_size=8,
                               label_name="softmax_label")
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mt.nd.array(v)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd")
        assert mod.fused_step(next(iter(it))) is False
        assert mod._fused_train_step is None

    def run(pkg):
        it = pkg.io.NDArrayIter(X, y, batch_size=8,
                                label_name="softmax_label")
        mod = pkg.mod.Module(_cond_rnn(pkg, 8, 16), context=pkg.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: pkg.nd.array(v) for k, v in params.items()})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    ref, got = _both(run)
    for k in ref:
        _close(got[k], ref[k], GRAD_TOL, k)


def test_foreach_lowered_vs_imperative_bitwise_captured_state():
    rs = np.random.RandomState(3)
    xv = rs.randn(5, 2, 4).astype(np.float32)
    hv = rs.randn(2, 4).astype(np.float32)
    wv = rs.randn(2, 4).astype(np.float32)

    def run(pkg):
        S, nd = pkg.sym, pkg.nd
        w = S.var("w")
        outs, finals = S.contrib.foreach(
            lambda x_t, st: ([S.tanh(x_t + st[0]) * w],
                             [S.tanh(x_t + st[0]) * w]),
            S.var("data"), [S.var("init")])
        low = _bind_forward(pkg, S.Group([outs[0], finals[0]]),
                            {"data": xv, "init": hv, "w": wv})
        w_nd = nd.array(wv)

        def nd_step(x_t, states):
            h = nd.tanh(x_t + states[0]) * w_nd
            return [h], [h]
        imp_outs, imp_finals = nd.contrib.foreach(
            nd_step, nd.array(xv), [nd.array(hv)])
        assert np.array_equal(low[0], imp_outs.asnumpy())
        assert np.array_equal(low[1], imp_finals[0].asnumpy())
        return low

    ref, got = _both(run)
    for g, r in zip(got, ref):
        _close(g, r, FWD_TOL)


def test_while_loop_lowered_vs_imperative_bitwise_captured_state():
    limit_v = np.array([5.5], np.float32)

    def run(pkg):
        S, nd = pkg.sym, pkg.nd

        def sym_func(s, i):
            s2 = s + i
            return s2, [s2, i + 1]
        outs, finals = S.contrib.while_loop(
            lambda s, i: S.sum(s) < S.sum(S.var("limit")), sym_func,
            [S.var("s"), S.var("i")], max_iterations=7)
        low = _bind_forward(pkg, S.Group([outs] + finals), {
            "s": np.zeros(1, np.float32), "i": np.ones(1, np.float32),
            "limit": limit_v})
        limit_nd = nd.array(limit_v)
        imp_outs, imp_finals = nd.contrib.while_loop(
            lambda s, i: nd.sum(s) < nd.sum(limit_nd),
            lambda s, i: ((s + i), [s + i, i + 1]),
            [nd.zeros((1,)), nd.ones((1,))], max_iterations=7)
        assert np.array_equal(low[0], imp_outs.asnumpy())
        assert np.array_equal(low[1], imp_finals[0].asnumpy())
        assert np.array_equal(low[2], imp_finals[1].asnumpy())
        return low

    ref, got = _both(run)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_while_loop_zero_iterations_lowered_vs_imperative():
    def run(pkg):
        S, nd = pkg.sym, pkg.nd
        outs, final = S.contrib.while_loop(
            lambda v: S.sum(v) < 0.0, lambda v: (v * 2.0, v + 1.0),
            S.var("v"), max_iterations=4)
        low_out, low_fin = _bind_forward(pkg, S.Group([outs, final]),
                                         {"v": np.ones(3, np.float32)})
        assert np.array_equal(low_out, np.zeros((4, 3), np.float32))
        imp_outs, imp_final = nd.contrib.while_loop(
            lambda v: nd.sum(v) < 0.0, lambda v: (v * 2.0, v + 1.0),
            nd.ones((3,)), max_iterations=4)
        assert imp_outs == []
        assert np.array_equal(low_fin, imp_final.asnumpy())
        return low_out, low_fin

    ref, got = _both(run)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale", [2.0, -2.0], ids=["then", "else"])
def test_cond_lowered_vs_imperative_bitwise_both_branches(scale):
    rs = np.random.RandomState(4)
    av = rs.randn(2, 3).astype(np.float32)
    bv = rs.randn(2, 3).astype(np.float32)
    xv = np.full((2, 2), scale, np.float32)

    def run(pkg):
        S, nd = pkg.sym, pkg.nd
        a, b = S.var("a"), S.var("b")
        out = S.contrib.cond(S.sum(S.var("x")) > 0.0, lambda: S.exp(a),
                             lambda: b * 3.0)
        low = _bind_forward(pkg, out, {"x": xv, "a": av, "b": bv})[0]
        a_nd, b_nd = nd.array(av), nd.array(bv)
        imp = nd.contrib.cond(nd.sum(nd.array(xv)) > 0.0,
                              lambda: nd.exp(a_nd), lambda: b_nd * 3.0)
        assert np.array_equal(low, imp.asnumpy())
        return low

    ref, got = _both(run)
    _close(got, ref, FWD_TOL)


# ---------------------------------------------------------------------------
# the port's own: shape inference, the one-branch _cond, the foreach LM
# ---------------------------------------------------------------------------

def test_cond_shape_inference_demands_agreeing_branches():
    with mt.cpu():
        S = mt.sym
        x, y = S.var("x"), S.var("y")
        ok = S.contrib.cond(S.sum(x) > 0.0, lambda: x * 2, lambda: y * 3)
        assert ok.infer_shape(x=(2, 3), y=(2, 3))[1] == [(2, 3)]
        bad = S.contrib.cond(S.sum(x) > 0.0, lambda: x * 2,
                             lambda: S.sum(y))
        with pytest.raises(mt.MXNetError, match="branches"):
            bad.infer_shape(x=(2, 3), y=(2, 3))


def test_cond_runs_one_branch_only():
    """The branch not taken never runs: a NaN there neither shows in the
    output nor in the gradient (the reference's `lax.cond`)."""
    with mt.cpu():
        S = mt.sym
        x = S.var("x")
        out = S.sum(S.contrib.cond(S.sum(x) > 0.0, lambda: x * 2,
                                   lambda: S.log(x - 10.0)))
        xv = mt.nd.array(np.ones((2, 2), np.float32))
        ex = out.bind(mt.cpu(), args={"x": xv},
                      args_grad={"x": mt.nd.zeros((2, 2))})
        assert ex.forward(is_train=True)[0].asnumpy() == 8.0
        ex.backward()
        np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(),
                                      np.full((2, 2), 2.0))


def _lm_params(seed=0):
    with mt.cpu():
        shapes = lstm_lm(mt, T, **LM).infer_shape(data=(B, T))[0]
        names = lstm_lm(mt, T, **LM).list_arguments()
    return random_params({n: s for n, s in zip(names, shapes)
                          if n != "data"}, seed)


def _lm_ids(seed=1):
    return np.random.RandomState(seed).randint(
        0, LM["vocab"], (B, T)).astype(np.float32)


def _lm_grads(pkg, sym, params, ids, label):
    args = {k: pkg.nd.array(v) for k, v in params.items()}
    args["data"] = pkg.nd.array(ids)
    args["softmax_label"] = pkg.nd.array(label)
    grads = {k: pkg.nd.zeros(v.shape) for k, v in params.items()}
    ex = sym.bind(pkg.cpu(), args=args, args_grad=grads,
                  grad_req={k: "write" for k in params})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return out, {k: ex.grad_dict[k].asnumpy() for k in params}


def _lm_loss_sym(pkg, pred):
    label = pkg.sym.Reshape(pkg.sym.var("softmax_label"), shape=(-1,))
    return pkg.sym.SoftmaxOutput(pred, label, name="softmax")


def test_foreach_lm_matches_unroll_and_reference():
    """The LM with its time loop as a foreach scan against the same LM
    built with `cell.unroll` on the same weights, and against the JAX
    package's foreach LM: the outputs within FWD_TOL, the gradients of
    every parameter within GRAD_TOL."""
    params, ids = _lm_params(), _lm_ids()
    label = _lm_ids(2)

    def unrolled(pkg):
        S = pkg.sym
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(LM["num_layers"]):
            stack.add(pkg.rnn.LSTMCell(LM["num_hidden"],
                                       prefix=f"lstm_l{i}_"))
        embed = S.Embedding(S.var("data"), input_dim=LM["vocab"],
                            output_dim=LM["num_embed"], name="embed")
        outs, _ = stack.unroll(T, embed, merge_outputs=True)
        pred = S.FullyConnected(S.Reshape(outs, shape=(-1, LM["num_hidden"])),
                                num_hidden=LM["vocab"], name="pred")
        return _lm_loss_sym(pkg, pred)

    ref, got = _both(lambda pkg: _lm_grads(
        pkg, _lm_loss_sym(pkg, foreach_lm(pkg, T, B, **LM)), params, ids,
        label))
    uout, ugrads = _in_pkg(mt, lambda pkg: _lm_grads(
        pkg, unrolled(pkg), params, ids, label))
    _close(got[0], uout, FWD_TOL, "vs unroll")
    _close(got[0], ref[0], FWD_TOL, "vs reference")
    for k in params:
        _close(got[1][k], ugrads[k], GRAD_TOL, f"{k} vs unroll")
        _close(got[1][k], ref[1][k], GRAD_TOL, f"{k} vs reference")


def test_foreach_lm_json_is_the_references():
    ref, got = _both(lambda pkg: _lm_loss_sym(
        pkg, foreach_lm(pkg, T, B, **LM)).tojson())
    assert got == ref
    body = [n for n in json.loads(got)["nodes"] if n["op"] == "_foreach"]
    assert len(body) == 1


def test_greedy_decode_while_loop_matches_imperative_and_reference():
    """The greedy decode as a while_loop (n_steps a data input below
    max_iterations): tokens equal the imperative host loop's and the JAX
    package's, the rows past n_steps zero."""
    params = _lm_params()
    n, max_iter = 4, 7
    tok0 = _lm_ids()[:, 0]
    H = LM["num_hidden"]

    def run(pkg):
        dec = greedy_decoder(pkg, max_iter, **LM)
        feed = dict(params, tok=tok0, i=np.zeros(1, np.float32),
                    n_steps=np.array([n], np.float32),
                    **{f"s{k}": np.zeros((B, H), np.float32)
                       for k in range(2 * LM["num_layers"])})
        return _bind_forward(pkg, dec, feed)[0], feed

    (ref, _), (got, feed) = _both(run)
    np.testing.assert_array_equal(got, ref)
    assert not got[n:].any() and got.shape == (max_iter, B)
    with mt.cpu():
        nd = mt.nd
        w = {k: nd.array(feed[k]) for k in lm_weight_names(2)}
        n_nd = nd.array(feed["n_steps"])

        def func(tok, i, *st):
            nxt, new = lstm_step(nd, tok, list(st), w, LM["num_layers"],
                                 H, LM["num_embed"], LM["vocab"])
            return nxt, [nxt, i + 1.0] + new
        toks, _ = nd.contrib.while_loop(
            lambda tok, i, *s: i < n_nd, func,
            [nd.array(tok0), nd.zeros((1,))] +
            [nd.zeros((B, H)) for _ in range(4)], max_iterations=max_iter)
    np.testing.assert_array_equal(got, toks.asnumpy())


def test_while_loop_imperative_on_the_tape():
    """nd.contrib.while_loop under autograd.record: the gradient of the
    final state through the host loop, as the JAX package's."""
    def run(pkg):
        a = pkg.nd.array([1.5])
        a.attach_grad()
        with pkg.autograd.record():
            _o, (s, _i) = pkg.nd.contrib.while_loop(
                lambda s, i: i < 3.0, lambda s, i: ([], [s * a, i + 1.0]),
                [pkg.nd.array([2.0]), pkg.nd.zeros((1,))], max_iterations=6)
            s.backward()
        return a.grad.asnumpy()

    ref, got = _both(run)
    _close(got, [3 * 1.5 ** 2 * 2.0], GRAD_TOL)
    _close(got, ref, GRAD_TOL)


def test_contrib_helpers_match_reference():
    x = np.array([1.0, np.inf, -np.inf, np.nan, 0.0], np.float32)
    m = np.array([1, 0, 1, 0, 1], np.float32)
    d = np.arange(10, dtype=np.float32).reshape(5, 2)

    def run(pkg):
        nd = pkg.nd.contrib
        a = pkg.nd.array(x)
        return ([f(a).asnumpy() for f in (nd.isinf, nd.isnan, nd.isfinite)]
                + [nd.boolean_mask(pkg.nd.array(d), pkg.nd.array(m))
                   .asnumpy()])

    ref, got = _both(run)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype


def test_rand_zipfian_draws_in_range_with_the_references_expectations():
    """Samples in [0, range_max) with the reference's expected counts of
    the true classes (the draws differ between the packages' streams)."""
    def run(pkg):
        true = pkg.nd.array(np.array([0, 3, 9], np.float32))
        s, et, es = pkg.nd.contrib.rand_zipfian(true, 64, 50)
        return s.asnumpy(), et.asnumpy(), es.asnumpy()

    ref, got = _both(run)
    assert got[0].dtype == ref[0].dtype
    assert got[0].min() >= 0 and got[0].max() < 50
    _close(got[1], ref[1], FWD_TOL)
    assert got[2].shape == (64,)


def _const_foreach(pkg):
    S = pkg.sym
    outs, final = S.contrib.foreach(
        lambda i, s: (S.tanh(s + i), s + i * 2.0),
        S.ones(shape=(4, 3)) * 0.5, S.zeros(shape=(3,)))
    return S.Group([outs, final])


def test_graph_opt_leaves_control_flow_nodes_whole():
    """The passes never read a body: a foreach of constants keeps its node
    through both packages' pipelines (it draws from the generator, so
    fold_const and cse leave it), and the optimized program gives the
    unoptimized graph's values; the training invariants accept it."""
    from mxnet_tpu import graph_opt as jopt
    from mxnet_tpu_torch import graph_compile as tgc
    from mxnet_tpu_torch import graph_opt as topt
    ref, got = _both(lambda pkg: _const_foreach(pkg))
    jres = jopt.optimize(ref, False)
    with mt.cpu():
        tres = topt.optimize(got, train=False)
        for res in (tres, topt.optimize(got, train=True)):
            assert [n.op for n in tsym._topo(res.symbol._heads)
                    if n.op == "_foreach"] == ["_foreach"]
        topt._check_train_invariants(got, topt.optimize(got,
                                                        train=True).symbol)
        whole = _bind_forward(mt, got, {})
        prog = tgc.GraphProgram(got, False)
        outs, _ = prog.forward({})
    assert [n.op for n in jsym._topo(jres.symbol._heads)
            if n.op == "_foreach"] == ["_foreach"]
    for o, w in zip(outs, whole):
        np.testing.assert_array_equal(o.numpy(), w)
    _close(whole[0], np.tanh(np.cumsum(np.full((4, 3), 1.0), 0) - 0.5),
           FWD_TOL)
