"""The port's legacy symbolic RNN package (`mxnet_tpu_torch.rnn`) against
the JAX package's on the CPU, test by test after `tests/test_rnn_legacy.py`:
every cell's ``unroll`` builds the same Symbol JSON as the JAX package's
and, on the same seeded weights and inputs, the same outputs; the fused
cell equals its unfused stack; pack/unpack round trips; `encode_sentences`
and `BucketSentenceIter` batch alike (compared as multisets per bucket,
since `reset` shuffles without a seed); and an RNN checkpoint written by
one package loads in the other."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.symbol import symbol as tsym

# the reference's single-op tolerance; an unrolled cell adds a few steps
TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_names():
    """Both packages' auto-name counters from zero for each test (and
    back after), so two builds of one graph name their nodes alike."""
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _both(build):
    """``build(pkg)`` for each package, the name counters cleared before
    each: ``(reference, port)``."""
    out = []
    for pkg, names in ((mx, jsym._NAMES), (mt, tsym._NAMES)):
        names.counters.clear()
        out.append(build(pkg))
    return out


def _feeds(sym, shapes, seed=0, scale=0.1):
    """Seeded numpy values for every argument of ``sym``."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: (rng.randn(*s) * (1.0 if n in shapes else scale)
                ).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}


def _forward(pkg, sym, shapes, feeds):
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    ex = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
    return [o.asnumpy() for o in ex.forward(is_train=False, **feeds)]


def _check_same(build, shapes, seed=0):
    """Same JSON, same arguments, same outputs on the same values; returns
    the port's outputs."""
    ref, got = _both(build)
    assert got.tojson() == ref.tojson()
    assert got.list_arguments() == ref.list_arguments()
    feeds = _feeds(ref, shapes, seed)
    want = _forward(mx, ref, shapes, feeds)
    outs = _forward(mt, got, shapes, feeds)
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o, w, rtol=TOL, atol=TOL)
    return outs


def _merged(pkg, cell, length=4, layout="NTC", merge=True):
    outs, states = cell.unroll(length, pkg.sym.var("data"), layout=layout,
                               merge_outputs=merge)
    outs = outs if merge else pkg.sym.Group(outs)
    return pkg.sym.Group([outs] + list(states)) if states else outs


def test_rnn_cell_unroll_shapes():
    outs = _check_same(lambda pkg: _merged(pkg, pkg.rnn.RNNCell(
        6, prefix="rnn_")), {"data": (2, 4, 3)})
    assert outs[0].shape == (2, 4, 6)
    cell = mt.rnn.RNNCell(6, prefix="rnn_")
    cell.unroll(4, mt.sym.var("data"), layout="NTC", merge_outputs=True)
    assert sorted(cell.params._params) == [
        "rnn_h2h_bias", "rnn_h2h_weight", "rnn_i2h_bias", "rnn_i2h_weight"]


@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_rnn_cell_activations_and_layouts(activation, layout):
    _check_same(lambda pkg: _merged(pkg, pkg.rnn.RNNCell(
        5, activation=activation, prefix="ra_"), layout=layout),
        {"data": (4, 2, 3) if layout == "TNC" else (2, 4, 3)})


def test_lstm_cell_unroll_list_outputs():
    def build(pkg):
        outs, states = pkg.rnn.LSTMCell(5, prefix="lstm_").unroll(
            3, pkg.sym.var("data"), layout="NTC", merge_outputs=False)
        assert isinstance(outs, list) and len(outs) == 3
        assert len(states) == 2
        return outs[-1]
    outs = _check_same(build, {"data": (2, 3, 4)})
    assert outs[0].shape == (2, 5)


def test_gru_cell_matches_numpy():
    """GRUCell against a hand-written numpy step (gate order r, z, n) and
    the JAX package's."""
    h, i, n = 3, 2, 2
    build = lambda pkg: _merged(pkg, pkg.rnn.GRUCell(h, prefix="g_"),  # noqa
                                length=1)
    outs = _check_same(build, {"data": (n, 1, i)}, seed=3)
    feeds = _feeds(build(mt), {"data": (n, 1, i)}, seed=3)
    x = feeds["data"][:, 0]
    iw, ib = feeds["g_i2h_weight"], feeds["g_i2h_bias"]
    hw, hb = feeds["g_h2h_weight"], feeds["g_h2h_bias"]
    h0 = np.zeros((n, h), np.float32)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    ig, hg = x @ iw.T + ib, h0 @ hw.T + hb
    r = sig(ig[:, :h] + hg[:, :h])
    z = sig(ig[:, h:2 * h] + hg[:, h:2 * h])
    cand = np.tanh(ig[:, 2 * h:] + r * hg[:, 2 * h:])
    np.testing.assert_allclose(outs[0][:, 0], (1 - z) * cand + z * h0,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 1, False), ("lstm", 2, True), ("gru", 2, False),
    ("rnn_tanh", 1, True), ("rnn_relu", 2, False)])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_fused_cell_unroll_matches_reference(mode, layers, bidir, layout):
    _check_same(lambda pkg: _merged(pkg, pkg.rnn.FusedRNNCell(
        4, num_layers=layers, mode=mode, bidirectional=bidir,
        get_next_state=True, prefix="f_"), layout=layout),
        {"data": (5, 2, 3) if layout == "TNC" else (2, 5, 3)})


def test_fused_cell_split_outputs_match_reference():
    _check_same(lambda pkg: _merged(pkg, pkg.rnn.FusedRNNCell(
        4, num_layers=2, mode="gru", prefix="fs_"), merge=False),
        {"data": (2, 4, 3)})


def test_fused_matches_unfused_lstm():
    """FusedRNNCell's output equals its ``unfuse()`` stack's on the
    unpacked weights (the reference's fused-against-unfused check)."""
    t, n, i, h = 4, 2, 3, 5
    fused = mt.rnn.FusedRNNCell(h, num_layers=2, mode="lstm", prefix="f_",
                                bidirectional=True)
    fout, _ = fused.unroll(t, mt.sym.var("data"), layout="NTC",
                           merge_outputs=True)
    feeds = _feeds(fout, {"data": (n, t, i)}, seed=7)
    fres = _forward(mt, fout, {"data": (n, t, i)}, feeds)
    uout, _ = fused.unfuse().unroll(t, mt.sym.var("data"), layout="NTC",
                                    merge_outputs=True)
    unpacked = fused.unpack_weights(
        {"f_parameters": mt.nd.array(feeds["f_parameters"], ctx=mt.cpu())})
    ufeeds = {"data": feeds["data"]}
    ufeeds.update({k: v.asnumpy() for k, v in unpacked.items()})
    assert set(ufeeds) == set(uout.list_arguments())
    ures = _forward(mt, uout, {"data": (n, t, i)}, ufeeds)
    np.testing.assert_allclose(ures[0], fres[0], rtol=1e-4, atol=1e-5)


def test_unfused_stack_matches_reference():
    _check_same(lambda pkg: _merged(pkg, pkg.rnn.FusedRNNCell(
        4, num_layers=2, mode="gru", bidirectional=True, dropout=0.5,
        prefix="uf_").unfuse()), {"data": (2, 4, 3)})


def test_pack_unpack_roundtrip():
    cell = mt.rnn.FusedRNNCell(4, num_layers=2, mode="gru",
                               bidirectional=True, prefix="pg_")
    out, _ = cell.unroll(3, mt.sym.var("data"), layout="NTC",
                         merge_outputs=True)
    arg_shapes, _, _ = out.infer_shape(data=(2, 3, 6))
    shapes = dict(zip(out.list_arguments(), arg_shapes))
    packed = np.random.RandomState(1).randn(
        *shapes["pg_parameters"]).astype(np.float32)
    unpacked = cell.unpack_weights(
        {"pg_parameters": mt.nd.array(packed, ctx=mt.cpu())})
    assert "pg_parameters" not in unpacked
    assert "pg_l0_i2h_weight" in unpacked and "pg_r1_h2h_bias" in unpacked
    repacked = cell.pack_weights(unpacked)
    np.testing.assert_array_equal(repacked["pg_parameters"].asnumpy(),
                                  packed)
    # the JAX package unpacks the same vector into the same arrays
    ref = mx.rnn.FusedRNNCell(4, num_layers=2, mode="gru",
                              bidirectional=True, prefix="pg_")
    want = ref.unpack_weights({"pg_parameters": mx.nd.array(packed)})
    assert sorted(want) == sorted(unpacked)
    for k in want:
        np.testing.assert_array_equal(unpacked[k].asnumpy(),
                                      want[k].asnumpy())


def test_bidirectional_cell_shapes():
    outs = _check_same(lambda pkg: _merged(pkg, pkg.rnn.BidirectionalCell(
        pkg.rnn.LSTMCell(4, prefix="fl_"), pkg.rnn.LSTMCell(4, prefix="fr_")),
        length=3), {"data": (2, 3, 5)})
    assert outs[0].shape == (2, 3, 8)
    assert len(outs) == 5


def test_residual_and_dropout_cells():
    outs = _check_same(lambda pkg: _merged(pkg, pkg.rnn.ResidualCell(
        pkg.rnn.GRUCell(5, prefix="res_")), length=2), {"data": (2, 2, 5)})
    assert outs[0].shape == (2, 2, 5)

    def stack(pkg):
        seq = pkg.rnn.SequentialRNNCell()
        seq.add(pkg.rnn.LSTMCell(5, prefix="sd0_"))
        seq.add(pkg.rnn.DropoutCell(0.5, prefix="sd1_"))
        return _merged(pkg, seq, length=2)
    outs = _check_same(stack, {"data": (2, 2, 3)})
    assert outs[0].shape == (2, 2, 5)


def test_residual_cell_steps_match_reference():
    """`ResidualCell.__call__` (a step), not its whole-sequence unroll."""
    def build(pkg):
        cell = pkg.rnn.ResidualCell(pkg.rnn.RNNCell(4, prefix="rs_"))
        steps = [pkg.sym.var(f"x{i}") for i in range(3)]
        states = cell.begin_state()
        outs = []
        for x in steps:
            out, states = cell(x, states)
            outs.append(out)
        return pkg.sym.Group(outs + states)
    _check_same(build, {f"x{i}": (2, 4) for i in range(3)} |
                {"rs_begin_state_0": (2, 4)})


def test_zoneout_cell_runs():
    outs = _check_same(lambda pkg: _merged(pkg, pkg.rnn.ZoneoutCell(
        pkg.rnn.RNNCell(4, prefix="z_"), zoneout_outputs=0.3,
        zoneout_states=0.3), length=3), {"data": (2, 3, 4)})
    assert outs[0].shape == (2, 3, 4)
    with pytest.raises(mt.MXNetError):
        mt.rnn.ZoneoutCell(mt.rnn.FusedRNNCell(4))


def test_zoneout_cell_trains_with_masks():
    """In training the zoneout masks draw from the port's generator: some
    outputs keep the previous step's value, none is scaled."""
    cell = mt.rnn.ZoneoutCell(mt.rnn.RNNCell(16, prefix="zt_"),
                              zoneout_outputs=0.5)
    outs, _ = cell.unroll(6, mt.sym.var("data"), merge_outputs=False)
    sym = mt.sym.Group(outs)
    feeds = _feeds(sym, {"data": (8, 6, 16)}, seed=2, scale=0.5)
    ex = sym.simple_bind(ctx=mt.cpu(), grad_req="null", data=(8, 6, 16))
    train = [o.asnumpy() for o in ex.forward(is_train=True, **feeds)]
    plain = [o.asnumpy() for o in ex.forward(is_train=False, **feeds)]
    kept = same = 0
    for t in range(1, 6):
        fresh = np.isclose(train[t], plain[t])
        stale = np.isclose(train[t], train[t - 1])
        assert (fresh | stale).all()
        kept += (stale & ~fresh).sum()
        same += fresh.sum()
    assert kept > 0 and same > 0


def test_encode_sentences_and_bucket_iter():
    # bucket 3: six sentences (three whole batches); bucket 5: three (one
    # batch, so one sentence an epoch is left out, chosen by the shuffle)
    sents = [["a", "b", "c"], ["b", "c"], ["c"], ["a", "b"], ["e", "d"],
             ["c", "b", "a"], ["a", "b", "c", "d", "e"], ["d", "c", "b", "a"],
             ["b", "b", "d", "e"]]
    coded, vocab = mt.rnn.encode_sentences(sents, start_label=1)
    ref_coded, ref_vocab = mx.rnn.encode_sentences(sents, start_label=1)
    assert coded == ref_coded and vocab == ref_vocab
    assert coded[0][1] == coded[3][1]  # same word, same id

    def batches(pkg):
        it = pkg.rnn.BucketSentenceIter(coded, batch_size=2, buckets=[3, 5],
                                        invalid_label=-1)
        assert it.default_bucket_key == 5
        assert [(d.name, tuple(d.shape)) for d in it.provide_data] == \
            [("data", (2, 5))]
        out = {}
        for epoch in range(2):
            it.reset()
            for b in it:
                data, label = b.data[0].asnumpy(), b.label[0].asnumpy()
                assert data.shape == (2, b.bucket_key)
                assert b.provide_data[0].shape == data.shape
                np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
                assert (label[:, -1] == -1).all()
                out.setdefault((epoch, b.bucket_key), []).extend(
                    tuple(r) for r in data)
        return {k: sorted(v) for k, v in out.items()}

    ref, got = batches(mx), batches(mt)
    assert sorted(got) == sorted(ref) == [(0, 3), (0, 5), (1, 3), (1, 5)]
    padded5 = {tuple(s + [-1] * (5 - len(s))) for s in coded if len(s) > 3}
    for epoch in range(2):
        assert got[(epoch, 3)] == ref[(epoch, 3)]
        assert len(got[(epoch, 5)]) == len(ref[(epoch, 5)]) == 2
        assert set(got[(epoch, 5)]) <= padded5


def test_encode_sentences_unknown_tokens():
    vocab = {"a": 1, "b": 2}
    for pkg in (mx, mt):
        coded, v = pkg.rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                            unknown_token="<unk>")
        assert coded == [[1, 3]] and v["<unk>"] == 3
    with pytest.raises(mt.MXNetError):
        mt.rnn.encode_sentences([["z"]], vocab=dict(vocab))


@pytest.mark.parametrize("writer,reader", [("mx", "mt"), ("mt", "mx")])
def test_save_load_rnn_checkpoint_across_packages(tmp_path, writer, reader):
    """A fused checkpoint saved unpacked by one package loads, packed
    again, in the other, and into unfused cells."""
    pkgs = {"mx": mx, "mt": mt}
    w, r = pkgs[writer], pkgs[reader]
    packed = None
    for pkg in (w,):
        cell = pkg.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                    prefix="ck_")
        out, _ = cell.unroll(2, pkg.sym.var("data"), layout="NTC",
                             merge_outputs=True)
        shapes = dict(zip(out.list_arguments(),
                          out.infer_shape(data=(1, 2, 3))[0]))
        packed = np.random.RandomState(2).randn(
            *shapes["ck_parameters"]).astype(np.float32)
        arr = mt.nd.array(packed, ctx=mt.cpu()) if pkg is mt else \
            mx.nd.array(packed)
        prefix = str(tmp_path / "model")
        pkg.rnn.save_rnn_checkpoint(cell, prefix, 1, out,
                                    {"ck_parameters": arr}, {})
    cell = r.rnn.FusedRNNCell(4, num_layers=2, mode="lstm", prefix="ck_")
    sym, arg, aux = r.rnn.load_rnn_checkpoint(cell, prefix, 1)
    assert sorted(arg) == ["ck_parameters"] and aux == {}
    np.testing.assert_array_equal(arg["ck_parameters"].asnumpy(), packed)
    assert "ck_rnn" in sym.tojson()
    # the same file into the unfused stack: one array per cell weight
    stack = r.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(r.rnn.LSTMCell(4, prefix=f"ck_l{i}_"))
    _, arg, _ = r.rnn.load_rnn_checkpoint(stack, prefix, 1)
    assert sorted(arg) == sorted(f"ck_l{i}_{k}_{g}" for i in range(2)
                                 for k in ("i2h", "h2h")
                                 for g in ("weight", "bias"))


def test_do_rnn_checkpoint_every_period(tmp_path):
    cell = mt.rnn.FusedRNNCell(3, prefix="dc_")
    out, _ = cell.unroll(2, mt.sym.var("data"), merge_outputs=True)
    size = out.infer_shape(data=(1, 2, 2))[0][1]
    arg = {"dc_parameters": mt.nd.array(np.arange(np.prod(size),
                                                  dtype=np.float32),
                                        ctx=mt.cpu())}
    cb = mt.rnn.do_rnn_checkpoint(cell, str(tmp_path / "m"), period=2)
    for epoch in range(4):
        cb(epoch, out, arg, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["m-0002.params", "m-0004.params", "m-symbol.json"]
    _, args, _ = mx.model.load_checkpoint(str(tmp_path / "m"), 4)
    assert "dc_l0_i2h_weight" in args


def test_begin_state_concrete_shapes():
    """``begin_state(func=zeros, batch_size=N)`` puts the batch where the
    state shape has its 0, for plain and fused cells."""
    for pkg in (mx, mt):
        def zeros(name, shape, **kw):
            return pkg.sym.zeros(shape=shape, name=name)

        states = pkg.rnn.LSTMCell(5, prefix="bs_").begin_state(
            func=zeros, batch_size=4)
        assert [s.infer_shape()[1][0] for s in states] == [(4, 5), (4, 5)]
        fused = pkg.rnn.FusedRNNCell(3, num_layers=2, mode="lstm",
                                     bidirectional=True, prefix="bf_")
        assert [s.infer_shape()[1][0] for s in fused.begin_state(
            func=zeros, batch_size=4)] == [(4, 4, 3), (4, 4, 3)]
    with pytest.raises(mt.MXNetError):
        mt.rnn.LSTMCell(5).begin_state(func=mt.sym.zeros)


def test_rnn_unroll_default_inputs():
    def build(pkg):
        outs, _ = pkg.rnn.rnn_unroll(pkg.rnn.RNNCell(4, prefix="du_"), 3,
                                     input_prefix="pp_")
        return pkg.sym.Group(outs)
    ref, got = _both(build)
    assert got.tojson() == ref.tojson()
    assert {"pp_t0_data", "pp_t1_data", "pp_t2_data"} <= \
        set(got.list_arguments())


def test_rnn_exports_match_reference():
    assert mt.rnn.__all__ == mx.rnn.__all__
    for name in mx.rnn.__all__:
        assert hasattr(mt.rnn, name), name
    assert isinstance(mt.rnn.FusedRNNCell(2).params, mt.rnn.RNNParams)


def test_modifier_cell_shares_its_base_weights():
    base = mt.rnn.GRUCell(3, prefix="mb_")
    cell = mt.rnn.ResidualCell(base)
    assert cell.params is base.params
    with pytest.raises(mt.MXNetError):
        base.begin_state()
    assert len(cell.begin_state()) == 1


def test_fused_cell_weights_stay_on_their_device():
    """unpack/pack keep each array's tensor device (the card's arrays stay
    on the card); a numpy vector unpacks to CPU arrays."""
    cell = mt.rnn.FusedRNNCell(2, prefix="dv_")
    size = 4 * 2 * (3 + 2) + 2 * 4 * 2
    un = cell.unpack_weights({"dv_parameters": np.ones(size, np.float32)})
    assert all(v.data.device == torch.device("cpu") for v in un.values())
    assert cell.pack_weights(un)["dv_parameters"].shape == (size,)
