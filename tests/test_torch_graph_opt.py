"""The port's graph optimizer against the JAX package's, on the CPU: the
same graph JSON through both packages' ``optimize``, for the inference
pass list and both training lists, on four graphs (a 2-layer narrow BERT
encoder, the LSTM LM, an FC + BatchNorm net, and a net of constants,
transpose pairs and duplicate subexpressions).  The reports agree one to
one (name, nodes before and after, rewrites, details, parity label), and
the optimized graphs' outputs agree within 1e-5, or bit for bit where the
pass is labelled ``bitwise``."""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import graph_opt as jopt
from mxnet_tpu.executor import build_graph_fn as jbuild

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import graph_opt
from mxnet_tpu_torch.executor import build_graph_fn
from mxnet_tpu_torch.model_zoo import bert_encoder, lstm_lm

TOL = 1e-5


def _fc_bn(pkg):
    d = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(d, num_hidden=8, name="fc1")
    h = pkg.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=5, no_bias=True, name="fc2")
    return pkg.sym.BatchNorm(h, name="bn2")


def _consts(pkg):
    """Constants to fold, transpose/swapaxes/reshape pairs to eliminate,
    identity and BlockGrad to forward, and duplicates to merge."""
    s = pkg.sym
    d = s.var("data")
    row = s.reshape(s._arange(start=0, stop=6), shape=(1, 6))
    c = s.broadcast_add(s._eye(N=6), s._ones(shape=(6, 6)))
    x = s.broadcast_add(s.batch_dot(s.expand_dims(d, axis=0),
                                    s.expand_dims(c, axis=0)),
                        s.expand_dims(row, axis=0))
    x = s.transpose(s.transpose(x, axes=(0, 2, 1)), axes=(0, 2, 1))
    x = s.transpose(x, axes=(0, 1, 2))
    x = s.swapaxes(s.swapaxes(x, dim1=1, dim2=2), dim1=2, dim2=1)
    x = s.reshape(s.reshape(x, shape=(2, 12)), shape=(4, 6))
    x = s.BlockGrad(s.identity(x))
    a = s.Activation(x, act_type="tanh")
    b = s.Activation(x, act_type="tanh")
    half = s._full(shape=(1, 6), value=0.5)
    return s.broadcast_mul(s.broadcast_add(a, b), half)


BERT = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
            max_len=128)
#: name -> (graph function of a package, input shapes, vocabulary of integer
#: ``data`` or None)
GRAPHS = {
    "bert": (lambda p: bert_encoder(p.sym, **BERT),
             {"data": (2, 128), "positions": (1, 128)}, BERT["vocab"]),
    "lstm_lm": (lambda p: lstm_lm(p, 5, num_layers=2, num_hidden=16,
                                  num_embed=16, vocab=50),
                {"data": (3, 5)}, 50),
    "fc_bn": (_fc_bn, {"data": (4, 6)}, None),
    "consts": (_consts, {"data": (4, 6)}, None),
}
MODES = {"infer": ("1", False), "train_unified": ("1", True),
         "train_legacy": ("0", True)}


@pytest.fixture(scope="module")
def graphs():
    """Each graph built once by the JAX package, with its JSON."""
    out = {}
    for name, (build, shapes, vocab) in GRAPHS.items():
        sym = build(mx)
        out[name] = (sym, sym.tojson(), shapes, vocab)
    return out


def _feed(sym, shapes, vocab, seed):
    """Random inputs, parameters and aux states (moving_var positive)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    feed = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n == "data" and vocab:
            feed[n] = rng.randint(0, vocab, s).astype(np.float32)
        elif n == "positions":
            feed[n] = np.arange(s[-1], dtype=np.float32)[None]
        else:
            feed[n] = (rng.randn(*s) * 0.3).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        feed[n] = (np.abs(rng.randn(*s)) * 0.3 + 0.5 if n.endswith("var")
                   else rng.randn(*s) * 0.1).astype(np.float32)
    return feed


def _reports(res):
    return [(r.name, r.nodes_before, r.nodes_after, r.rewrites, r.parity,
             r.details) for r in res.reports]


def _both(json_str, shapes, train, monkeypatch, unified="1"):
    monkeypatch.setenv("MXTPU_UNIFIED_STEP", unified)
    ref = jopt.optimize(mx.sym.load_json(json_str), train=train,
                        shapes=shapes)
    got = graph_opt.optimize(mt.sym.load_json(json_str), shapes=shapes,
                             device=torch.device("cpu"), train=train)
    return ref, got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pass_reports_match_reference(graphs, graph, mode, monkeypatch):
    """With ``MXTPU_PALLAS=0``, as both packages' kernel gate reads it."""
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    _, json_str, shapes, _ = graphs[graph]
    unified, train = MODES[mode]
    ref, got = _both(json_str, shapes, train, monkeypatch, unified)
    assert _reports(got) == _reports(ref)
    assert [r.name for r in got.reports] == list(
        graph_opt.train_passes() if train else graph_opt.INFER_PASSES)
    assert sorted(got.const_feed) == sorted(ref.const_feed)
    for k in ref.const_feed:
        assert np.array_equal(got.const_feed[k].numpy(),
                              np.asarray(ref.const_feed[k]))


def test_the_passes_rewrite_each_test_graph(graphs, monkeypatch):
    """What the reference rewrites on the four graphs, so the comparison
    above holds real rewrites: constants, BN folds, eliminations and
    merges."""
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    fired = {}
    for name, (_, json_str, shapes, _) in graphs.items():
        _, got = _both(json_str, shapes, False, monkeypatch)
        fired[name] = {r.name: r.rewrites for r in got.reports}
    assert fired["consts"]["fold_const"] >= 2
    assert fired["consts"]["eliminate"] >= 5
    assert fired["consts"]["cse"] >= 1
    assert fired["fc_bn"]["fold_bn"] == 2
    assert fired["lstm_lm"]["cse"] >= 1


@pytest.mark.parametrize("graph", ["bert", "lstm_lm"])
def test_kernel_selection_reports_match_reference(graphs, graph,
                                                  monkeypatch):
    """With ``MXTPU_PALLAS=1`` both packages swap the same sites with the
    same details.  A rank-3 attention site costs the reference four
    reshape shims that the port's op does not need, so nodes after the
    pass differ by four per attention site and by nothing else."""
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    _, json_str, shapes, _ = graphs[graph]
    ref, got = _both(json_str, shapes, False, monkeypatch)
    r_ref, r_got = _reports(ref), _reports(got)
    assert r_got[:-1] == r_ref[:-1]
    sel_ref, sel = ref.reports[-1], got.reports[-1]
    assert (sel.name, sel.rewrites, sel.parity, sel.details,
            sel.nodes_before) == (sel_ref.name, sel_ref.rewrites,
                                  sel_ref.parity, sel_ref.details,
                                  sel_ref.nodes_before)
    sites = len(sel.details.get("attention_sites", []))
    assert sel.rewrites > 0
    assert sel_ref.nodes_after - sel.nodes_after == 4 * sites


def _run_ref(sym, feed, train):
    outs, aux = jbuild(sym, train)(
        {k: jax.numpy.asarray(v) for k, v in feed.items()},
        jax.random.PRNGKey(0))
    return [np.asarray(o) for o in outs], {k: np.asarray(v)
                                           for k, v in aux.items()}


def _run_port(sym, feed, train, seed=0):
    gen = torch.Generator().manual_seed(seed)
    outs, aux = build_graph_fn(sym, train)(
        {k: torch.as_tensor(np.asarray(v)) for k, v in feed.items()}, gen)
    return [o.numpy() for o in outs], {k: v.numpy() for k, v in aux.items()}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_optimized_inference_graph_matches_reference(graphs, graph,
                                                     monkeypatch):
    """The optimized graphs give the reference's outputs within 1e-5, and
    the port's optimized graph gives the port's unoptimized one bit for
    bit when every pass that fired is labelled ``bitwise``."""
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    sym, json_str, shapes, vocab = graphs[graph]
    ref, got = _both(json_str, shapes, False, monkeypatch)
    feed = _feed(sym, shapes, vocab, seed=5)
    want, _ = _run_ref(ref.symbol, {**feed, **{
        k: np.asarray(v) for k, v in ref.const_feed.items()}}, False)
    out, _ = _run_port(got.symbol, {**feed, **{
        k: v.numpy() for k, v in got.const_feed.items()}}, False)
    plain, _ = _run_port(mt.sym.load_json(json_str), feed, False)
    for o, w, p in zip(out, want, plain):
        np.testing.assert_allclose(o, w, rtol=TOL, atol=TOL)
        if all(r.parity == "bitwise" for r in got.reports if r.rewrites):
            assert np.array_equal(o, p)
        else:
            np.testing.assert_allclose(o, p, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("unified", ["1", "0"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_optimized_training_graph_is_bitwise(graphs, graph, unified,
                                             monkeypatch):
    """A training list's graph gives the unoptimized graph's train-mode
    outputs and aux updates bit for bit, dropout masks included (the
    same stream, the same random nodes in the same order)."""
    sym, json_str, shapes, vocab = graphs[graph]
    _, got = _both(json_str, shapes, True, monkeypatch, unified)
    feed = _feed(sym, shapes, vocab, seed=6)
    out, aux = _run_port(got.symbol, feed, True)
    plain, plain_aux = _run_port(mt.sym.load_json(json_str), feed, True)
    for o, p in zip(out, plain):
        assert np.array_equal(o, p)
    assert set(aux) == set(plain_aux)
    for k in aux:
        assert np.array_equal(aux[k], plain_aux[k])


def test_fold_const_respects_the_size_cap(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_OPT_FOLD_MAX_MB", "0")
    net = mt.sym.broadcast_add(mt.sym.var("data"),
                               mt.sym.ones(shape=(8, 8)))
    rep = graph_opt.optimize(net).reports[0]
    assert rep.name == "fold_const" and rep.rewrites == 0
    assert "MXTPU_GRAPH_OPT_FOLD_MAX_MB=0" in rep.details["skipped"]


def test_program_feeds_the_folded_constants(graphs, monkeypatch):
    """`GraphProgram` merges the ``const_feed`` into every feed: a
    Predictor of the constants graph serves the unoptimized outputs."""
    sym, json_str, shapes, _ = graphs["consts"]
    feed = _feed(sym, shapes, None, seed=7)
    pred = mt.Predictor(json_str, {}, shapes, ctx=mt.cpu())
    assert pred._program.const_feed
    pred.forward(data=feed["data"])
    plain, _ = _run_port(mt.sym.load_json(json_str), feed, False)
    assert np.array_equal(pred.get_output(0).asnumpy(), plain[0])


@pytest.mark.parametrize("shape", [
    ((15, 32, 16), (15, 32, 16)), ((16, 32, 16), (16, 32, 16)),
    ((8, 12, 128, 64), (8, 12, 128, 64)), ((4, 16, 8), (4, 48, 8)),
    ((2, 3, 40, 32), (2, 3, 24, 32)), ((3, 5, 7), (3, 9, 7)),
    ((1, 1, 1), (1, 1, 1)), ((8, 12, 512, 64), (8, 12, 512, 64))])
def test_attention_flops_equal_the_reference(shape):
    """The reference reads XLA's cost analysis; the port its closed form."""
    q, k = shape
    assert graph_opt._attention_flops(q, k, k) == \
        jopt._attention_flops(q, k, k)


def test_train_invariants_reject_a_lost_output():
    a = mt.sym.var("a")
    two = mt.sym.Group([mt.sym.tanh(a), mt.sym.sigmoid(a)])
    with pytest.raises(mt.MXNetError, match="output count"):
        graph_opt._check_train_invariants(two, mt.sym.tanh(a))


def test_predictor_serves_a_folded_batchnorm_like_the_reference(
        graphs, monkeypatch):
    """The FC + BatchNorm net through both packages' `Predictor` with
    ``aux:`` states in the blob: ``fold_bn`` rewrites both BatchNorms in
    each, and the outputs agree within 1e-5."""
    from mxnet_tpu import serialization as jser
    from mxnet_tpu.predictor import Predictor as JaxPredictor
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    sym, json_str, shapes, _ = graphs["fc_bn"]
    feed = _feed(sym, shapes, None, seed=9)
    aux = set(sym.list_auxiliary_states())
    blob = jser.dumps_ndarrays({("aux:" if n in aux else "arg:") + n:
                                mx.nd.array(v) for n, v in feed.items()
                                if n != "data"})
    outs = []
    for make in (lambda: JaxPredictor(json_str, blob, shapes),
                 lambda: mt.Predictor(json_str, blob, shapes,
                                      ctx=mt.cpu())):
        pred = make()
        rep = {r.name: r.rewrites for r in pred._program.opt_reports}
        assert rep["fold_bn"] == 2
        pred.forward(data=feed["data"])
        outs.append(pred.get_output(0).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)
