"""The port's third slice on the CPU: the legacy LSTM cells and MXNet's
PTB LSTM language model (`model_zoo.lstm_lm`, cut to vocab 50, embed 16,
hidden 16, 2 layers, T = 5, batch 3), held against the JAX package on the
same graph, weights and token ids.

With ``MXTPU_PALLAS=1`` both packages' ``pallas_select`` pass swaps every
LSTM cell onto ``_fused_lstm_gates`` (the Pallas kernel in interpret mode
on the JAX side, the Hopper kernel's plain version here)."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import graph_opt as jopt
from mxnet_tpu import serialization as jser
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import graph_opt
from mxnet_tpu_torch.model_zoo import PTB_LSTM, lstm_lm, random_params
from mxnet_tpu_torch.symbol import symbol as tsym

CFG = dict(num_layers=2, num_hidden=16, num_embed=16, vocab=50)
T, BATCH = 5, 3
SHAPES = {"data": (BATCH, T)}
# the reference's LSTM-gate tolerance (tests/test_pallas.py:68)
TOL = 1e-5


@pytest.fixture
def fresh_names():
    """Both packages' auto-name counters from zero, so two builds of one
    graph name their unnamed nodes alike; the counters come back after."""
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _both(build):
    """``build(pkg)`` with each package, counters reset before each."""
    out = []
    for pkg, names in ((mx, jsym._NAMES), (mt, tsym._NAMES)):
        names.counters.clear()
        out.append(build(pkg))
    return out


@pytest.mark.parametrize("cfg,seq", [(CFG, T), (PTB_LSTM, 10)],
                         ids=["tiny", "ptb"])
def test_lstm_lm_json_is_identical(fresh_names, cfg, seq):
    ref, got = _both(lambda pkg: lstm_lm(pkg, seq, **cfg))
    assert got.tojson() == ref.tojson()
    assert got.list_arguments() == ref.list_arguments()


@pytest.mark.parametrize("merge", [False, True])
def test_lstm_cell_unroll_matches_reference(fresh_names, merge):
    """One cell unrolled over a list of steps with given begin states, the
    other begin-state path of `unroll`."""
    def build(pkg):
        cell = pkg.rnn.LSTMCell(8, prefix="cell_")
        steps = [pkg.sym.var(f"x{i}") for i in range(3)]
        outs, states = cell.unroll(3, steps, begin_state=cell.begin_state(),
                                   merge_outputs=merge)
        outs = outs if merge else pkg.sym.Group(outs)
        return pkg.sym.Group([outs] + states)

    ref, got = _both(build)
    assert got.tojson() == ref.tojson()
    assert "cell_begin_state_0" in got.list_arguments()


def test_shared_weights_take_one_shape():
    sym = lstm_lm(mt, T, **CFG)
    arg_shapes, out_shapes, _ = sym.infer_shape(**SHAPES)
    shapes = dict(zip(sym.list_arguments(), arg_shapes))
    assert len(shapes) == len(sym.list_arguments())
    h = CFG["num_hidden"]
    for layer in range(CFG["num_layers"]):
        for kind in ("i2h", "h2h"):
            assert shapes[f"lstm_l{layer}_{kind}_weight"] == (4 * h, h)
            assert shapes[f"lstm_l{layer}_{kind}_bias"] == (4 * h,)
    assert out_shapes == [(BATCH * T, CFG["vocab"])]


@pytest.fixture(scope="module")
def model():
    """The JAX package's graph JSON and a `.params` blob of its weights."""
    sym = lstm_lm(mx, T, **CFG)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in SHAPES}, seed=0)
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in params.items()})
    data = np.random.RandomState(1).randint(
        0, CFG["vocab"], SHAPES["data"]).astype(np.float32)
    return sym.tojson(), blob, data


def _pallas_env(mode):
    old = os.environ.get("MXTPU_PALLAS")
    os.environ["MXTPU_PALLAS"] = mode
    return old


@pytest.fixture(scope="module")
def reference(model):
    """The JAX Predictor's output and ``pallas_select`` report, fused and
    unfused."""
    json_str, blob, data = model
    out = {}
    old = os.environ.get("MXTPU_PALLAS")
    try:
        for mode in ("1", "0"):
            os.environ["MXTPU_PALLAS"] = mode
            pred = JaxPredictor(json_str, blob, SHAPES)
            rep = [r for r in pred._program.opt_reports
                   if r.name == "pallas_select"][0]
            pred.forward(data=data)
            out[mode] = (rep, pred.get_output(0).asnumpy())
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS", None)
        else:
            os.environ["MXTPU_PALLAS"] = old
    return out


def _serve_port(model, monkeypatch, mode):
    json_str, blob, data = model
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    pred = mt.Predictor(json_str, blob, SHAPES, ctx=mt.cpu())
    rep = [r for r in pred._program.opt_reports
           if r.name == "pallas_select"][0]
    pred.forward(data=data)
    return pred, rep, pred.get_output(0).asnumpy()


def test_served_lm_matches_reference_fused(model, reference, monkeypatch):
    _, rep, out = _serve_port(model, monkeypatch, "1")
    ref_rep, ref_out = reference["1"]
    assert rep.rewrites == ref_rep.rewrites == 2 * T
    assert len(rep.details["lstm_sites"]) == \
        len(ref_rep.details["lstm_sites"]) == 2 * T
    assert "attention_sites" not in rep.details
    assert out.shape == (BATCH * T, CFG["vocab"])
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL)


def test_served_lm_matches_reference_unfused(model, reference, monkeypatch):
    _, rep, out = _serve_port(model, monkeypatch, "0")
    assert rep.rewrites == reference["0"][0].rewrites == 0
    np.testing.assert_allclose(out, reference["0"][1], rtol=TOL, atol=TOL)


def test_fused_lm_matches_unfused_and_runs_the_kernel_op(model, monkeypatch):
    pred, _, fused = _serve_port(model, monkeypatch, "1")
    _, _, unfused = _serve_port(model, monkeypatch, "0")
    np.testing.assert_allclose(fused, unfused, rtol=TOL, atol=TOL)
    nodes = [n for n in pred._program._run_symbol._nodes() if not n.is_var]
    ops = [n.op for n in nodes]
    assert ops.count("_fused_lstm_gates") == 2 * T
    # the dead gate math is gone: no 4-way slice, no activation, no mul
    assert not any(n.op == "SliceChannel" and
                   int(n.attrs["num_outputs"]) == 4 for n in nodes)
    assert "Activation" not in ops and "broadcast_mul" not in ops


def test_pallas_select_matches_reference_report(model, monkeypatch):
    """The two packages' ``pallas_select`` on the same JSON: 2·T rewrites
    and as many LSTM sites each, after the same cse (it merges each
    layer's two zero states)."""
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    json_str = model[0]
    ref = jopt.optimize(mx.sym.load_json(json_str), train=False,
                        shapes=SHAPES)
    ref_sel = [r for r in ref.reports if r.name == "pallas_select"][0]
    got = graph_opt.optimize(mt.sym.load_json(json_str), shapes=SHAPES,
                             device=torch.device("cpu"))
    sel = _select(got)
    assert sel.rewrites == ref_sel.rewrites == 2 * T
    assert len(sel.details["lstm_sites"]) == \
        len(ref_sel.details["lstm_sites"])
    assert sel.wall_ms > 0

    def slices(sym):
        return sorted(int(n.attrs["num_outputs"]) for n in sym._nodes()
                      if n.op in ("SliceChannel", "split"))
    assert slices(got.symbol) == slices(ref.symbol) == [T]


def _select(res):
    """The ``pallas_select`` report of a pipeline result."""
    return [r for r in res.reports if r.name == "pallas_select"][0]


def test_selector_gates_for_lstm_sites(model, monkeypatch):
    sym = mt.sym.load_json(model[0])
    # auto: only a CUDA device of capability (9, 0) gets the kernel
    monkeypatch.setenv("MXTPU_PALLAS", "auto")
    res = graph_opt.optimize(sym, shapes=SHAPES, device=torch.device("cpu"))
    assert _select(res).rewrites == 0 and "skipped" in _select(res).details
    # a dtype the kernel is not built for: swapped on the CPU, which runs
    # the plain version; a bind on the card fails rather than serve the
    # unfused graph unasked
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    half = {n: torch.float16 for n in sym.list_arguments()}
    res = graph_opt.optimize(sym, shapes=SHAPES, dtypes=half,
                             device=torch.device("cpu"))
    assert _select(res).rewrites == 2 * T
    with pytest.raises(mt.MXNetError, match="LSTM site .*MXTPU_PALLAS=0"):
        graph_opt.optimize(sym, shapes=SHAPES, dtypes=half,
                           device=torch.device("cuda"))
    # float32 and bfloat16 are the kernel's: the card's bind goes through
    for dt in (torch.float32, torch.bfloat16):
        res = graph_opt.optimize(
            sym, shapes=SHAPES, device=torch.device("cuda"),
            dtypes={n: dt for n in sym.list_arguments()})
        assert _select(res).rewrites == 2 * T
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    assert _select(graph_opt.optimize(sym, shapes=SHAPES, dtypes=half,
                                      device=torch.device("cuda"))
                   ).rewrites == 0


def test_one_blob_serves_every_bucket(model, monkeypatch):
    """`BucketingModule`'s way: one Predictor per bucket from one blob."""
    _, blob, _ = model
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    rng = np.random.RandomState(2)
    for seq in (2, 7):
        pred = mt.Predictor(lstm_lm(mt, seq, **CFG).tojson(), blob,
                            {"data": (BATCH, seq)}, ctx=mt.cpu())
        pred.forward(data=rng.randint(0, CFG["vocab"], (BATCH, seq))
                     .astype(np.float32))
        out = pred.get_output(0).asnumpy()
        assert out.shape == (BATCH * seq, CFG["vocab"])
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5, atol=1e-5)


def test_lm_predictor_without_ctx_needs_cuda(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="ctx=mx.cpu"):
        mt.Predictor(model[0], model[1], SHAPES)
