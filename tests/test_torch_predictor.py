"""The port's first slice end to end on the CPU: a 2-layer BERT-style
encoder served by `mxnet_tpu_torch.Predictor` against the JAX package's
`Predictor` on the same graph, weights and token ids.

With ``MXTPU_PALLAS=1`` both packages' ``pallas_select`` pass swaps each
layer's attention onto the flash-attention op (Pallas in interpret mode on
the JAX side, the Hopper kernel's plain version here); with ``0`` both run
the unfused batch_dot/softmax graph."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serialization as jser
from mxnet_tpu.predictor import Predictor as JaxPredictor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import graph_opt
from mxnet_tpu_torch.model_zoo import bert_encoder, random_params
from mxnet_tpu_torch.serialization import params_from_numpy

CFG = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
           max_len=128)
SHAPES = {"data": (2, 128), "positions": (1, 128)}
SHORT = {"data": (2, 64), "positions": (1, 64)}
FUSED_TOL = 2e-4      # the reference's forward-attention tolerance
UNFUSED_TOL = 1e-5    # the same ops in the same order on both sides
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(shapes, seed):
    rng = np.random.RandomState(seed)
    b, seq = shapes["data"]
    return {"data": rng.randint(0, CFG["vocab"], (b, seq)).astype(
                np.float32),
            "positions": np.arange(seq, dtype=np.float32)[None]}


def _reports(pred):
    return {r.name: r.rewrites for r in pred._program.opt_reports}


@pytest.fixture(scope="module")
def model():
    sym = bert_encoder(mx.sym, **CFG)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in SHAPES}, seed=0)
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in params.items()})
    return sym.tojson(), params, blob


@pytest.fixture(scope="module")
def reference(model):
    """The JAX Predictor's outputs, fused and unfused, at both shapes,
    with its pass reports."""
    json_str, _, blob = model
    out = {}
    old = os.environ.get("MXTPU_PALLAS")
    try:
        for mode in ("1", "0"):
            os.environ["MXTPU_PALLAS"] = mode
            pred = JaxPredictor(json_str, blob, SHAPES)
            reports = _reports(pred)
            pred.forward(**_requests(SHAPES, 1))
            long_out = pred.get_output(0).asnumpy()
            pred.reshape(SHORT)
            pred.forward(**_requests(SHORT, 2))
            out[mode] = (reports, long_out, pred.get_output(0).asnumpy())
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS", None)
        else:
            os.environ["MXTPU_PALLAS"] = old
    return out


def _serve_port(json_str, params, monkeypatch, mode):
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    pred = mt.Predictor(json_str, params, SHAPES, ctx=mt.cpu())
    reports = _reports(pred)
    pred.forward(**_requests(SHAPES, 1))
    long_out = pred.get_output(0).asnumpy()
    pred.reshape(SHORT)
    assert _reports(pred) == reports
    pred.set_input("data", _requests(SHORT, 2)["data"])
    pred.set_input("positions", _requests(SHORT, 2)["positions"])
    pred.forward()
    return reports, long_out, pred.get_output(0).asnumpy()


def test_reference_passes_that_wait_make_no_rewrites(reference):
    """fold_const, fold_bn, eliminate and cse rewrite nothing on this
    graph in the JAX package (and the port reports the same, below)."""
    reports = reference["1"][0]
    assert {k: reports[k] for k in ("fold_const", "fold_bn", "eliminate",
                                    "cse")} == dict.fromkeys(
        ("fold_const", "fold_bn", "eliminate", "cse"), 0)
    assert reports["pallas_select"] == CFG["num_layers"]
    assert reference["0"][0]["pallas_select"] == 0


@pytest.mark.parametrize("weights", ["blob", "numpy"])
def test_port_matches_reference_with_fused_attention(model, reference,
                                                     monkeypatch, weights):
    json_str, params, blob = model
    given = blob if weights == "blob" else {
        "arg:" + n: a for n, a in params_from_numpy(params, mt.cpu()).items()}
    reports, long_out, short_out = _serve_port(json_str, given, monkeypatch,
                                               "1")
    assert reports == reference["1"][0]
    assert reports["pallas_select"] == CFG["num_layers"]
    _, ref_long, ref_short = reference["1"]
    assert long_out.shape == (2, 128, CFG["hidden"])
    np.testing.assert_allclose(long_out, ref_long, rtol=FUSED_TOL,
                               atol=FUSED_TOL)
    np.testing.assert_allclose(short_out, ref_short, rtol=FUSED_TOL,
                               atol=FUSED_TOL)


def test_port_matches_reference_unfused(model, reference, monkeypatch):
    json_str, _, blob = model
    reports, long_out, short_out = _serve_port(json_str, blob, monkeypatch,
                                               "0")
    assert reports == reference["0"][0]
    assert reports["pallas_select"] == 0
    _, ref_long, ref_short = reference["0"]
    np.testing.assert_allclose(long_out, ref_long, rtol=UNFUSED_TOL,
                               atol=UNFUSED_TOL)
    np.testing.assert_allclose(short_out, ref_short, rtol=UNFUSED_TOL,
                               atol=UNFUSED_TOL)


def test_fused_graph_runs_the_kernel_op(model, monkeypatch):
    json_str, _, blob = model
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    pred = mt.Predictor(json_str, blob, SHAPES, ctx=mt.cpu())
    ops = [n.op for n in pred._program._run_symbol._nodes() if not n.is_var]
    assert ops.count("_fused_attention") == CFG["num_layers"]
    assert "softmax" not in ops and "batch_dot" not in ops
    # the op takes the (B*H, L, d) entries as they are: no reshape shims
    unfused = [n.op for n in mt.sym.load_json(json_str)._nodes()
               if not n.is_var]
    assert ops.count("reshape") == unfused.count("reshape")


def _select(res):
    """The ``pallas_select`` report of a pipeline result."""
    return [r for r in res.reports if r.name == "pallas_select"][0]


def test_selector_gates(model, monkeypatch):
    sym = mt.sym.load_json(model[0])
    # auto: only a CUDA device of capability (9, 0) gets the kernel
    monkeypatch.setenv("MXTPU_PALLAS", "auto")
    res = graph_opt.optimize(sym, shapes=SHAPES, device=torch.device("cpu"))
    assert _select(res).rewrites == 0 and "skipped" in _select(res).details
    # head dim 80: the JAX package's rule takes it, so the CPU graph swaps
    # both sites; the CUDA kernel lacks it, so a bind on the card fails
    # rather than quietly run unfused
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    wide = bert_encoder(mt.sym, **dict(CFG, hidden=320))
    res = graph_opt.optimize(wide, shapes=SHAPES, device=torch.device("cpu"))
    assert _select(res).rewrites == 2
    assert "fallback_sites" not in _select(res).details
    with pytest.raises(mt.MXNetError, match="MXTPU_PALLAS=0"):
        graph_opt.optimize(wide, shapes=SHAPES, device=torch.device("cuda"))
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    assert _select(graph_opt.optimize(wide, shapes=SHAPES,
                                      device=torch.device("cuda"))
                   ).rewrites == 0
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    # kill switches
    monkeypatch.setenv("MXTPU_GRAPH_OPT_SKIP", "pallas_select")
    assert [r.name for r in graph_opt.optimize(sym, shapes=SHAPES).reports] \
        == ["fold_const", "fold_bn", "eliminate", "cse"]
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "0")
    assert not graph_opt.optimize(sym, shapes=SHAPES).enabled


def _attention_graph(pkg):
    q, k, v = (pkg.sym.var(n) for n in "qkv")
    s = pkg.sym.batch_dot(q, k, transpose_b=True, name="scores")
    p = pkg.sym.softmax(s * 0.25, axis=-1, name="probs")
    return pkg.sym.batch_dot(p, v, name="attn")


@pytest.mark.parametrize("shape", [(15, 32, 16), (16, 32, 16)])
def test_selector_floor_matches_reference(shape, monkeypatch):
    """Near ``MXTPU_PALLAS_MIN_FLOPS`` (1e6) both packages count a site's
    flops alike, so both swap the same sites: the reference's count is
    1.044e6 at [15, 32, 16] (4·B·Lq·Lk·d alone would read 9.83e5)."""
    from mxnet_tpu import graph_opt as jopt
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    json_str = _attention_graph(mx).tojson()
    shapes = dict.fromkeys("qkv", shape)
    ref = _select(jopt.optimize(mx.sym.load_json(json_str), train=False,
                                shapes=shapes))
    got = _select(graph_opt.optimize(mt.sym.load_json(json_str),
                                     shapes=shapes,
                                     device=torch.device("cpu")))
    assert (got.rewrites, got.details) == (ref.rewrites, ref.details)
    assert got.rewrites == 1


def test_predictor_without_ctx_needs_cuda(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="ctx=mx.cpu"):
        mt.Predictor(model[0], model[2], SHAPES)


@pytest.mark.parametrize("entry", ["bind", "nd.array", "nd.zeros"])
def test_entry_points_without_ctx_need_cuda(entry, monkeypatch):
    """No entry point runs on the CPU unless the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = mt.sym.var("x")
    calls = {
        "bind": lambda: mt.sym.Activation(x, act_type="relu").bind(
            args={"x": mt.nd.zeros((2, 3), ctx=mt.cpu())}),
        "nd.array": lambda: mt.nd.array(np.ones((2, 3), np.float32)),
        "nd.zeros": lambda: mt.nd.zeros((2, 3)),
    }
    with pytest.raises(mt.MXNetError, match=f"{entry}: .*ctx=mx.cpu"):
        calls[entry]()


def test_bind_on_the_cpu_when_asked():
    x = mt.sym.var("x")
    exe = mt.sym.Activation(x, act_type="relu").bind(
        mt.cpu(), args={"x": mt.nd.array([[-1.0, 2.0]], ctx=mt.cpu())})
    assert exe.forward()[0].asnumpy().tolist() == [[0.0, 2.0]]
    assert exe.outputs[0].context == mt.cpu()


def test_predictor_validates_inputs(model):
    pred = mt.Predictor(model[0], model[2], SHAPES, ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="reshape"):
        pred.set_input("data", np.zeros((2, 64), np.float32))
    with pytest.raises(mt.MXNetError, match="not a declared input"):
        pred.set_input("word_embed_weight", np.zeros((2, 128), np.float32))
    with pytest.raises(mt.MXNetError, match="inputs not set"):
        pred.forward(data=np.zeros((2, 128), np.float32))
    with pytest.raises(mt.MXNetError, match="forward"):
        pred.get_output(0)
    assert pred.num_outputs == 1


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mxnet_tpu_torch, mxnet_tpu_torch.model_zoo, "
            "mxnet_tpu_torch.serialization, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.model_zoo.lstm_lm, chip_smoke; "
            "from mxnet_tpu_torch.model_zoo import lstm_lm; "
            "lstm_lm(mxnet_tpu_torch, 3); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu')))")
    r = subprocess.run([sys.executable, "-c", code, ROOT],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
