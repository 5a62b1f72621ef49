"""The port's generation runtime (`mxnet_tpu_torch.generation`) against
the JAX package's on the CPU, after `tests/test_generation.py`: the slot
arena (continuous decode bit-equal to the sequential oracle and to the
JAX package's tokens, each step's logits within 1e-5, programs built once
under admission churn, eos stopping slots), the DecodeService scheduler
under a fake clock (FIFO, deadline and priority refusals, the static
kill switch), the ``generate`` wire lane (either package's client), decode
blobs crossing between the packages both ways, the registry's
verification, and a PTB-shaped LSTM cell fused onto K4's plain version by
the port's `graph_opt` against the unfused cell in the JAX package."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import generation as jgen
from mxnet_tpu import serving as jserving

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch import telemetry as tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.generation import (DecodeCell, DecodeEngine,
                                        DecodeService,
                                        gen_continuous_enabled,
                                        is_decode_blob, load_decode_blob,
                                        make_tanh_rnn_cell,
                                        save_decode_blob)
from mxnet_tpu_torch.model_zoo import lm_weight_names, random_params
from mxnet_tpu_torch.predictor import CompiledBlobError, Predictor
from mxnet_tpu_torch.serialization import dumps_ndarrays
from mxnet_tpu_torch.serving import (CompiledModelPool, ModelServer,
                                     ServeClient, ServerDrainingError,
                                     ServerOverloadError)

VOCAB = 16
CPU = mt.cpu()
LOGIT_TOL = 1e-5      # the reference's single-op tolerance
LSTM_TOL = 1e-5       # K4's tolerance (tests/test_pallas.py)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiler.reset_gen_counters()
    yield


@pytest.fixture(scope="module")
def cell():
    return make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16, seed=0,
                              ctx=CPU)


@pytest.fixture(scope="module")
def jcell():
    return jgen.make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16, seed=0)


def _prompts(n, seed=3, lo=2, hi=8, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(lo, hi))
            .astype(np.int32) for _ in range(n)]


def _engine(cell, slots=2, chunk_steps=4, max_prompt=8, max_tokens=16,
            pkg=None):
    cls = DecodeEngine if pkg is None else pkg.DecodeEngine
    return cls(cell, slots=slots, chunk_steps=chunk_steps,
               max_prompt=max_prompt, max_tokens=max_tokens)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# the arena: parity, programs built once, eos
# ---------------------------------------------------------------------------

def test_continuous_decode_bitwise_vs_sequential_oracle(cell, jcell):
    eng = _engine(cell)
    prompts = _prompts(6)
    budgets = [3, 11, 5, 16, 8, 2]
    batched = eng.decode(prompts, budgets)
    oracle = eng.decode_sequential(prompts, budgets)
    ref = _engine(jcell, pkg=jgen).decode_sequential(prompts, budgets)
    for i, (a, b, r) in enumerate(zip(batched, oracle, ref)):
        assert a.dtype == np.int32 and len(a) == budgets[i]
        assert (a == b).all(), f"sequence {i} diverged"
        assert np.array_equal(a, r), f"sequence {i} off the reference"


def _step_logits(step_fn, params, state, tokens, as_input, to_np):
    """Logits of each step of ``step_fn`` fed ``tokens`` one at a time
    (a one-slot batch)."""
    out = []
    for t in tokens:
        state, logits = step_fn(params, state, as_input(t))
        out.append(to_np(logits)[0])
    return np.stack(out)


def test_decode_sequential_logits_match_reference(cell, jcell):
    """Both packages' oracles give the same tokens on the tanh cell, and
    each step's logits along the decoded stream agree within 1e-5."""
    import jax.numpy as jnp
    import torch
    prompts = _prompts(3, seed=17)
    budgets = [9, 4, 12]
    got = _engine(cell).decode_sequential(prompts, budgets)
    want = _engine(jcell, pkg=jgen).decode_sequential(prompts, budgets)
    for p, g, w in zip(prompts, got, want):
        assert np.array_equal(g, w)
        stream = np.concatenate([p, g[:-1]]).astype(np.int32)
        mine = _step_logits(
            cell.step_fn, cell.params,
            {"h": torch.zeros((1, 16))}, stream,
            lambda t: torch.tensor([t], dtype=torch.int32),
            lambda x: x.numpy())
        ref = _step_logits(
            jcell.step_fn, jcell.params,
            {"h": jnp.zeros((1, 16), jnp.float32)}, stream,
            lambda t: jnp.asarray([t], jnp.int32), np.asarray)
        np.testing.assert_allclose(mine, ref, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        # the generated tokens are the argmax of the logits that made them
        assert np.array_equal(mine[len(p) - 1:].argmax(-1), g)


def test_zero_retrace_under_admission_churn(cell):
    """20 churn cycles of ragged admissions and evictions through one
    arena: both programs are built exactly once, and the ``jit_traces``
    counter stays flat after warm-up."""
    eng = _engine(cell)
    eng.decode([np.zeros(1, np.int32)], [1])      # builds both programs
    assert eng.traces == 2
    profiler.reset_step_counters()
    rng = np.random.RandomState(11)
    for cycle in range(20):
        n = int(rng.randint(1, 5))
        prompts = _prompts(n, seed=cycle, lo=1, hi=8)
        budgets = [int(rng.randint(1, 16)) for _ in range(n)]
        eng.decode(prompts, budgets)
    c = profiler.step_counters()
    assert c.get("jit_traces", 0) == 0, c
    assert eng.traces == 2
    g = profiler.gen_counters()
    assert g["admits"] == g["evictions"] > 20


def test_eos_stops_in_trace_and_frees_the_slot(cell):
    """An eos hit clears the slot's bit on the device: the sequence ends
    mid-budget (eos its last token) and a queued request takes the freed
    slot -- a one-slot arena."""
    probe = _engine(cell, slots=1)
    p = _prompts(1, seed=5)[0]
    free_run = probe.decode([p], [10])[0]
    eos = int(free_run[2])
    eos_cell = make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16,
                                  seed=0, eos_id=eos, ctx=CPU)
    eng = _engine(eos_cell, slots=1)
    q = _prompts(1, seed=6)[0]
    outs = eng.decode([p, q], [10, 4])
    assert len(outs[0]) == 3 and int(outs[0][-1]) == eos
    assert (outs[0] == free_run[:3]).all()
    assert len(outs[1]) == 4
    assert eng.slots_active == 0
    assert profiler.gen_counters()["evictions"] >= 3
    jeng = _engine(jgen.make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16,
                                           seed=0, eos_id=eos),
                   slots=1, pkg=jgen)
    for a, b in zip(outs, jeng.decode([p, q], [10, 4])):
        assert np.array_equal(a, b)


def test_budget_validation(cell):
    eng = _engine(cell)
    with pytest.raises(MXNetError):
        eng.validate(np.zeros(0, np.int32), 4)
    with pytest.raises(MXNetError):
        eng.validate(np.zeros(9, np.int32), 4)
    with pytest.raises(MXNetError):
        eng.validate(np.zeros(2, np.int32), 17)
    with pytest.raises(MXNetError):
        eng.validate(np.zeros(2, np.int32), 0)


def test_cell_and_blob_default_to_the_card(tmp_path, monkeypatch):
    """No ``ctx`` means the card: without one the cell refuses to build
    rather than fall back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16)
    path = str(tmp_path / "c.mxdblob")
    save_decode_blob(path, make_tanh_rnn_cell(vocab=VOCAB, embed=8,
                                              hidden=16, ctx=CPU))
    with pytest.raises(MXNetError, match="no CUDA device"):
        load_decode_blob(path)
    with mt.cpu():
        assert load_decode_blob(path).device.type == "cpu"


def test_lower_step_fn_refuses_denied_ops(monkeypatch):
    """A cell naming a denied op (here by ``MXTPU_GRAPH_COMPILE_DENY``) is
    refused at lowering, in both packages, with the same message."""
    monkeypatch.setenv("MXTPU_GRAPH_COMPILE_DENY", "Embedding")
    with pytest.raises(MXNetError, match="cannot lower") as mine:
        make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16, ctx=CPU)
    with pytest.raises(mx.base.MXNetError) as ref:
        jgen.make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the scheduler: FIFO, deadline, priority (fake clock, hand pump)
# ---------------------------------------------------------------------------

def test_service_fifo_order_under_fake_clock(cell):
    clk = _Clock()
    eng = _engine(cell, slots=1)
    svc = DecodeService(eng, continuous=True, queue_limit=8,
                        clock=clk, start=False)
    prompts = _prompts(4, seed=8)
    futs = [svc.submit(p, 3) for p in prompts]
    finish_order = []
    for _ in range(200):
        clk.t += 0.01
        svc.pump_once()
        for i, f in enumerate(futs):
            if f.done() and i not in finish_order:
                finish_order.append(i)
        if len(finish_order) == 4:
            break
    assert finish_order == [0, 1, 2, 3]
    assert all(f.ttft_ms is not None and f.ttft_ms >= 0 for f in futs)
    svc.close()


def test_deadline_refusal_is_immediate_and_honest(cell):
    clk = _Clock()
    eng = _engine(cell, slots=1)
    svc = DecodeService(eng, continuous=True, queue_limit=8,
                        clock=clk, chunk_ms_hint=1000.0, start=False)
    backlog = [svc.submit(p, 8) for p in _prompts(4, seed=9)]
    est = svc.estimated_wait_ms()
    assert est > 50.0
    with pytest.raises(ServerOverloadError) as ei:
        svc.submit(_prompts(1, seed=10)[0], 8, deadline_ms=50.0)
    assert ei.value.retry_after_ms is not None
    assert 0 < ei.value.retry_after_ms <= 10_000.0
    g = profiler.gen_counters()
    assert g["deadline_refusals"] == 1
    kinds = [r.get("kind") for r in tele.flight_records()]
    assert "gen_deadline_refusal" in kinds
    fut = svc.submit(_prompts(1, seed=11)[0], 8,
                     deadline_ms=est * 100.0)
    assert not fut.done()
    svc.close()
    for f in backlog + [fut]:
        with pytest.raises((ServerDrainingError, MXNetError)):
            f.result(0)


def test_estimated_wait_matches_reference(cell, jcell):
    """The wait model is host logic: the same backlog and hint give the
    same estimate in both packages."""
    svcs = [DecodeService(_engine(cell, slots=2), queue_limit=8,
                          clock=_Clock(), chunk_ms_hint=7.0, start=False),
            jgen.DecodeService(_engine(jcell, slots=2, pkg=jgen),
                               queue_limit=8, clock=_Clock(),
                               chunk_ms_hint=7.0, start=False)]
    for s in svcs:
        for p in _prompts(5, seed=2):
            s.submit(p, 4)
    assert svcs[0].estimated_wait_ms() == svcs[1].estimated_wait_ms()
    assert svcs[0].stats() == svcs[1].stats()
    for s in svcs:
        s.close()


def test_full_queue_sheds_low_priority_first(cell):
    clk = _Clock()
    eng = _engine(cell, slots=1)
    svc = DecodeService(eng, continuous=True, queue_limit=2,
                        clock=clk, start=False)
    keep = svc.submit(_prompts(1, seed=1)[0], 4)
    victim = svc.submit(_prompts(1, seed=2)[0], 4, priority="low")
    admitted = svc.submit(_prompts(1, seed=3)[0], 4)
    with pytest.raises(ServerOverloadError):
        victim.result(0)
    assert not keep.done() and not admitted.done()
    assert profiler.gen_counters()["priority_sheds"] == 1
    with pytest.raises(ServerOverloadError) as ei:
        svc.submit(_prompts(1, seed=4)[0], 4, priority="low")
    assert ei.value.retry_after_ms is not None
    assert profiler.gen_counters()["sheds"] == 1
    svc.close()


def test_close_fails_queued_with_structured_error(cell):
    eng = _engine(cell, slots=1)
    svc = DecodeService(eng, continuous=True, queue_limit=8,
                        start=False)
    futs = [svc.submit(p, 4) for p in _prompts(3, seed=12)]
    svc.close()
    for f in futs:
        with pytest.raises((ServerDrainingError, MXNetError)):
            f.result(0)
    with pytest.raises(ServerDrainingError):
        svc.submit(_prompts(1, seed=13)[0], 4)


# ---------------------------------------------------------------------------
# the kill switch
# ---------------------------------------------------------------------------

def test_kill_switch_static_mode_bitwise_parity(cell):
    """MXTPU_GEN_CONTINUOUS=0 runs run-to-completion batches through the
    same chunk program: outputs stay bit-identical."""
    prompts = _prompts(6, seed=21)
    budgets = [3, 14, 5, 16, 2, 9]

    def run(continuous):
        eng = _engine(cell)
        svc = DecodeService(eng, continuous=continuous, queue_limit=16)
        try:
            futs = [svc.submit(p, m)
                    for p, m in zip(prompts, budgets)]
            return [f.result(timeout=60.0) for f in futs]
        finally:
            svc.close()

    cont, stat = run(True), run(False)
    for a, b in zip(cont, stat):
        assert a.shape == b.shape and (a == b).all()


def test_kill_switch_env(monkeypatch):
    assert gen_continuous_enabled()
    monkeypatch.setenv("MXTPU_GEN_CONTINUOUS", "0")
    assert not gen_continuous_enabled()
    eng = _engine(make_tanh_rnn_cell(vocab=VOCAB, embed=8, hidden=16,
                                     ctx=CPU))
    svc = DecodeService(eng, start=False)
    assert svc.continuous is False
    assert svc.stats()["gen_continuous"] is False
    svc.close()


def test_static_mode_refills_only_when_drained(cell):
    clk = _Clock()
    eng = _engine(cell, slots=2)
    svc = DecodeService(eng, continuous=False, queue_limit=8,
                        clock=clk, start=False)
    futs = [svc.submit(p, m) for p, m in
            zip(_prompts(3, seed=14), [2, 16, 2])]
    svc.pump_once()
    assert eng.slots_active == 2
    while not futs[0].done():
        svc.pump_once()
    assert eng.slots_active == 1 and not futs[2].done()
    while not futs[1].done():
        svc.pump_once()
    svc.pump_once()
    assert futs[2].done() or eng.slots_active == 1
    while not futs[2].done():
        svc.pump_once()
    svc.close()


# ---------------------------------------------------------------------------
# the wire lane
# ---------------------------------------------------------------------------

def _mlp_pool(batch=4):
    data = mt.sym.var("data")
    out = mt.sym.softmax(
        mt.sym.FullyConnected(data, num_hidden=3, name="fc"), name="out")
    rng = np.random.RandomState(0)
    params = dumps_ndarrays({
        "arg:fc_weight": mt.nd.array(rng.randn(3, 5).astype(np.float32),
                                     ctx=CPU),
        "arg:fc_bias": mt.nd.array(np.zeros(3, np.float32), ctx=CPU),
    })
    pred = Predictor(out.tojson(), params, {"data": (batch, 5)}, ctx=CPU)
    return CompiledModelPool(pred, batch_ladder=[batch], devices=[CPU])


@pytest.mark.parametrize("client", ["port", "reference"])
def test_generate_wire_lane_end_to_end(cell, client):
    """``generate`` through the ModelServer's decode lane, from either
    package's ServeClient: bit-equal to the sequential oracle, slot stats
    on the wire, the infer lane unaffected beside it."""
    eng = _engine(cell)
    svc = DecodeService(eng, continuous=True, queue_limit=16)
    prompts = _prompts(3, seed=31)
    oracle = _engine(cell).decode_sequential(prompts, [6, 6, 6])
    Client = ServeClient if client == "port" else jserving.ServeClient
    with ModelServer(_mlp_pool(), max_delay_ms=2.0,
                     decode=svc) as srv:
        host, port = srv.serve()
        with Client(host, port, retry_deadline=5.0) as cli:
            for p, want in zip(prompts, oracle):
                got = cli.generate(p, max_new_tokens=6)
                assert np.asarray(got).dtype == np.int32
                assert (np.asarray(got) == want).all()
            x = np.random.RandomState(1).rand(4, 5).astype(np.float32)
            assert cli.infer({"data": x})[0].shape == (4, 3)
            st = cli.stats()
            assert st["gen_slots"] == 2 and st["gen_queue"] == 0
            assert st["gen_continuous"] in (True, 1)
        assert np.array_equal(srv.generate(prompts[0], 6), oracle[0])
    g = profiler.gen_counters()
    assert g["requests"] == 4 and g["ttft_ms_p99"] >= 0.0


def test_generate_without_decode_lane_is_bad_request():
    with ModelServer(_mlp_pool(), max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            with pytest.raises(MXNetError, match="no decode lane"):
                cli.generate(np.array([1, 2], np.int32),
                             max_new_tokens=4)
        with pytest.raises(MXNetError, match="no decode lane"):
            srv.generate(np.array([1, 2], np.int32), 4)


# ---------------------------------------------------------------------------
# decode blobs + registry
# ---------------------------------------------------------------------------

def test_decode_blob_roundtrip_bitwise(cell, tmp_path):
    path = str(tmp_path / "cell.mxdblob")
    crc = save_decode_blob(path, cell)
    assert crc and is_decode_blob(path)
    loaded = load_decode_blob(path, ctx=CPU)
    assert loaded.vocab_size == cell.vocab_size
    prompts = _prompts(3, seed=41)
    want = _engine(cell).decode_sequential(prompts, [5, 5, 5])
    got = _engine(loaded).decode_sequential(prompts, [5, 5, 5])
    for a, b in zip(want, got):
        assert (a == b).all()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_decode_blob_crosses_packages(cell, jcell, tmp_path, writer):
    """A decode blob written by either package loads in the other and
    decodes the same tokens; the two writers' files are byte-equal."""
    mine, ref = str(tmp_path / "port.mxdblob"), str(tmp_path / "ref.mxdblob")
    save_decode_blob(mine, cell)
    jgen.save_decode_blob(ref, jcell)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    prompts = _prompts(3, seed=43)
    if writer == "port":
        loaded = jgen.load_decode_blob(mine)
        got = _engine(loaded, pkg=jgen).decode_sequential(prompts,
                                                          [6, 6, 6])
    else:
        loaded = load_decode_blob(ref, ctx=CPU)
        got = _engine(loaded).decode_sequential(prompts, [6, 6, 6])
    want = _engine(cell).decode_sequential(prompts, [6, 6, 6])
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b)


def test_decode_blob_rejects_rot(cell, tmp_path):
    path = str(tmp_path / "cell.mxdblob")
    save_decode_blob(path, cell)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = str(tmp_path / "rot.mxdblob")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(CompiledBlobError):
        load_decode_blob(bad, ctx=CPU)
    assert not is_decode_blob(str(tmp_path / "missing.mxdblob"))


def test_registry_verifies_decode_blobs(cell, tmp_path):
    from mxnet_tpu_torch.serving_fleet import ModelRegistry
    path = str(tmp_path / "gen-v1.mxdblob")
    save_decode_blob(path, cell)
    reg = ModelRegistry()
    reg.register("gen-v1", path)
    got_path, crc = reg.resolve("gen-v1")
    assert got_path == path and crc
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    bad = str(tmp_path / "gen-bad.mxdblob")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(MXNetError):
        reg.register("gen-bad", bad)


# ---------------------------------------------------------------------------
# the PTB-shaped LSTM cell: fused onto K4 in the port, unfused reference
# ---------------------------------------------------------------------------

LSTM = dict(num_layers=2, hidden=16, embed=16, vocab=32)
SLOTS = 4


def lstm_cell_symbol(pkg, num_layers, hidden, embed, vocab):
    """One step of MXNet's PTB LSTM LM with package ``pkg``: heads
    ``[logits, h0', c0', h1', c1', ...]`` of ``rnn.LSTMCell``s fed the
    token and the state variables ``h<i>``, ``c<i>``."""
    sym = pkg.sym
    x = sym.Embedding(sym.var("token"), input_dim=vocab,
                      output_dim=embed, name="embed")
    states = []
    for i in range(num_layers):
        cell = pkg.rnn.LSTMCell(num_hidden=hidden, prefix=f"lstm_l{i}_")
        x, (h, c) = cell(x, [sym.var(f"h{i}"), sym.var(f"c{i}")])
        states += [h, c]
    logits = sym.FullyConnected(x, num_hidden=vocab, name="pred")
    return sym.Group([logits] + states)


def _lstm_weights(cfg):
    sym = lstm_cell_symbol(mt, **cfg)
    shapes = {"token": (SLOTS,)}
    for i in range(cfg["num_layers"]):
        shapes[f"h{i}"] = shapes[f"c{i}"] = (SLOTS, cfg["hidden"])
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    names = set(lm_weight_names(cfg["num_layers"]))
    return random_params({n: s for n, s in zip(sym.list_arguments(),
                                                arg_shapes)
                          if n in names}, 0), shapes


def test_ptb_shaped_lstm_cell_fused_matches_reference(monkeypatch):
    """The port's cell rewritten by `graph_opt` under MXTPU_PALLAS=1 (both
    LSTM sites on `_fused_lstm_gates`, K4's plain version on the CPU)
    decodes the same tokens as the JAX package's unfused cell, each
    step's logits within 1e-5, continuous equal to sequential."""
    import torch
    from mxnet_tpu_torch import graph_opt
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    monkeypatch.setenv("MXTPU_PALLAS", "1")
    params, shapes = _lstm_weights(LSTM)
    order = [f"{k}{i}" for i in range(LSTM["num_layers"]) for k in "hc"]
    specs = {n: ((LSTM["hidden"],), np.float32) for n in order}
    res = graph_opt.optimize(lstm_cell_symbol(mt, **LSTM), shapes=shapes,
                             device=torch.device("cpu"))
    ops = [n["op"] for n in __import__("json").loads(
        res.symbol.tojson())["nodes"]]
    assert ops.count("_fused_lstm_gates") == LSTM["num_layers"]
    feed = dict(params)
    feed.update({k: v.numpy() for k, v in res.const_feed.items()})
    fused = DecodeCell.from_symbol(res.symbol, feed, specs, LSTM["vocab"],
                                   state_order=order, ctx=CPU)
    ref = jgen.DecodeCell.from_symbol(
        lstm_cell_symbol(mx, **LSTM), params, specs, LSTM["vocab"],
        state_order=order)
    prompts = _prompts(6, seed=51, lo=1, hi=8, vocab=LSTM["vocab"])
    budgets = [12, 3, 16, 7, 1, 9]
    calls = []
    plain = hk._lstm_gates_plain

    def counted(g, c):
        calls.append(g.shape)
        return plain(g, c)
    monkeypatch.setattr(hk, "_lstm_gates_plain", counted)
    eng = _engine(fused, slots=SLOTS)
    got = eng.decode(prompts, budgets)
    assert calls and all(s == (SLOTS, 4 * LSTM["hidden"]) for s in calls)
    seq = eng.decode_sequential(prompts, budgets)
    want = _engine(ref, slots=SLOTS, pkg=jgen).decode_sequential(prompts,
                                                                  budgets)
    for g, s, w in zip(got, seq, want):
        assert np.array_equal(g, s) and np.array_equal(g, np.asarray(w))
    # each step's logits along one decoded stream, slot 0 of the arena
    import jax.numpy as jnp
    stream = np.concatenate([prompts[0], got[0][:-1]]).astype(np.int32)
    zeros = {n: np.zeros((SLOTS, LSTM["hidden"]), np.float32)
             for n in order}
    mine = _step_logits(
        fused.step_fn, fused.params,
        {n: torch.from_numpy(z) for n, z in zeros.items()}, stream,
        lambda t: torch.full((SLOTS,), int(t), dtype=torch.int32),
        lambda x: x.numpy())
    theirs = _step_logits(
        ref.step_fn, ref.params,
        {n: jnp.asarray(z) for n, z in zeros.items()}, stream,
        lambda t: jnp.full((SLOTS,), int(t), jnp.int32), np.asarray)
    np.testing.assert_allclose(mine, theirs, rtol=LSTM_TOL, atol=LSTM_TOL)
