"""The port's serving plane (`mxnet_tpu_torch.serving`, `Predictor`'s
deploy blob) against the JAX package's on the CPU: the batching core as
pure logic (flush decisions bit-equal to the reference's under one fake
clock), the pool's padding and static-buffer contract, the pool on an MLP
and a 2-layer BERT at every rung within 2e-4 of the JAX package's pool,
the dispatcher, the wire front door, hot swap and rollback, the trace id
over the wire, and the blob's parse discipline (a JAX ``MXCBLOB1`` blob is
refused by name)."""
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu import serialization as jser
from mxnet_tpu.predictor import Predictor as JaxPredictor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler, serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model_zoo import bert_encoder, random_params
from mxnet_tpu_torch.predictor import CompiledBlobError, Predictor
from mxnet_tpu_torch.serialization import dumps_ndarrays
from mxnet_tpu_torch.serving import (CompiledModelPool, ModelServer,
                                     ServeClient,
                                     ServerDrainingError,
                                     ServerOverloadError, parse_ladder,
                                     rung_for)

POOL_TOL = 2e-4       # the reference's forward-attention tolerance
MLP_TOL = 1e-5        # the same ops in the same order on both sides
LADDER = [1, 2, 4, 8]
BERT = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
            max_len=128)
SEQ = 128
BERT_LADDER = [1, 2, 4]


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _mlp_json(sym_mod):
    data = sym_mod.var("data")
    fc1 = sym_mod.FullyConnected(data, num_hidden=8, name="fc1")
    act = sym_mod.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym_mod.FullyConnected(act, num_hidden=3, name="fc2")
    return sym_mod.softmax(fc2, name="out").tojson()


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32),
            "fc1_bias": rng.randn(8).astype(np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}


def _mlp_blob(seed=0):
    return dumps_ndarrays({"arg:" + n: mt.nd.array(a, ctx=mt.cpu())
                           for n, a in _mlp_params(seed).items()})


def _mlp_predictor(batch=4, seed=0):
    return Predictor(_mlp_json(mt.sym), _mlp_blob(seed), {"data": (batch, 5)},
                     ctx=mt.cpu())


def _pool(source, ladder=LADDER):
    return CompiledModelPool(source, batch_ladder=ladder, devices=[mt.cpu()])


@pytest.fixture(scope="module")
def mlp_pool():
    return _pool(_mlp_predictor())


@pytest.fixture(scope="module")
def jax_mlp_pool():
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in _mlp_params().items()})
    pred = JaxPredictor(_mlp_json(mx.sym), blob, {"data": (4, 5)})
    return jserving.CompiledModelPool(pred, batch_ladder=LADDER,
                                      devices=[mx.cpu().jax_device])


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_PATH", os.devnull)
    telemetry.reset()
    yield
    telemetry.reset()


# ---------------------------------------------------------------------------
# pure logic: ladder + rung selection, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["1,2,4,8,16", "8, 2 ,2,1", "3", "16,1"])
def test_parse_ladder_matches_reference(spec):
    assert parse_ladder(spec) == jserving.parse_ladder(spec)


@pytest.mark.parametrize("spec", ["1,two,4", "0,4", "", "-1,2"])
def test_parse_ladder_refuses_like_reference(spec):
    with pytest.raises(MXNetError):
        parse_ladder(spec)
    with pytest.raises(mx.base.MXNetError):
        jserving.parse_ladder(spec)


def test_parse_ladder_default_is_the_knob():
    assert parse_ladder() == [1, 2, 4, 8, 16] == jserving.parse_ladder()


@pytest.mark.parametrize("n", range(1, 20))
def test_rung_selection_matches_reference(n):
    assert rung_for(n, LADDER) == jserving.rung_for(n, LADDER)


# ---------------------------------------------------------------------------
# pure logic: the micro-batching queue, in both packages
# ---------------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture(params=["torch", "jax"])
def qmod(request):
    return serving if request.param == "torch" else jserving


def _queue(mod, max_batch=8, max_delay_ms=5.0, queue_limit=32):
    clk = _FakeClock()
    q = mod.MicroBatchQueue(max_batch=max_batch, max_delay_ms=max_delay_ms,
                            queue_limit=queue_limit, clock=clk)
    return q, clk


def test_queue_flushes_on_max_batch_before_deadline(qmod):
    q, clk = _queue(qmod, max_batch=4, max_delay_ms=1000.0)
    q.submit("a", 2)
    assert q.ready() is None
    q.submit("b", 2)
    assert q.ready() == "max_batch"
    batch, reason = q.pop_batch()
    assert reason == "max_batch"
    assert [e.item for e in batch] == ["a", "b"]
    assert q.pending_rows == 0


def test_queue_flushes_on_deadline_when_part_full(qmod):
    q, clk = _queue(qmod, max_batch=8, max_delay_ms=5.0)
    q.submit("a", 2)
    assert q.next_deadline() == pytest.approx(clk.t + 0.005)
    clk.t += 0.004
    assert q.ready() is None
    clk.t += 0.002
    assert q.ready() == "deadline"
    batch, reason = q.pop_batch()
    assert reason == "deadline" and len(batch) == 1


def test_queue_max_batch_reason_wins_when_both_hold(qmod):
    q, clk = _queue(qmod, max_batch=2, max_delay_ms=1.0)
    q.submit("a", 2)
    clk.t += 10.0
    assert q.ready() == "max_batch"


def test_queue_packs_fifo_and_leaves_remainder(qmod):
    q, clk = _queue(qmod, max_batch=4)
    q.submit("a", 2)
    q.submit("b", 3)
    q.submit("c", 1)
    clk.t += 1.0
    batch, _ = q.pop_batch()
    assert [e.item for e in batch] == ["a"]
    assert q.pending_rows == 4
    batch, _ = q.pop_batch()
    assert [e.item for e in batch] == ["b", "c"]


def test_queue_oversized_request_rides_alone(qmod):
    q, clk = _queue(qmod, max_batch=4, queue_limit=32)
    q.submit("big", 11)
    assert q.ready() == "max_batch"
    batch, _ = q.pop_batch()
    assert [e.item for e in batch] == ["big"]


def test_queue_bounded_shed(qmod):
    q, clk = _queue(qmod, max_batch=4, queue_limit=8)
    q.submit("a", 6)
    with pytest.raises(qmod.ServerOverloadError) as ei:
        q.submit("b", 3)
    assert (ei.value.requested, ei.value.pending_rows, ei.value.limit) == \
        (3, 6, 8)
    assert q.pending_rows == 6
    q.submit("c", 2)
    assert q.pending_rows == 8


def test_queue_drain_refuses_then_reopens(qmod):
    q, clk = _queue(qmod, max_batch=8, max_delay_ms=5.0)
    q.submit("a", 2)
    q.begin_drain()
    with pytest.raises(qmod.ServerDrainingError) as ei:
        q.submit("b", 3)
    assert (ei.value.requested, ei.value.pending_rows) == (3, 2)
    clk.t += 0.006
    assert q.ready() == "deadline"  # a drain never strands queued rows
    q.pop_batch()
    q.end_drain()
    q.submit("c", 1)
    assert q.pending_rows == 1


def test_queue_rejects_zero_row_request(qmod):
    q, _ = _queue(qmod)
    with pytest.raises(Exception, match="0-row"):
        q.submit("a", 0)


@pytest.mark.parametrize("seed", range(6))
def test_queue_flush_decisions_bit_equal_to_reference(seed):
    """A seeded random trace of submits, clock advances, polls and pops
    under one fake clock: every decision (ready reason, next deadline,
    popped items, pending rows, shed or not) equals the reference's."""
    rng = np.random.RandomState(seed)
    knobs = dict(max_batch=int(rng.randint(1, 9)),
                 max_delay_ms=float(rng.choice([0.5, 2.0, 5.0])),
                 queue_limit=int(rng.randint(8, 40)))
    qs = [_queue(m, **knobs) for m in (serving, jserving)]
    log = [[], []]
    for step in range(200):
        kind = rng.randint(4)
        rows = int(rng.randint(1, 12))
        dt = float(rng.rand() * 0.004)
        for k, (q, clk) in enumerate(qs):
            if kind == 0:
                try:
                    q.submit(step, rows)
                    log[k].append(("ok", q.pending_rows))
                except Exception as e:  # shed
                    log[k].append((type(e).__name__, q.pending_rows))
            elif kind == 1:
                clk.t += dt
                log[k].append(("t", q.ready(), q.next_deadline()))
            elif kind == 2:
                batch, reason = q.pop_batch()
                log[k].append(("pop", reason, [e.item for e in batch],
                               q.pending_rows))
            else:
                (q.begin_drain if rows % 5 == 0 else q.end_drain)()
                log[k].append(("drain", q.draining))
    assert log[0] == log[1]


# ---------------------------------------------------------------------------
# the pool: padding masked out, static buffers, parity with the reference
# ---------------------------------------------------------------------------

def test_pool_without_cuda_raises_unless_given_devices():
    with pytest.raises(MXNetError, match="no CUDA device"):
        CompiledModelPool(_mlp_predictor(), batch_ladder=[1])


def test_pool_captures_every_rung_at_construction():
    profiler.reset_serve_counters()
    pool = _pool(_mlp_predictor())
    assert profiler.serve_counters()["rungs_compiled"] == len(LADDER)
    pool.run({"data": np.zeros((3, 5), np.float32)})
    assert profiler.serve_counters()["rungs_compiled"] == len(LADDER)
    assert pool.num_replicas == 1 and pool.ladder == LADDER


def test_pool_pad_rows_masked_and_bitwise_transparent(mlp_pool):
    rng = np.random.RandomState(1)
    x3 = rng.rand(3, 5).astype(np.float32)
    out3 = mlp_pool.run({"data": x3})[0]
    assert out3.shape == (3, 3)
    x4 = np.concatenate([x3, rng.rand(1, 5).astype(np.float32)])
    out4 = mlp_pool.run({"data": x4})[0]
    assert (out3 == out4[:3]).all()


def test_pool_batched_equals_one_at_a_time_same_rung():
    pool = _pool(_mlp_predictor(), ladder=[4])
    x = np.random.RandomState(2).rand(4, 5).astype(np.float32)
    batched = pool.run({"data": x})[0]
    for i in range(4):
        assert (pool.run({"data": x[i:i + 1]})[0][0] == batched[i]).all()


def test_pool_chunks_wider_than_top_rung(mlp_pool):
    x = np.random.RandomState(3).rand(19, 5).astype(np.float32)
    out = mlp_pool.run({"data": x})[0]
    assert out.shape == (19, 3)
    np.testing.assert_allclose(mlp_pool.run({"data": x[:1]})[0][0], out[0],
                               rtol=1e-5, atol=1e-7)


def test_pool_validates_feed(mlp_pool):
    with pytest.raises(MXNetError, match="missing"):
        mlp_pool.run({})
    with pytest.raises(MXNetError, match="shape"):
        mlp_pool.run({"data": np.zeros((2, 7), np.float32)})
    with pytest.raises(MXNetError, match="0 rows"):
        mlp_pool.run({"data": np.zeros((0, 5), np.float32)})


def test_replies_never_alias_the_static_buffers(mlp_pool):
    """Two batches at the same rung, one after the other and then from
    many threads at once: each reply holds its own rows, and a reply kept
    across a later replay does not change."""
    rng = np.random.RandomState(6)
    xa = rng.rand(3, 5).astype(np.float32)
    xb = rng.rand(3, 5).astype(np.float32) + 5.0
    want_a = mlp_pool.run({"data": xa})[0].copy()
    want_b = mlp_pool.run({"data": xb})[0].copy()
    assert not np.array_equal(want_a, want_b)
    kept = mlp_pool.run({"data": xa})[0]
    mlp_pool.run({"data": xb})
    assert np.array_equal(kept, want_a)

    errors = []

    def worker(x, want):
        for _ in range(40):
            got = mlp_pool.run({"data": x})[0]
            if not np.array_equal(got, want):
                errors.append((x[0, 0], got))

    ts = [threading.Thread(target=worker, args=(xa, want_a)),
          threading.Thread(target=worker, args=(xb, want_b))] * 2
    ts = [threading.Thread(target=t._target, args=t._args) for t in ts]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    assert all(not np.shares_memory(kept, s.numpy())
               for p in mlp_pool._exec[0].values() for s in p.static.values())


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 7, 8, 13])
def test_mlp_pool_matches_reference_pool(mlp_pool, jax_mlp_pool, rows):
    x = np.random.RandomState(rows).rand(rows, 5).astype(np.float32)
    np.testing.assert_allclose(mlp_pool.run({"data": x})[0],
                               jax_mlp_pool.run({"data": x})[0],
                               rtol=MLP_TOL, atol=MLP_TOL)


def _bert_feed(rows, seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, BERT["vocab"], (rows, SEQ))
            .astype(np.float32),
            "positions": np.tile(np.arange(SEQ, dtype=np.float32),
                                 (rows, 1))}


@pytest.fixture(scope="module")
def bert_pools():
    sym = bert_encoder(mx.sym, **BERT)
    shapes = {"data": (2, SEQ), "positions": (2, SEQ)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, seed=0)
    jblob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                 for n, a in params.items()})
    old = os.environ.get("MXTPU_PALLAS")
    try:
        # the reference pool serves the unfused graph: its pallas_select
        # reshape shims bake the bound batch, so its fused graph cannot
        # serve another rung; the port's swapped graph (the kernel op
        # takes rank 3, no shim) serves every rung
        os.environ["MXTPU_PALLAS"] = "0"
        jpool = jserving.CompiledModelPool(
            JaxPredictor(sym.tojson(), jblob, shapes),
            batch_ladder=BERT_LADDER, devices=[mx.cpu().jax_device])
        os.environ["MXTPU_PALLAS"] = "1"
        tpred = Predictor(sym.tojson(), jblob, shapes, ctx=mt.cpu())
        tpool = _pool(tpred, BERT_LADDER)
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS", None)
        else:
            os.environ["MXTPU_PALLAS"] = old
    return jpool, tpool, tpred


def test_bert_pool_swaps_attention_onto_the_kernel_op(bert_pools):
    _j, tpool, tpred = bert_pools
    rep = [r for r in tpred._program.opt_reports
           if r.name == "pallas_select"][0]
    assert rep.rewrites == BERT["num_layers"]
    ops = [st[0].name for st in tpred._program._plan[1]]
    assert ops.count("_fused_attention") == BERT["num_layers"]


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5])
def test_bert_pool_matches_reference_pool(bert_pools, rows):
    jpool, tpool, _ = bert_pools
    feed = _bert_feed(rows, 10 + rows)
    got = tpool.run(feed)[0]
    want = jpool.run(feed)[0]
    assert got.shape == (rows, SEQ, BERT["hidden"])
    np.testing.assert_allclose(got, want, rtol=POOL_TOL, atol=POOL_TOL)


def test_bert_row_agrees_across_rungs(bert_pools):
    """Attention is per row: a row served alone (rung 1) and inside a
    batch of 3 (rung 4) agrees within float tolerance, and bitwise at
    the same rung with other pad rows."""
    _j, tpool, _ = bert_pools
    feed = _bert_feed(3, 21)
    full = tpool.run(feed)[0]
    lone = tpool.run({k: v[:1] for k, v in feed.items()})[0]
    np.testing.assert_allclose(lone[0], full[0], rtol=1e-5, atol=1e-5)
    other = _bert_feed(4, 22)
    other = {k: np.concatenate([feed[k], other[k][3:]]) for k in feed}
    assert np.array_equal(tpool.run(other)[0][:3], full)


# ---------------------------------------------------------------------------
# the deploy blob
# ---------------------------------------------------------------------------

def test_blob_pool_equals_live_pool_bitwise(tmp_path, mlp_pool):
    path = str(tmp_path / "m.blob")
    _mlp_predictor().export_compiled(path, dynamic_batch=True)
    blob_pool = _pool(path)
    assert blob_pool.ladder == LADDER and blob_pool.source_crc is not None
    for rows in (1, 2, 3, 4, 6, 8, 11):
        x = np.random.RandomState(rows).rand(rows, 5).astype(np.float32)
        assert np.array_equal(blob_pool.run({"data": x})[0],
                              mlp_pool.run({"data": x})[0])


def test_bert_blob_roundtrip_equals_live_pool(tmp_path, bert_pools):
    _j, tpool, tpred = bert_pools
    path = str(tmp_path / "bert.blob")
    tpred.export_compiled(path, dynamic_batch=True)
    blob_pool = _pool(path, BERT_LADDER)
    for rows in (1, 2, 3):
        feed = _bert_feed(rows, 30 + rows)
        assert np.array_equal(blob_pool.run(feed)[0], tpool.run(feed)[0])


def test_fixed_batch_blob_collapses_the_ladder(tmp_path):
    path = str(tmp_path / "fixed.blob")
    _mlp_predictor(batch=4).export_compiled(path)
    pool = _pool(path)
    assert pool.ladder == [4]
    x = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    np.testing.assert_allclose(pool.run({"data": x})[0],
                               _pool(_mlp_predictor()).run({"data": x})[0],
                               rtol=1e-6, atol=1e-7)


def test_load_compiled_runs_the_blob(tmp_path, mlp_pool):
    path = str(tmp_path / "m.blob")
    _mlp_predictor().export_compiled(path, dynamic_batch=True)
    call, names = Predictor.load_compiled(path, ctx=mt.cpu())
    assert names == ["data"]
    x = np.random.RandomState(4).rand(5, 5).astype(np.float32)
    out = call(data=x)
    np.testing.assert_allclose(out[0], mlp_pool.run({"data": x})[0],
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(MXNetError):
        call(data=np.zeros((2, 6), np.float32))


def test_load_compiled_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "m.blob")
    _mlp_predictor().export_compiled(path, dynamic_batch=True)
    with pytest.raises(MXNetError):
        Predictor.load_compiled(path)


def test_load_exported_parts(tmp_path):
    path = str(tmp_path / "m.blob")
    _mlp_predictor().export_compiled(path, dynamic_batch=True)
    model, names, dtypes = Predictor.load_exported(path)
    assert names == ["data"] and dtypes == [np.dtype(np.float32)]
    assert model.in_shapes == [(None, 5)] and model.fixed_batch is None
    assert set(model.params) == {"fc1_weight", "fc1_bias", "fc2_weight",
                                 "fc2_bias"}


@pytest.fixture(scope="module")
def good_blob(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("blob") / "good.blob")
    _mlp_predictor().export_compiled(path, dynamic_batch=True)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("frac", [0.0, 0.001, 0.01, 0.05, 0.2, 0.5, 0.9,
                                  0.999])
def test_truncated_blob_raises_structured_error(tmp_path, good_blob, frac):
    path = str(tmp_path / "cut.blob")
    with open(path, "wb") as f:
        f.write(good_blob[:int(len(good_blob) * frac)])
    with pytest.raises(CompiledBlobError) as ei:
        CompiledModelPool(path, batch_ladder=[1], devices=[mt.cpu()])
    assert ei.value.file == path and ei.value.offset >= 0


@pytest.mark.parametrize("at", [3, 20, 60, 200, -40, -30])
def test_bit_flipped_blob_raises_structured_error(tmp_path, good_blob, at):
    raw = bytearray(good_blob)
    raw[at] ^= 0x10
    path = str(tmp_path / "flip.blob")
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(CompiledBlobError):
        Predictor.load_exported(path)


def test_garbage_header_is_refused(tmp_path):
    from mxnet_tpu_torch.serialization import atomic_write
    path = str(tmp_path / "garbage.blob")
    atomic_write(path, b"MXTCBLB1" + struct.pack("<I", 10 ** 6) + b"x" * 64)
    with pytest.raises(CompiledBlobError, match="implausible input count"):
        Predictor.load_exported(path)
    atomic_write(path, b"not a model at all" * 4)
    with pytest.raises(CompiledBlobError, match="magic"):
        Predictor.load_exported(path)


def test_reference_mxcblob1_blob_is_refused_by_name(tmp_path):
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in _mlp_params().items()})
    path = str(tmp_path / "jax.blob")
    JaxPredictor(_mlp_json(mx.sym), blob, {"data": (4, 5)}) \
        .export_compiled(path, dynamic_batch=True)
    with open(path, "rb") as f:
        assert f.read(8) == b"MXCBLOB1"
    with pytest.raises(CompiledBlobError, match="MXCBLOB1") as ei:
        Predictor.load_exported(path)
    assert ei.value.offset == 0
    with pytest.raises(CompiledBlobError, match="MXCBLOB1"):
        CompiledModelPool(path, batch_ladder=[1], devices=[mt.cpu()])


def test_port_blob_is_not_a_reference_blob(tmp_path, good_blob):
    """The port's magic is its own: the JAX package refuses the port's
    blob rather than misreading it."""
    path = str(tmp_path / "port.blob")
    with open(path, "wb") as f:
        f.write(good_blob)
    assert good_blob[:8] == b"MXTCBLB1"
    with pytest.raises(Exception):
        JaxPredictor.load_exported(path)


# ---------------------------------------------------------------------------
# the server: dispatcher, shedding, counters, front door
# ---------------------------------------------------------------------------

def test_server_roundtrip_and_counters(mlp_pool):
    profiler.reset_serve_counters()
    x = np.random.RandomState(4).rand(3, 5).astype(np.float32)
    with ModelServer(mlp_pool, max_batch=8, max_delay_ms=2.0,
                     queue_limit=64) as srv:
        out = srv.infer({"data": x})[0]
        assert (out == mlp_pool.run({"data": x})[0]).all()
        results = [None] * 6

        def go(i):
            results[i] = srv.infer({"data": x[:1]})[0]
        ts = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(r is not None and r.shape == (1, 3) for r in results)
    c = profiler.serve_counters()
    assert c["requests"] == 7 and c["responses"] == 7
    assert c["batches"] >= 1
    assert 0.0 < c["batch_occupancy"] <= 1.0
    assert c["pad_waste"] == pytest.approx(1.0 - c["batch_occupancy"])
    assert c["p99_ms"] >= c["p50_ms"] > 0


def test_server_sheds_under_overload(mlp_pool, tmp_path, monkeypatch):
    dump = tmp_path / "flight.txt"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_PATH", str(dump))
    profiler.reset_serve_counters()
    srv = ModelServer(mlp_pool, max_batch=8, max_delay_ms=200.0,
                      queue_limit=4)
    try:
        srv.submit({"data": np.zeros((3, 5), np.float32)})
        with pytest.raises(ServerOverloadError):
            srv.submit({"data": np.zeros((3, 5), np.float32)})
        assert profiler.serve_counters()["shed"] == 1
        assert "FLIGHT-RECORDER == dump (error:serve_overload)" in \
            dump.read_text()
    finally:
        srv.close()


def test_server_rejects_bad_requests(mlp_pool):
    profiler.reset_serve_counters()
    with ModelServer(mlp_pool, max_delay_ms=1.0) as srv:
        with pytest.raises(MXNetError, match="missing input"):
            srv.submit({})
        with pytest.raises(MXNetError, match="shape"):
            srv.submit({"data": np.zeros((2, 9), np.float32)})
        assert profiler.serve_counters()["request_errors"] >= 2


def test_closed_server_submit_raises_draining_closed(mlp_pool):
    srv = ModelServer(mlp_pool, max_delay_ms=2.0)
    srv.close()
    with pytest.raises(ServerDrainingError) as ei:
        srv.infer({"data": np.zeros((4, 5), np.float32)})
    assert ei.value.closed


def test_generation_lane_waits_for_its_port(mlp_pool):
    with pytest.raises(MXNetError, match="generation"):
        ModelServer(mlp_pool, decode=object())
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        with pytest.raises(MXNetError, match="generation"):
            srv.generate(np.zeros(3, np.int32), 4)
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            with pytest.raises(MXNetError, match="generation"):
                cli.generate(np.zeros(3, np.int32), 4)


def test_front_door_infer_ping_stats(mlp_pool):
    x = np.random.RandomState(5).rand(2, 5).astype(np.float32)
    with ModelServer(mlp_pool, max_delay_ms=2.0, model_version="v1") as srv:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            assert cli.ping()
            out = cli.infer({"data": x})
            assert (np.asarray(out[0]) == mlp_pool.run({"data": x})[0]).all()
            stats = cli.stats()
            assert stats["responses"] >= 1
            assert stats["model_version"] == "v1"
            assert "serve" in stats["metrics"]
            assert "serve_queue_rows" in stats["metrics"]["gauges"]


def test_front_door_drops_malformed_frames(mlp_pool):
    profiler.reset_serve_counters()
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        raw = socket.create_connection((host, port))
        raw.sendall(b"\x10\x00\x00\x00\x00\x00\x00\x00GARBAGEGARBAGE!!")
        raw.settimeout(5.0)
        assert raw.recv(1) == b""
        raw.close()
        assert profiler.serve_counters()["wire_errors"] == 1
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            assert cli.ping()


def test_front_door_overload_not_retried(mlp_pool):
    srv = ModelServer(mlp_pool, max_batch=8, max_delay_ms=100.0,
                      queue_limit=4)
    try:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            srv.submit({"data": np.zeros((4, 5), np.float32)})
            t0 = time.monotonic()
            with pytest.raises(ServerOverloadError) as ei:
                cli.infer({"data": np.zeros((3, 5), np.float32)})
            assert time.monotonic() - t0 < 2.0
            assert ei.value.limit == 4
    finally:
        srv.close()


def test_front_door_bad_request_reported(mlp_pool):
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            with pytest.raises(MXNetError, match="bad_request"):
                cli.infer({"data": np.zeros((2, 9), np.float32)})


@pytest.mark.parametrize("rows", [1, 3, 6])
def test_round_trip_matches_reference_server(mlp_pool, jax_mlp_pool, rows):
    """The same rows through each package's client and server."""
    x = np.random.RandomState(40 + rows).rand(rows, 5).astype(np.float32)
    outs = []
    for srv_cls, cli_cls, pool in (
            (ModelServer, ServeClient, mlp_pool),
            (jserving.ModelServer, jserving.ServeClient, jax_mlp_pool)):
        with srv_cls(pool, max_delay_ms=2.0) as srv:
            host, port = srv.serve()
            with cli_cls(host, port, retry_deadline=5.0) as cli:
                outs.append(np.asarray(cli.infer({"data": x})[0]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=MLP_TOL, atol=MLP_TOL)


def test_trace_id_crosses_the_wire(mlp_pool):
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            x = np.random.RandomState(1).rand(2, 5).astype(np.float32)
            with telemetry.trace() as tid:
                cli.infer({"data": x})
    names = {r["name"] for r in telemetry.flight_records()
             if r.get("trace") == tid}
    assert {"serve.infer", "serve.enqueue", "serve.reply"} <= names


def test_client_falls_back_for_a_server_without_context(monkeypatch,
                                                       mlp_pool):
    orig = ModelServer._handle_msg

    def strict(self, msg):
        if isinstance(msg, tuple) and msg and msg[0] == "infer" \
                and len(msg) == 4:
            raise MXNetError("infer frame must be ('infer', req_id, "
                             "{name: array})")
        return orig(self, msg)

    monkeypatch.setattr(ModelServer, "_handle_msg", strict)
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        with ServeClient(host, port, retry_deadline=5.0) as cli:
            with telemetry.trace():
                assert len(cli.infer({"data": np.zeros((1, 5),
                                                        np.float32)})) == 1
            assert cli._ctx_ok is False


# ---------------------------------------------------------------------------
# drain, tuning, hot swap and rollback
# ---------------------------------------------------------------------------

def test_set_tuning_and_restore(mlp_pool):
    with ModelServer(mlp_pool, max_batch=8, max_delay_ms=3.0) as srv:
        now = srv.set_tuning(max_delay_ms=20.0, max_batch=2)
        assert now == {"max_delay_ms": 20.0, "max_batch": 2.0}
        now = srv.set_tuning()
        assert now == {"max_delay_ms": 3.0, "max_batch": 8.0}


def test_drain_refuses_then_resumes_over_the_wire(mlp_pool):
    with ModelServer(mlp_pool, max_delay_ms=2.0) as srv:
        host, port = srv.serve()
        from mxnet_tpu_torch import ps_wire
        s = socket.create_connection((host, port))
        try:
            ps_wire.send_frame(s, ("drain", 1, 2.0))
            assert ps_wire.recv_frame(s) == ("ok", 1, {"drained": True})
            with pytest.raises(ServerDrainingError):
                srv.infer({"data": np.zeros((1, 5), np.float32)})
            ps_wire.send_frame(s, ("resume", 2))
            assert ps_wire.recv_frame(s) == ("ok", 2, {"draining": False})
        finally:
            s.close()
        assert srv.infer({"data": np.zeros((1, 5), np.float32)})[0].shape \
            == (1, 3)


def test_hot_swap_under_traffic_then_rollback(tmp_path, mlp_pool):
    """Deploy a second blob while clients keep sending, then roll back:
    no request fails, each reply is one version's output, and stats name
    the version served.  A request refused while the swap drains the
    queue (`ServerDrainingError`, the reference's bounded refusal that a
    router bounces) is sent again, as a direct client does."""
    p1, p2 = str(tmp_path / "v1.blob"), str(tmp_path / "v2.blob")
    _mlp_predictor(seed=0).export_compiled(p1, dynamic_batch=True)
    _mlp_predictor(seed=1).export_compiled(p2, dynamic_batch=True)
    pool1, pool2 = _pool(p1), _pool(p2)
    x = np.random.RandomState(9).rand(2, 5).astype(np.float32)
    want = {"v1": pool1.run({"data": x})[0], "v2": pool2.run({"data": x})[0]}
    failures, refusals, seen = [], [], set()
    stop = threading.Event()
    with ModelServer(pool1, max_delay_ms=1.0, model_version="v1") as srv:
        host, port = srv.serve()

        def client():
            with ServeClient(host, port, retry_deadline=10.0) as cli:
                while not stop.is_set():
                    try:
                        out = np.asarray(cli.infer({"data": x})[0])
                    except ServerDrainingError:
                        refusals.append(1)
                        time.sleep(0.001)
                        continue
                    except Exception as e:  # any failure fails the test
                        failures.append(repr(e))
                        continue
                    # coalesced with other clients' rows, a reply may
                    # come from another rung: ulp-level, not bitwise
                    hit = [v for v, w in want.items()
                           if np.allclose(out, w, rtol=1e-6, atol=1e-7)]
                    if not hit:
                        failures.append("reply equals no version")
                    seen.update(hit)

        ts = [threading.Thread(target=client) for _ in range(3)]
        for t in ts:
            t.start()
        time.sleep(0.1)
        srv.deploy(p2, version="v2")
        time.sleep(0.1)
        with ServeClient(host, port) as cli:
            assert cli.stats()["model_version"] == "v2"
        srv.deploy(p1, version="v1")  # the stashed pool: no capture
        assert srv.model_version == "v1" and srv.previous_version == "v2"
        time.sleep(0.1)
        stop.set()
        for t in ts:
            t.join()
    assert not failures
    assert seen == {"v1", "v2"}
    assert profiler.serve_counters()["hot_swaps"] >= 2


def test_deploy_of_a_bad_blob_changes_nothing(tmp_path, mlp_pool):
    bad = str(tmp_path / "bad.blob")
    with open(bad, "wb") as f:
        f.write(b"MXCBLOB1 is not ours")
    with ModelServer(mlp_pool, max_delay_ms=1.0, model_version="v1") as srv:
        with pytest.raises(CompiledBlobError):
            srv.deploy(bad, version="v2")
        assert srv.model_version == "v1" and not srv.draining
        assert srv.infer({"data": np.zeros((1, 5), np.float32)})[0].shape \
            == (1, 3)


# ---------------------------------------------------------------------------
# launch accounting while another thread captures
# ---------------------------------------------------------------------------

def test_a_capture_counts_its_launches_apart_from_other_threads():
    """A capture on one stream (a deploy's new pool) while dispatch
    threads replay on another: the replays' launches all reach
    `LAUNCHES`, and the capture's record holds the launches made on its
    stream only, from whichever thread (autograd runs a captured
    backward on a thread of its own).  Before the record was keyed by the
    capture's stream, the capture took a snapshot of `LAUNCHES`, counted
    the replays made meanwhile as its own and wrote the snapshot back."""
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    hk.reset_launch_counts()
    capture_stream, replay_stream = 0x7000, 0x9000
    entered, replayed = threading.Event(), threading.Event()
    record = {}

    def capture():
        with hk.recording_launches(capture_stream) as rec:
            entered.set()
            hk.count_launch("flash_attn_fwd", 12, stream=capture_stream)
            backward = threading.Thread(target=hk.count_launch, args=(
                "flash_attn_bwd_dq", 12), kwargs={"stream": capture_stream})
            backward.start()
            backward.join(10)
            replayed.wait(10)
        record.update(rec)

    def replays():
        entered.wait(10)
        for _ in range(100):
            hk.count_launch("flash_attn_fwd", 5, stream=replay_stream)
        replayed.set()

    ts = [threading.Thread(target=capture), threading.Thread(target=replays)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not any(t.is_alive() for t in ts)
    assert record == {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12}
    assert hk.LAUNCHES["flash_attn_fwd"] == 500
    assert hk.LAUNCHES["flash_attn_bwd_dq"] == 0
    hk.count_launch("flash_attn_fwd", 1, stream=capture_stream)
    assert hk.LAUNCHES["flash_attn_fwd"] == 501  # the record has ended
    with hk.recording_launches(capture_stream):
        with pytest.raises(MXNetError):
            with hk.recording_launches(capture_stream):
                pass
    hk.reset_launch_counts()
