"""The port's observability plane (`profiler`, `telemetry`, `log`) against
the JAX package's on the CPU: the counter families, `metrics_snapshot` and
`metrics_text` after the same calls (equal keys and values), the
telemetry records, the slow-step watchdog and the log formatter; the
capture over `torch.profiler` (a Chrome-trace JSON where the JAX package
writes an xplane directory); and the counters the port's modules bump at
the JAX package's call sites."""
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import log as jlog
from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.predictor import Predictor as JaxPredictor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import log, profiler, telemetry
from mxnet_tpu_torch.predictor import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = ("step", "comm", "serve", "gen", "graph", "router", "autoscale",
            "spmd", "unified", "driver", "mesh", "embed", "audit")


def _reset(prof):
    for name in ("step", "comm", "serve", "gen", "graph", "router",
                 "autoscale", "spmd", "unified", "driver", "mesh", "embed",
                 "audit"):
        getattr(prof, f"reset_{name}_counters")()


def _drive(prof, now):
    """One fixed sequence of counter calls, the same in each package."""
    prof.bump_counter("dispatches", 3)
    prof.bump_counter("fused_steps")
    prof.bump_comm("bytes", 4096)
    prof.bump_comm("busy_s", 2.0)
    prof.bump_comm("blocked_s", 0.5)
    prof.bump_serve("requests", 5)
    prof.bump_serve_many({"rows": 7, "pad_rows": 1, "rung_8_dispatches": 1})
    prof.observe_serve_latencies([0.001, 0.004, 0.002], now)
    prof.observe_serve_latency(0.003, now)
    prof.bump_gen_many({"chunks": 2, "steps": 8})
    prof.set_gen_slots(3, 4)
    prof.observe_gen_ttft(0.01, now)
    prof.observe_gen_tokens(16, now)
    prof.bump_graph("graph_compiles")
    prof.bump_graph("graph_opt/cse_rewrites", 2)
    prof.bump_router_many({"requests": 2, "failovers": 1})
    prof.bump_autoscale("polls", 3)
    prof.bump_spmd("spmd_steps")
    prof.set_spmd("replicas", 4.0)
    prof.bump_unified("unified_steps", 2)
    prof.set_unified("train_opt_rewrites", 5)
    prof.bump_driver("preempts")
    prof.set_driver("workers", 2)
    prof.bump_mesh("reshards")
    prof.set_mesh("degraded_steps", 1)
    prof.bump_embed("ids_requested", 10)
    prof.bump_embed("rows_pulled", 4)
    prof.set_embed("state_rows_alloc", 7)
    prof.bump_audit("programs_audited")
    prof.set_audit("clean_programs", 1)


@pytest.fixture
def snapshots():
    now = time.monotonic()
    out = []
    for prof in (profiler, jprof):
        _reset(prof)
        _drive(prof, now)
        out.append(prof.metrics_snapshot())
    yield out
    _reset(profiler)
    _reset(jprof)


@pytest.mark.parametrize("family", FAMILIES)
def test_counter_family_equals_reference(snapshots, family):
    port, ref = snapshots
    assert port[family] == ref[family]


def test_snapshot_families_and_gauges_match_reference(snapshots):
    port, ref = snapshots
    assert set(port) >= set(FAMILIES) | {"gauges"}
    assert set(FAMILIES) | {"gauges"} <= set(ref)
    assert "steps_per_s" in port["gauges"]


def test_metrics_text_equals_reference(snapshots):
    """The counter families' exposition after the same calls; the gauges
    sample live process state (steps/s of earlier fits), so each side
    renders the same gauge values here."""
    port, ref = snapshots
    keep = set(FAMILIES)
    port = {k: v for k, v in port.items() if k in keep}
    ref = {k: v for k, v in ref.items() if k in keep}
    gauges = {"steps_per_s": 0.25, "serve_queue_rows": 3.0}
    port["gauges"] = ref["gauges"] = gauges
    assert profiler.metrics_text(port) == jprof.metrics_text(ref)
    assert "mxtpu_gauges_steps_per_s 0.25" in profiler.metrics_text(port)


@pytest.mark.parametrize("parts", [("serve", "p50_ms"), ("graph",
                                   "graph_opt/cse_rewrites"),
                                   ("ps client", "x-y")])
def test_metric_names_match_reference(parts):
    assert profiler._metric_name(*parts) == jprof._metric_name(*parts)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_percentile_matches_reference(q):
    vals = sorted(np.random.RandomState(3).rand(37).tolist())
    assert profiler._percentile(vals, q) == jprof._percentile(vals, q)


def test_registered_gauges_and_families():
    profiler.register_gauge("unit_gauge", lambda: 2.5)
    profiler.register_gauge("broken_gauge", lambda: 1 / 0)
    profiler.register_metrics_family("unit_family", lambda: {"a": 1})
    try:
        snap = profiler.metrics_snapshot()
        assert snap["gauges"]["unit_gauge"] == 2.5
        assert np.isnan(snap["gauges"]["broken_gauge"])
        assert snap["unit_family"] == {"a": 1}
        assert "mxtpu_unit_family_a 1" in profiler.metrics_text()
    finally:
        profiler.unregister_gauge("unit_gauge")
        profiler.unregister_gauge("broken_gauge")
        profiler.unregister_metrics_family("unit_family")


def test_public_names_cover_the_reference():
    missing = [n for n in jprof.__all__ if not hasattr(profiler, n)]
    assert not missing
    missing = [n for n in jtele.__all__ if not hasattr(telemetry, n)]
    assert not missing


# ---------------------------------------------------------------------------
# capture over torch.profiler
# ---------------------------------------------------------------------------

def _trace_names(path):
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_capture_dumps_a_chrome_trace_with_spans(tmp_path):
    import torch
    path = str(tmp_path / "prof.json")
    profiler.set_config(filename=path, profile_all=True)
    try:
        profiler.start()
        with profiler.Task(name="unit.task"):
            torch.ones(8).sum()
        with profiler.Frame(name="unit.frame"):
            pass
        with profiler.Event("unit.event"):
            pass
        profiler.Marker(name="unit.marker").mark()
        profiler.stop()
        assert profiler.dump() == path
        names = _trace_names(path)
        for n in ("unit.task", "unit.frame", "unit.event", "unit.marker"):
            assert n in names
        table = profiler.dumps()
        assert "unit.task" in table and "Mean(ms)" in table
    finally:
        profiler.set_config(filename="profile.json")


def test_pause_resume_keeps_one_trace(tmp_path):
    path = str(tmp_path / "pr.json")
    profiler.set_config(filename=path)
    try:
        profiler.start()
        with profiler.Task(name="before.pause"):
            pass
        profiler.pause()
        assert not profiler._state["running"] and profiler._state["paused"]
        with profiler.Task(name="while.paused"):
            pass
        profiler.resume()
        assert profiler._state["running"]
        with profiler.Task(name="after.resume"):
            pass
        profiler.dump()
        names = _trace_names(path)
        assert "before.pause" in names and "after.resume" in names
        assert "while.paused" not in names
    finally:
        profiler.stop()
        profiler.set_config(filename="profile.json")


def test_set_state_and_deprecated_aliases(tmp_path):
    profiler.profiler_set_config(filename=str(tmp_path / "s.json"))
    try:
        profiler.set_state("run")
        assert profiler._state["running"]
        profiler.set_state("stop")
        assert not profiler._state["running"]
        with pytest.raises(ValueError):
            profiler.set_state("fly")
        with pytest.warns(DeprecationWarning):
            profiler.profiler_set_state("stop")
        with pytest.warns(DeprecationWarning):
            profiler.dump_profile()
        assert os.path.exists(str(tmp_path / "s.json"))
        profiler.set_kvstore_handle(None)
    finally:
        profiler.set_config(filename="profile.json")


def test_dump_without_capture_is_none():
    profiler._state["segments"] = []
    profiler._state["running"] = False
    assert profiler.dump() is None


def test_counter_and_domain_objects():
    c = profiler.Counter(profiler.Domain("d"), "c", 5)
    c += 3
    c -= 1
    c.increment(2)
    c.decrement()
    assert c.value == 8
    c.set_value(1)
    assert c.value == 1


def test_dumps_lists_aggregates_and_the_serve_family():
    profiler.reset_serve_counters()
    profiler.bump_serve("requests")
    with profiler.Event("agg.check"):
        time.sleep(0.001)
    table = profiler.dumps(reset=True)
    assert "agg.check" in table and "-- serve --" in table
    assert "agg.check" not in profiler.dumps()


def test_autostart_knob_starts_a_capture_at_import(tmp_path):
    out = tmp_path / "auto.json"
    code = ("import mxnet_tpu_torch.profiler as p, sys; "
            f"p.set_config(filename={str(out)!r}); "
            "sys.exit(0 if p._state['running'] else 3)")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1")
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        timeout=300).returncode
    assert rc == 0
    assert "traceEvents" in json.loads(out.read_text())


# ---------------------------------------------------------------------------
# telemetry, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture
def clean(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_MIN_INTERVAL_S", "0")
    telemetry.reset()
    jtele.reset()
    yield
    telemetry.reset()
    jtele.reset()


_SKIP = {"ts", "mono", "pid", "thread"}


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in _SKIP} for r in recs]


def _drive_tele(tele):
    tele.event("unit.event", a=1, b="x")
    with tele.trace("feedbeef00000000", name="unit"):
        tele.event("inside")
        with tele.span("unit.span", k=2):
            pass
    with tele.adopt({tele.CTX_KEY: "0123456789abcdef"}):
        tele.event("adopted")
    with tele.adopt(None):
        tele.event("no.ctx")
    tele.record_error(ValueError("bad"), dump=False, kind="unit")
    return tele.flight_records()


def test_event_records_equal_reference(clean):
    port = _strip(_drive_tele(telemetry))
    ref = _strip(_drive_tele(jtele))
    for r in port + ref:
        r.pop("dur_ms", None)
    assert port == ref


def test_wire_context_and_adopt(clean):
    assert telemetry.wire_context() is None
    with telemetry.trace() as tid:
        assert telemetry.wire_context() == {telemetry.CTX_KEY: tid}
        assert len(tid) == 16
    assert telemetry.current_trace() is None
    with telemetry.adopt("not a dict") as cur:
        assert cur is None


def test_flight_recorder_ring_is_bounded_and_dump_format(clean):
    for i in range(700):
        telemetry.event("tick", i=i)
    assert len(telemetry.flight_records()) <= 512
    text = telemetry.dump_flight_recorder("unit-test", file=open(os.devnull,
                                                                  "w"))
    assert all(line.startswith("FLIGHT-RECORDER")
               for line in text.splitlines())
    assert "dump (unit-test)" in text


def test_record_error_throttle(clean, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_MIN_INTERVAL_S", "3600")
    dump = tmp_path / "flight.txt"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_PATH", str(dump))
    telemetry._last_dump["t"] = 0.0
    telemetry.record_error("first", kind="boom")
    telemetry.record_error("second", kind="boom")
    assert dump.read_text().count("== dump (error:boom)") == 1
    assert len([r for r in telemetry.flight_records()
                if r["name"] == "error"]) == 2


def test_telemetry_dir_writes_jsonl(clean, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    telemetry._writers.clear()
    try:
        telemetry.event("jsonl.check", foo="bar")
        files = list(tmp_path.glob("events-*.jsonl"))
        assert len(files) == 1
        rec = json.loads(files[0].read_text().splitlines()[-1])
        assert rec["name"] == "jsonl.check" and rec["foo"] == "bar"
    finally:
        for w in telemetry._writers.values():
            w.close()
        telemetry._writers.clear()


def test_span_feeds_profiler_aggregate_table(clean):
    with telemetry.span("unit.test.span"):
        time.sleep(0.002)
    assert "unit.test.span" in profiler.dumps()


@pytest.mark.parametrize("case", ["comm_stall", "no_poison", "input_wait",
                                  "warmup"])
def test_watchdog_matches_reference(clean, case):
    seqs = {
        "comm_stall": (dict(window=16, factor=3.0, min_warmup=4),
                       [(0.001, 0.010, 0.002)] * 8 + [(0.001, 0.010, 0.5)]),
        "no_poison": (dict(window=4, factor=3.0, min_warmup=2),
                      [(0.0, 0.01, 0.0)] * 4 + [(0.0, 1.0, 0.0),
                                                (0.0, 0.011, 0.0)]),
        "input_wait": (dict(window=8, factor=2.0, min_warmup=2),
                       [(0.001, 0.01, 0.001)] * 4 + [(0.2, 0.01, 0.001)]),
        "warmup": (dict(window=8, factor=1.5, min_warmup=6),
                   [(0.0, 0.01 * (k + 1), 0.0) for k in range(8)]),
    }
    kw, steps = seqs[case]
    outs = []
    for tele in (telemetry, jtele):
        wd = tele.SlowStepWatchdog(**kw)
        recs = [wd.observe(i, *s) for i, s in enumerate(steps)]
        outs.append(([None if r is None else
                      {k: v for k, v in r.items() if k not in _SKIP}
                      for r in recs], wd.triggered))
    assert outs[0] == outs[1]


def test_steps_per_s_gauge(clean):
    now = time.monotonic()
    for k in range(5):
        telemetry.mark_step(now - 0.1 * k)
    assert telemetry.steps_per_s() >= 0.5
    assert profiler.gauges()["steps_per_s"] >= 0.5


def test_crash_handler_chains_the_previous_sigterm_handler():
    code = """
import os, signal, sys
hit = []
signal.signal(signal.SIGTERM, lambda s, f: hit.append(s))
import mxnet_tpu_torch.telemetry as t
t.install_crash_handlers()
cur = signal.getsignal(signal.SIGTERM)
assert getattr(cur, "_mxtpu_flight_recorder", False)
os.kill(os.getpid(), signal.SIGTERM)
sys.exit(0 if hit == [signal.SIGTERM] else 4)
"""
    env = dict(os.environ, MXTPU_FLIGHT_RECORDER_PATH=os.devnull)
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        timeout=300).returncode
    assert rc == 0


def test_log_formatter_matches_reference(tmp_path):
    outs = []
    for mod in (log, jlog):
        path = tmp_path / f"{mod.__name__}.log"
        lg = mod.get_logger(f"obs-{mod.__name__}", filename=str(path),
                            level=logging.INFO)
        lg.info("plain please")
        for h in lg.handlers:
            h.flush()
        text = path.read_text()
        assert "\x1b[" not in text
        outs.append(text.split(" ", 1)[0] + " " + text.rsplit(" ", 2)[-2:][0]
                    + text.rsplit(" ", 2)[-1])
    assert outs[0] == outs[1]
    with pytest.warns(DeprecationWarning):
        log.getLogger("obs-deprecated")
    assert log._Formatter(colored=True)._color(logging.ERROR) == \
        jlog._Formatter(colored=True)._color(logging.ERROR)


# ---------------------------------------------------------------------------
# counters at the JAX package's call sites
# ---------------------------------------------------------------------------

def _mlp_json(sym_mod):
    data = sym_mod.var("data")
    h = sym_mod.FullyConnected(data, num_hidden=8, name="fc1")
    h = sym_mod.Activation(h, act_type="relu", name="relu1")
    h = sym_mod.Activation(sym_mod.identity(h, name="id0"),
                           act_type="relu", name="relu2")
    h = sym_mod.FullyConnected(h, num_hidden=3, name="fc2")
    return sym_mod.softmax(h, name="out").tojson()


def _params():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32),
            "fc1_bias": rng.randn(8).astype(np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}


def test_graph_opt_counters_equal_reference():
    from mxnet_tpu import serialization as jser
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in _params().items()})
    got = []
    for prof, make in ((profiler, lambda: Predictor(
            _mlp_json(mt.sym), blob, {"data": (4, 5)}, ctx=mt.cpu())),
            (jprof, lambda: JaxPredictor(_mlp_json(mx.sym), blob,
                                         {"data": (4, 5)}))):
        prof.reset_graph_counters()
        make()
        got.append({k: v for k, v in prof.graph_counters().items()
                    if k.startswith("graph_opt/")})
    assert got[0] == got[1]
    assert got[0]["graph_opt/runs"] == 1
    assert got[0].get("graph_opt/eliminate_rewrites", 0) >= 1


def test_program_counters_on_forwards():
    profiler.reset_graph_counters()
    profiler.reset_step_counters()
    from mxnet_tpu import serialization as jser
    blob = jser.dumps_ndarrays({"arg:" + n: mx.nd.array(a)
                                for n, a in _params().items()})
    pred = Predictor(_mlp_json(mt.sym), blob, {"data": (4, 5)}, ctx=mt.cpu())
    x = np.random.RandomState(1).rand(4, 5).astype(np.float32)
    for _ in range(3):
        pred.forward(data=x)
    g = profiler.graph_counters()
    assert g["graph_compiles"] == 1
    assert g["graph_cache_hits"] == 3
    assert profiler.step_counters()["dispatches"] >= 3


def _fit_module(ctx_mod, mod_ns, nbatch=4):
    data = mod_ns.sym.Variable("data")
    label = mod_ns.sym.Variable("softmax_label")
    h = mod_ns.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mod_ns.sym.Activation(h, act_type="relu")
    h = mod_ns.sym.FullyConnected(h, num_hidden=4, name="fc2")
    out = mod_ns.sym.SoftmaxOutput(h, label, name="softmax")
    rng = np.random.RandomState(7)
    x = rng.randn(6 * nbatch, 5).astype(np.float32)
    y = (rng.rand(6 * nbatch) * 4).astype(np.int64).astype(np.float32)
    it = mod_ns.io.NDArrayIter(x, y, batch_size=6)
    return out, it


def test_fit_bumps_step_counters_and_marks_steps(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_PATH", os.devnull)
    profiler.reset_step_counters()
    profiler.reset_unified_counters()
    telemetry.reset()
    with mt.cpu():
        out, it = _fit_module(mt.cpu, mt)
        mod = mt.mod.Module(out, context=mt.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier())
    s = profiler.step_counters()
    assert s["fused_steps"] == 8
    assert s["multi_tensor_groups"] == 8
    assert s.get("fallback_steps", 0) == 0
    u = profiler.unified_counters()
    assert u["unified_steps"] == 8 and u["metric_in_trace_steps"] == 8
    assert telemetry.steps_per_s(window_s=60.0) > 0


def test_fit_off_the_fused_step_counts_a_fallback(monkeypatch):
    from mxnet_tpu_torch.module import module as mmod
    profiler.reset_step_counters()
    with mt.cpu():
        out, it = _fit_module(mt.cpu, mt, nbatch=2)
        mod = mt.mod.Module(out, context=mt.cpu())
        monkeypatch.setattr(mmod.Module, "_one_graph", lambda self: True)
        from mxnet_tpu_torch import unified_step
        monkeypatch.setattr(unified_step.UnifiedTrainStep, "step",
                            lambda self, feeds: False)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
    assert profiler.step_counters()["fallback_steps"] == 2


def test_kvstore_comm_family_equals_reference():
    got = []
    for prof, ns in ((profiler, mt), (jprof, mx)):
        prof.reset_comm_counters()
        ctx = ns.cpu()
        kv = ns.kv.create("local")
        kv.init(3, ns.nd.zeros((2, 3), ctx=ctx))
        kv.init("w", ns.nd.zeros((4,), ctx=ctx))
        kv.push(3, ns.nd.ones((2, 3), ctx=ctx))
        out = ns.nd.zeros((2, 3), ctx=ctx)
        kv.pull(3, out=out)
        kv.push(["w", 3], [ns.nd.ones((4,), ctx=ctx),
                           ns.nd.ones((2, 3), ctx=ctx)])
        kv.pushpull(3, ns.nd.ones((2, 3), ctx=ctx), out=out)
        got.append(prof.comm_counters())
    assert got[0] == got[1]
    assert got[0]["fallback_keys"] == 4


def test_trainer_fallback_counted_when_no_multi_tensor_plan(monkeypatch):
    from mxnet_tpu_torch import autograd, gluon
    profiler.reset_step_counters()
    with mt.cpu():
        net = gluon.nn.Dense(3, in_units=4, prefix="obs_")
        net.initialize(ctx=mt.cpu())
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        monkeypatch.setattr(type(tr._updater), "update_multi",
                            lambda self, items: False)
        x = mt.nd.array(np.ones((2, 4), np.float32))
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
    assert profiler.step_counters()["fallback_steps"] == 1
