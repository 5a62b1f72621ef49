"""The port's engine against the JAX package's (`mxnet_tpu/engine.py`):
pushes on one variable run in push order, readers of a variable wait for
its writer, `push_sync` returns the closure's result, `wait_for_var`
and `wait_for_all` wait (and raise a pushed closure's error), the
``NaiveEngine`` completes each push before it returns, and `bulk` sets
and restores the bulk size.  The same schedules through both packages
give the same logs."""
import threading
import time

import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


@pytest.fixture(params=["ThreadedEnginePerDevice", "NaiveEngine"])
def kind(request):
    return request.param


def _schedule(pkg, kind):
    eng = pkg.engine.Engine(kind)
    a, b = eng.new_variable(), eng.new_variable()
    log, lock = [], threading.Lock()

    def op(tag, delay):
        def fn():
            time.sleep(delay)
            with lock:
                log.append(tag)
            return tag
        return fn

    for i in range(6):  # writers of a, slowest first: order must hold
        eng.push(op(f"a{i}", 0.006 - i * 0.001), mutable_vars=[a])
    eng.push(op("read_a", 0.0), const_vars=[a], mutable_vars=[b])
    eng.push(op("b_after", 0.0), mutable_vars=[b])
    assert eng.push_sync(op("sync", 0.0), const_vars=[b]) == "sync"
    eng.wait_for_var(a)
    eng.wait_for_all()
    versions = (a.version, b.version)
    eng.notify_shutdown()
    return log, versions


def test_ordering_matches_reference(kind):
    got, want = _schedule(mt, kind), _schedule(mx, kind)
    assert got == want
    assert got[0] == [f"a{i}" for i in range(6)] + ["read_a", "b_after",
                                                    "sync"]
    assert got[1] == (6, 2)


def test_naive_engine_completes_each_push(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    eng = mt.engine.Engine()
    assert eng.kind == "NaiveEngine"
    fut = eng.push(lambda: 5)
    assert fut.done() and fut.result() == 5
    eng.notify_shutdown()


def test_wait_for_all_raises_a_pushed_error(kind):
    for pkg in (mx, mt):
        eng = pkg.engine.Engine(kind)

        def boom():
            raise ValueError("from the engine")

        if kind == "NaiveEngine":
            with pytest.raises(ValueError):
                eng.push(boom)
        else:
            eng.push(boom)
            with pytest.raises(ValueError, match="from the engine"):
                eng.wait_for_all()
        eng.notify_shutdown()


def test_bulk_sets_and_restores():
    for pkg in (mx, mt):
        old = pkg.engine.set_bulk_size(7)
        with pkg.engine.bulk(3):
            assert pkg.engine.set_bulk_size(3) == 3
        assert pkg.engine.set_bulk_size(old) == 7


def test_get_engine_is_one_per_process():
    assert mt.engine.get_engine() is mt.engine.get_engine()
