"""The PyTorch port's ``dist`` stores and their surroundings against the
JAX package, on the CPU (cases adapted from `tests/test_kvstore.py:73-100`
and the JAX package's PS tests).

* ``dist_sync`` / ``dist_device_sync`` in one process are one-worker
  stores, and ``dist_async`` without the hook warns and aliases sync;
* update-on-kvstore steps through the comm plane (buckets and overlap on
  and off) equal the JAX package's store on the same gradients;
* `Module.init_optimizer(kvstore='dist_sync')` trains as the JAX
  package's module;
* a group that cannot form raises; ranks come from the launcher's env;
* wire compatibility: a port `PSClient` against the JAX package's
  `KVStoreServer`, and a JAX client against the port's server, store
  the same values as the same package on both ends, for init, push,
  pull, ``push_batch``/``pull_batch`` and ``pull_rows`` (``set_optimizer``
  is left out: its blob pickles one package's class);
* the server role: importing the package under ``DMLC_ROLE=server``
  serves the parameter server with the hook (restoring and writing
  ``MXTPU_PS_SNAPSHOT``) and exits 0 without it;
* a dead server raises the client's structured error after the retry
  deadline, through the store;
* the NDArray's pending pull lands at the next read or write.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import ps_server as jps
from mxnet_tpu_torch import ps_server as tps
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
SHAPE = (2, 3)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("BYTEPS_ENABLE_ASYNC", "MXTPU_PS_ADDR", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "DMLC_PS_ROOT_URI", "DMLC_NUM_SERVER",
              "MXTPU_COMM_OVERLAP", "MXTPU_COMM_BUCKET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT_INTERVAL", "0")
    monkeypatch.setenv("MXTPU_PS_RETRY_BASE", "0.01")


def _arr(pkg, x):
    x = np.asarray(x, np.float32)
    return mt.nd.array(x, ctx=CPU) if pkg is mt else mx.nd.array(x)


def _zeros(pkg, shape):
    return mt.nd.zeros(shape, ctx=CPU) if pkg is mt else mx.nd.zeros(shape)


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async"])
def test_one_process_dist_store_degenerates_to_local(name):
    got = {}
    for pkg in (mt, mx):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            kv = pkg.kv.create(name)
        msgs = [str(x.message) for x in w]
        if "async" in name:
            assert any("BYTEPS_ENABLE_ASYNC" in m and "synchronous" in m
                       for m in msgs), msgs
        else:
            assert not msgs, msgs
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        kv.init("x", _arr(pkg, np.zeros(SHAPE)))
        kv.push("x", [_arr(pkg, np.ones(SHAPE) * 3),
                      _arr(pkg, np.ones(SHAPE) * 4)])
        out = _zeros(pkg, SHAPE)
        kv.pull("x", out=out)
        kv.barrier()
        got[pkg.__name__] = out.asnumpy()
    np.testing.assert_array_equal(got["mxnet_tpu_torch"], 7 * np.ones(SHAPE))
    np.testing.assert_array_equal(got["mxnet_tpu_torch"], got["mxnet_tpu"])


def _updater_steps(pkg, steps=4, nkeys=5, elems=300):
    rng = np.random.RandomState(3)
    weights = [rng.randn(elems).astype(np.float32) for _ in range(nkeys)]
    grads = [[rng.randn(elems).astype(np.float32) * 0.1
              for _ in range(nkeys)] for _ in range(steps)]
    kv = pkg.kv.create("dist_sync")
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.05, momentum=0.9))
    keys = list(range(nkeys))
    for k in keys:
        kv.init(k, _arr(pkg, weights[k]))
    outs = [_zeros(pkg, (elems,)) for _ in keys]
    for s in range(steps):
        kv.pushpull(keys, [_arr(pkg, g) for g in grads[s]], out=outs,
                    priority=[-k for k in keys])
    kv.comm.flush()
    frames = [(f["kind"], tuple(f["keys"])) for f in kv.comm.frame_log]
    return np.concatenate([o.asnumpy() for o in outs]), frames


@pytest.mark.parametrize("overlap,bucket", [("1", "4194304"), ("0", "0"),
                                            ("1", "2400")])
def test_update_on_kvstore_through_the_plane_matches_reference(
        monkeypatch, overlap, bucket):
    monkeypatch.setenv("MXTPU_COMM_OVERLAP", overlap)
    monkeypatch.setenv("MXTPU_COMM_BUCKET_BYTES", bucket)
    got, tframes = _updater_steps(mt)
    want, jframes = _updater_steps(mx)
    assert tframes == jframes
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_module_update_on_a_dist_store_matches_reference():
    rng = np.random.RandomState(5)
    w = rng.randn(4, 6).astype(np.float32) * 0.3
    x = rng.randn(8, 6).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.float32)
    got = {}
    for pkg in (mt, mx):
        data = pkg.sym.var("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=4, no_bias=True,
                                    name="fc")
        net = pkg.sym.SoftmaxOutput(fc, name="softmax")
        kw = {"context": CPU} if pkg is mt else {}
        mod = pkg.mod.Module(net, **kw)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.init_params(arg_params={"fc_weight": _arr(pkg, w)})
        mod.init_optimizer(kvstore="dist_sync", optimizer="adam",
                           optimizer_params={"learning_rate": 0.05})
        assert mod._kvstore is not None and mod._kvstore.num_workers == 1
        batch = pkg.io.DataBatch([_arr(pkg, x)], [_arr(pkg, y)])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        got[pkg.__name__] = mod.get_params()[0]["fc_weight"].asnumpy()
    np.testing.assert_allclose(got["mxnet_tpu_torch"], got["mxnet_tpu"],
                               rtol=1e-5, atol=1e-6)


def test_a_group_that_cannot_form_raises(monkeypatch):
    # the launcher says two workers but names no rank: refused at once
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    with pytest.raises(MXNetError, match="DMLC_WORKER_ID"):
        mt.kv.create("dist_sync")
    assert not dist.is_initialized() or dist.size() == 1
    # a rank whose peer never comes: the store's wait ends in an error
    from test_torch_dist_multiprocess import free_port_pair
    port = free_port_pair()
    with pytest.raises(MXNetError, match="did not form"):
        dist.initialize(f"127.0.0.1:{port}", num_processes=2,
                        process_id=1, timeout=1.0)
    assert dist.size() == 1 and dist.rank() == 0


def _wire_session(client_ps, server_ps, monkeypatch, async_mode):
    if async_mode:
        monkeypatch.setenv("BYTEPS_ENABLE_ASYNC", "1")
    else:
        monkeypatch.delenv("BYTEPS_ENABLE_ASYNC", raising=False)
    srv = server_ps.KVStoreServer(num_workers=1).start()
    try:
        c = client_ps.PSClient("127.0.0.1", srv.port, worker_id="w0",
                               heartbeat=False)
        rng = np.random.RandomState(9)
        reads = []
        c.init(1, rng.randn(4).astype(np.float32))
        c.init(2, rng.randn(6, 2).astype(np.float32))
        c.init("s", np.arange(12, dtype=np.float16).reshape(6, 2))
        for _ in range(3):
            c.push(1, rng.randn(4).astype(np.float32))
            reads.append(c.pull(1))
            c.push_batch([(2, rng.randn(6, 2).astype(np.float32)),
                          ("s", rng.randn(6, 2).astype(np.float16))])
            reads.extend(c.pull_batch([1, 2, "s"]))
            c.push(2, client_ps.rsp_wire(
                np.array([1, 4]), rng.randn(2, 2).astype(np.float32)))
            reads.append(c.pull_rows(2, np.array([0, 1, 4])))
        stats = c.stats()
        c.close()
        return reads, {k: stats[k] for k in ("rounds_applied", "keys",
                                              "sync_mode")}
    finally:
        srv.shutdown()


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_wire_compatibility_across_packages(monkeypatch, async_mode,
                                            client, server):
    pk = {"torch": tps, "jax": jps}
    mixed = _wire_session(pk[client], pk[server], monkeypatch, async_mode)
    same = _wire_session(pk[server], pk[server], monkeypatch, async_mode)
    assert mixed[1] == same[1]
    assert len(mixed[0]) == len(same[0])
    for a, b in zip(mixed[0], same[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _role(env):
    """A process that imports the package under ``env`` and prints a
    line if the import returned."""
    e = dict(os.environ)
    e.update(env)
    e["PYTHONPATH"] = _REPO
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys, mxnet_tpu_torch; "
         "assert 'jax' not in sys.modules; print('WORKER RETURNED')"],
        env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_server_role_serves_with_the_hook_and_exits_without(tmp_path):
    from test_torch_dist_multiprocess import free_port_pair
    # a worker's import returns; a server without the hook exits 0 before
    # the script's own code (both run beside the served rounds below)
    worker = _role({"DMLC_ROLE": "worker"})
    idle = _role({"DMLC_ROLE": "server", "BYTEPS_ENABLE_ASYNC": ""})
    # with the hook the import serves until a client sends stop, then
    # writes the snapshot; a second server restores it
    snap = str(tmp_path / "ps.snap")
    port = free_port_pair()
    env = {"DMLC_ROLE": "server", "BYTEPS_ENABLE_ASYNC": "1",
           "DMLC_NUM_WORKER": "1", "DMLC_PS_ROOT_PORT": str(port - 1),
           "MXTPU_PS_SNAPSHOT": snap}
    try:
        for round_ in range(2):
            proc = _role(env)
            try:
                c = tps.PSClient("127.0.0.1", port, worker_id="w0",
                                 heartbeat=False, connect_window=60)
                if round_ == 0:
                    c.init(3, np.full(2, 5.0, np.float32))
                    c.push(3, np.ones(2, np.float32))
                np.testing.assert_array_equal(c.pull(3), [6.0, 6.0])
                c._call("stop")
                out, _ = proc.communicate(timeout=60)
                assert proc.returncode == 0, out[-2000:]
                assert "WORKER RETURNED" not in out
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert os.path.exists(snap)
        out, _ = worker.communicate(timeout=120)
        assert worker.returncode == 0 and "WORKER RETURNED" in out, out
        out, _ = idle.communicate(timeout=120)
        assert idle.returncode == 0 and "WORKER RETURNED" not in out, out
    finally:
        for p in (worker, idle):
            if p.poll() is None:
                p.kill()


def test_a_dead_server_raises_through_the_store(monkeypatch):
    monkeypatch.setenv("BYTEPS_ENABLE_ASYNC", "1")
    monkeypatch.setenv("MXTPU_PS_RETRY_DEADLINE", "1")
    monkeypatch.setenv("MXTPU_COMM_OVERLAP", "0")
    srv = tps.KVStoreServer(num_workers=1).start()
    monkeypatch.setenv("MXTPU_PS_ADDR", f"127.0.0.1:{srv.port}")
    kv = mt.kv.create("dist_async")
    kv.init("w", _arr(mt, np.zeros(3)))
    srv.kill()
    with pytest.raises(ConnectionError, match="RETRY_DEADLINE"):
        kv.push("w", _arr(mt, np.ones(3)))


def test_pending_pull_lands_at_the_next_read_and_write():
    from concurrent.futures import Future
    from mxnet_tpu_torch.comm_plane import PendingPull
    import torch
    a = mt.nd.zeros((3,), ctx=CPU)
    fut = Future()
    a._pending = PendingPull(fut, 1)
    fut.set_result([torch.ones(3), torch.full((3,), 2.0)])
    np.testing.assert_array_equal(a.asnumpy(), [2.0, 2.0, 2.0])
    assert a._pending is None
    b = mt.nd.zeros((3,), ctx=CPU)
    fut = Future()
    b._pending = PendingPull(fut, 0)
    fut.set_result([torch.full((3,), 4.0)])
    b[:] = 1.0                       # a write lands the pull first
    np.testing.assert_array_equal(b.asnumpy(), [1.0, 1.0, 1.0])
    c = mt.nd.zeros((3,), ctx=CPU)
    fut = Future()
    c._pending = PendingPull(fut, 0)
    fut.set_exception(RuntimeError("lost"))
    with pytest.raises(MXNetError, match="lost"):
        c.asnumpy()
