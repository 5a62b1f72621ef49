"""dist_sync correctness worker of the PyTorch port, spawned N times by
`tests/test_torch_dist_multiprocess.py` through `tools/launch.py
--launcher local` (the counterpart of `tests/dist_sync_worker.py`; the
reference proves distributed arithmetic the same way,
`tests/nightly/dist_sync_kvstore.py` under the dmlc tracker).

Every assertion is closed-form: after i synchronized push rounds with a
rate-scaled accumulate updater, a key holds
``1 + rate * i * nworker(nworker+1)/2`` exactly (reference
`dist_sync_kvstore.py:103-113`), for fp32 and fp16 keys, dense and
row_sparse, and the 2-bit path sums every worker's dequantized stream.
Then a `gluon.Trainer` and a `Module` over ``dist_sync`` take SGD steps
on each worker's shard of one batch and must equal one process that
steps on the whole batch; an `SPMDTrainer` step over the mesh that spans
the processes must equal a trainer over one process on the same batch.

Runs on the host (``cpu``, the default) or on ``gpu`` (argv[1]); it
imports neither JAX nor the JAX package.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.parallel import distributed as dist  # noqa: E402

RATE = 2.0
SHAPE = (2, 3)
BIG_SHAPE = (120, 120)
NREPEAT = 3


def check_diff(arr, scalar, rank):
    a = arr.asnumpy()
    assert np.sum(np.abs(a - scalar)) == 0, (rank, a.ravel()[:4], scalar)


def test_push_pull(kv, rank, nworker):
    """reference dist_sync_kvstore.py check_default_keys"""
    keys = []
    for dtype in ("float32", "float16"):
        for base, s in (("3", SHAPE), ("99", BIG_SHAPE)):
            key = f"{base}_{dtype}"
            kv.init(key, mt.nd.ones(s, dtype=dtype))
            keys.append((key, s, dtype))

    def updater(key, recv, stored):
        stored._set_data((stored + recv * RATE).astype(stored.dtype).data)

    kv.set_updater(updater)
    for key, s, dtype in keys:
        for i in range(NREPEAT):
            kv.push(key, mt.nd.ones(s, dtype=dtype) * (rank + 1))
            expected = (nworker + 1) * nworker * RATE / 2 * (i + 1) + 1
            val = mt.nd.zeros(s, dtype=dtype)
            kv.pull(key, out=val)
            check_diff(val, expected, rank)
            assert val.dtype == np.dtype(dtype)


def test_row_sparse(kv, rank, nworker):
    """reference check_row_sparse_keys: each worker pushes one hot row."""
    from mxnet_tpu_torch.ndarray import sparse
    key = "rsp_9"
    kv.init(key, mt.nd.ones(SHAPE))
    v = np.zeros(SHAPE, np.float32)
    v[rank % SHAPE[0]] = rank + 1

    def updater(key_, recv, stored):
        stored._set_data((stored + recv * RATE).data)

    kv.set_updater(updater)
    for i in range(NREPEAT):
        kv.push(key, mt.nd.array(v))
        expected = np.ones(SHAPE, np.float32)
        for r in range(nworker):
            expected[r % SHAPE[0]] += (r + 1) * RATE * (i + 1)
        row_ids = mt.nd.array(np.arange(SHAPE[0], dtype=np.float32))
        out = sparse.zeros("row_sparse", SHAPE)
        kv.row_sparse_pull(key, out=out, row_ids=row_ids)
        got = out.todense().asnumpy()
        assert np.sum(np.abs(got - expected)) == 0, (rank, got, expected)


def test_gradient_compression(kv, rank, nworker):
    """Compressed dist push: each worker quantizes with its own residual,
    the packed words are gathered, and the sum equals the sum of the
    workers' dequantized values (reference nightly dist_sync_kvstore.py
    test_sync_2bit_compression closed form)."""
    threshold = 0.5
    kv.set_gradient_compression({"type": "2bit", "threshold": threshold})
    key = "compr_1000"
    kv.init(key, mt.nd.zeros(SHAPE))

    def updater(key_, recv, stored):
        stored._set_data((stored + recv).data)

    kv.set_updater(updater)
    grads = [np.full(SHAPE, 0.3 * (r + 1), np.float32)
             for r in range(nworker)]
    residuals = [np.zeros(SHAPE, np.float32) for _ in range(nworker)]
    acc = np.zeros(SHAPE, np.float32)
    for i in range(NREPEAT):
        kv.push(key, mt.nd.array(grads[rank]))
        for r in range(nworker):
            rr = residuals[r] + grads[r]
            deq = np.where(rr >= threshold, threshold,
                           np.where(rr <= -threshold, -threshold, 0.0))
            residuals[r] = rr - deq
            acc += deq.astype(np.float32)
        out = mt.nd.zeros(SHAPE)
        kv.pull(key, out=out)
        assert np.sum(np.abs(out.asnumpy() - acc)) == 0, \
            (rank, i, out.asnumpy(), acc)
    kv.set_gradient_compression(None)
    kv.set_updater(None)


def _batch(nworker):
    rng = np.random.RandomState(7)
    w = rng.randn(4, 8).astype(np.float32) * 0.5
    x = rng.randn(4 * nworker, 8).astype(np.float32)
    y = (np.arange(4 * nworker) % 4).astype(np.float32)
    return w, x, y


def _trainer_step(x, y, w, kvstore, scale):
    """Two SGD steps of one Dense layer through `gluon.Trainer`."""
    net = mt.gluon.nn.Dense(4, in_units=8, use_bias=False, prefix="d_")
    net.initialize()
    net.weight.set_data(mt.nd.array(w))
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5}, kvstore=kvstore)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with mt.autograd.record():
            loss = loss_fn(net(mt.nd.array(x)), mt.nd.array(y))
        loss.backward()
        tr.step(scale)
    return net.weight.data().asnumpy(), tr


def test_trainer(rank, nworker):
    """gluon.Trainer(kvstore='dist_sync'): the workers' summed gradients
    over their shards equal one process's over the whole batch."""
    w, x, y = _batch(nworker)
    mine = slice(4 * rank, 4 * rank + 4)
    got, tr = _trainer_step(x[mine], y[mine], w, "dist_sync", 4 * nworker)
    assert tr._kvstore.num_workers == nworker
    want, _ = _trainer_step(x, y, w, None, 4 * nworker)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=f"rank {rank}")


def test_module(rank, nworker):
    """Module.init_optimizer(kvstore='dist_sync'): update on the store,
    batch_size scaled by num_workers, the same as one process."""
    w, x, y = _batch(nworker)
    data = mt.sym.var("data")
    fc = mt.sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    net = mt.sym.SoftmaxOutput(fc, name="softmax")

    def run(xs, ys, kvstore):
        mod = mt.mod.Module(net, context=mt.current_context())
        mod.bind(data_shapes=[("data", xs.shape)],
                 label_shapes=[("softmax_label", ys.shape)])
        mod.init_params(arg_params={"fc_weight": mt.nd.array(w)})
        mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = mt.io.DataBatch([mt.nd.array(xs)], [mt.nd.array(ys)])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        return mod.get_params()[0]["fc_weight"].asnumpy()

    mine = slice(4 * rank, 4 * rank + 4)
    got = run(x[mine], y[mine], "dist_sync")
    want = run(x, y, "local")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=f"rank {rank}")


def test_spmd_trainer(rank, nworker):
    """One dp=nworker SPMDTrainer step over the mesh that spans the
    processes equals a trainer over this process alone on the same
    global batch (the JAX worker's check)."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.gluon import nn, loss as gloss

    rng = np.random.RandomState(7)
    w1 = rng.randn(16, 8).astype(np.float32) * 0.1
    b1 = np.zeros(16, np.float32)
    w2 = rng.randn(4, 16).astype(np.float32) * 0.1
    b2 = np.zeros(4, np.float32)
    x = rng.randn(8, 8).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.float32)

    def build(mesh_devices):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize()
        net(mt.nd.array(x[:2]))
        params = net.collect_params()
        for name, val in zip(list(params.keys()), (w1, b1, w2, b2)):
            params[name].set_data(mt.nd.array(val))
        mesh = par.auto_mesh(len(mesh_devices), devices=mesh_devices)
        return par.SPMDTrainer(
            net, mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
            gloss.SoftmaxCrossEntropyLoss(), mesh=mesh)

    tr_dist = build(par.devices())               # spans every process
    ld = float(tr_dist.step(x, y))
    tr_local = build(par.devices()[rank:rank + 1])   # this process only
    ll = float(tr_local.step(x, y))
    assert np.isfinite(ld) and np.isfinite(ll)
    assert abs(ld - ll) < 1e-4, (rank, ld, ll)
    for nd_, nl in zip(tr_dist._train_names, tr_local._train_names):
        np.testing.assert_allclose(
            np.asarray(tr_dist.params[nd_]), np.asarray(tr_local.params[nl]),
            rtol=1e-5, atol=1e-5, err_msg=f"rank {rank} param {nd_}")


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    ctx = mt.gpu(0) if (sys.argv[1:] or ["cpu"])[0] == "gpu" else mt.cpu()
    with ctx:
        kv = mt.kv.create("dist_sync")
        rank, nworker = dist.rank(), dist.size()
        assert nworker == int(os.environ["DMLC_NUM_WORKER"]), \
            (nworker, os.environ["DMLC_NUM_WORKER"])
        assert rank == int(os.environ["DMLC_WORKER_ID"])
        assert kv.rank == rank and kv.num_workers == nworker

        test_push_pull(kv, rank, nworker)
        dist.barrier("after_push_pull")
        test_row_sparse(kv, rank, nworker)
        dist.barrier("after_row_sparse")
        test_gradient_compression(kv, rank, nworker)
        dist.barrier("after_compression")
        test_trainer(rank, nworker)
        test_module(rank, nworker)
        dist.barrier("after_training")
        test_spmd_trainer(rank, nworker)
        dist.barrier("after_spmd_trainer")
    print(f"WORKER {rank}/{nworker} ALL PASSED", flush=True)


if __name__ == "__main__":
    main()
