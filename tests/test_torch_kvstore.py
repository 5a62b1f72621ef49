"""The PyTorch port's local KVStore and 2-bit gradient compression
against the JAX package (`mxnet_tpu/kvstore.py`,
`mxnet_tpu/gradient_compression.py`; cases adapted from
`tests/test_kvstore.py`): the same numpy inputs through both packages'
stores, results equal within 1e-6 (the stores only copy, sum and run one
optimizer op)."""
import pickle
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

SHAPE = (4, 5)
CPU = mt.cpu()
TOL = 1e-6


def _t(x):
    return mt.nd.array(np.asarray(x, np.float32), ctx=CPU)


def _j(x):
    return mx.nd.array(np.asarray(x, np.float32))


def _pair(name="local"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mx.kv.create(name), mt.kv.create(name)


def _pull_both(jkv, tkv, key, shape=SHAPE):
    jo, to = mx.nd.zeros(shape), mt.nd.zeros(shape, ctx=CPU)
    jkv.pull(key, out=jo)
    tkv.pull(key, out=to)
    return jo.asnumpy(), to.asnumpy()


@pytest.mark.parametrize("name", ["local", "device", "nccl", "dist_sync",
                                  "dist_device_sync"])
def test_push_sums_replicas_like_reference(name):
    rs = np.random.RandomState(0)
    w0, a, b = (rs.randn(*SHAPE).astype(np.float32) for _ in range(3))
    jkv, tkv = _pair(name)
    assert (tkv.type, tkv.rank, tkv.num_workers) == (name, 0, 1)
    jkv.init("w", _j(w0))
    tkv.init("w", _t(w0))
    j, t = _pull_both(jkv, tkv, "w")
    np.testing.assert_array_equal(t, j)
    jkv.push("w", [_j(a), _j(b)])
    tkv.push("w", [_t(a), _t(b)])
    j, t = _pull_both(jkv, tkv, "w")
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
    np.testing.assert_allclose(t, a + b, rtol=0, atol=TOL)
    tkv.barrier()


def test_list_keys_and_priorities():
    rs = np.random.RandomState(1)
    keys = [5, 7, 9]
    vals = [rs.randn(*SHAPE).astype(np.float32) for _ in keys]
    jkv, tkv = _pair()
    jkv.init(keys, [_j(v) for v in vals])
    tkv.init(keys, [_t(v) for v in vals])
    jkv.push(keys, [_j(v * 4) for v in vals], priority=[0, 2, 1])
    tkv.push(keys, [_t(v * 4) for v in vals], priority=[0, 2, 1])
    jo = [mx.nd.zeros(SHAPE) for _ in keys]
    to = [mt.nd.zeros(SHAPE, ctx=CPU) for _ in keys]
    jkv.pull(keys, out=jo, priority=-1)
    tkv.pull(keys, out=to, priority=-1)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), atol=TOL)


def test_keys_apply_in_descending_priority():
    """One call's keys reach the updater highest priority first, stable
    among equals (the JAX package's comm plane order)."""
    seen = {}
    for pkg, kv, arr in ((mx, mx.kv.create("local"), _j),
                         (mt, mt.kv.create("local"), _t)):
        order = seen.setdefault(pkg.__name__, [])
        kv.init(["a", "b", "c", "d"], [arr(np.zeros(SHAPE))] * 4)
        kv.set_updater(lambda k, g, w, order=order: order.append(k))
        kv.push(["a", "b", "c", "d"], [arr(np.ones(SHAPE))] * 4,
                priority=[1, 3, 1, 2])
    assert seen["mxnet_tpu_torch"] == seen["mxnet_tpu"] == ["b", "d", "a",
                                                             "c"]


@pytest.mark.parametrize("opt,kw", [
    ("SGD", dict(learning_rate=0.1)),
    ("SGD", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("Adam", dict(learning_rate=0.01)),
    ("AdaGrad", dict(learning_rate=0.05)),
])
def test_update_on_kvstore_matches_reference(opt, kw):
    rs = np.random.RandomState(2)
    w0 = rs.randn(*SHAPE).astype(np.float32)
    jkv, tkv = _pair()
    jkv.init("3", _j(w0))
    tkv.init("3", _t(w0))
    jkv.set_optimizer(getattr(mx.optimizer, opt)(**kw))
    tkv.set_optimizer(getattr(mt.optimizer, opt)(**kw))
    for _ in range(4):
        g = [rs.randn(*SHAPE).astype(np.float32) for _ in range(2)]
        jkv.push("3", [_j(x) for x in g])
        tkv.push("3", [_t(x) for x in g])
    j, t = _pull_both(jkv, tkv, "3")
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=TOL)
    # the store keeps its own copy of the optimizer (a pickle round trip)
    assert isinstance(tkv._updater_obj.optimizer, getattr(mt.optimizer, opt))
    assert sorted(tkv._updater_obj.states) == sorted(
        jkv._updater_obj.states) == [3]


def test_pushpull_and_custom_updater():
    rs = np.random.RandomState(3)
    w0, g = rs.randn(*SHAPE), rs.randn(*SHAPE)
    jkv, tkv = _pair()
    jkv.init(3, _j(w0))
    tkv.init(3, _t(w0))
    jkv.set_updater(lambda k, r, s: s._set_data((s + r * 2).data))
    tkv.set_updater(lambda k, r, s: s._set_data((s + r * 2).data))
    jo, to = mx.nd.zeros(SHAPE), mt.nd.zeros(SHAPE, ctx=CPU)
    jkv.pushpull(3, _j(g), out=jo)
    tkv.pushpull(3, _t(g), out=to)
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), atol=TOL)


def test_uninitialized_key_and_sparse_pull_refused():
    kv = mt.kv.create("local")
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.push("x", _t(np.ones(SHAPE)))
    kv.init("x", _t(np.ones(SHAPE)))
    rsp = mt.nd.sparse.zeros("row_sparse", SHAPE, ctx=CPU)
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull("x", out=rsp, ignore_sparse=False)
    kv.pull("x", out=rsp)               # ignore_sparse: skipped
    assert rsp._sp_indices.numel() == 0


@pytest.mark.parametrize("ids", [[3, 0, 3, 1], np.array([2, 2, 2]),
                                 [0, 1, 2, 3]])
def test_row_sparse_pull_matches_reference(ids):
    rs = np.random.RandomState(4)
    w = rs.randn(*SHAPE).astype(np.float32)
    jkv, tkv = _pair()
    jkv.init("emb", _j(w))
    tkv.init("emb", _t(w))
    jo = mx.nd.sparse.zeros("row_sparse", SHAPE)
    to = mt.nd.sparse.zeros("row_sparse", SHAPE, ctx=CPU)
    jkv.row_sparse_pull("emb", out=jo, row_ids=_j(ids))
    tkv.row_sparse_pull("emb", out=to, row_ids=_t(ids))
    to.check_format()
    np.testing.assert_array_equal(to.indices.asnumpy(),
                                  np.asarray(jo.indices.asnumpy()))
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())
    np.testing.assert_array_equal(to.indices.asnumpy(), np.unique(ids))
    # a dense out: the rows and zeros elsewhere
    jd, td = mx.nd.ones(SHAPE), mt.nd.ones(SHAPE, ctx=CPU)
    jkv.row_sparse_pull("emb", out=jd, row_ids=_j(ids))
    tkv.row_sparse_pull("emb", out=td, row_ids=_t(ids))
    np.testing.assert_array_equal(td.asnumpy(), jd.asnumpy())


def test_row_sparse_gradient_push_densifies_like_reference():
    """A row-sparse gradient goes through the updater densified, every
    row updated (SGD with wd moves untouched rows too), as in the JAX
    package; ``lazy_update`` is accepted and stored."""
    rs = np.random.RandomState(5)
    w = rs.randn(6, 3).astype(np.float32)
    g = np.zeros((6, 3), np.float32)
    g[[1, 4]] = rs.randn(2, 3)
    jkv, tkv = _pair()
    jkv.init("w", _j(w))
    tkv.init("w", _t(w))
    jkv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, wd=0.1,
                                       lazy_update=True))
    tkv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, wd=0.1,
                                       lazy_update=True))
    assert tkv._updater_obj.optimizer.lazy_update is True
    jkv.push("w", _j(g).tostype("row_sparse"))
    tkv.push("w", _t(g).tostype("row_sparse"))
    j, t = _pull_both(jkv, tkv, "w", (6, 3))
    np.testing.assert_allclose(t, j, atol=TOL)


def test_dist_async_warns_or_refuses(monkeypatch):
    with pytest.warns(UserWarning, match="synchronous"):
        kv = mt.kv.create("dist_async")
    kv.init("a", _t(np.zeros(SHAPE)))
    kv.push("a", _t(np.ones(SHAPE) * 7))
    out = mt.nd.zeros(SHAPE, ctx=CPU)
    kv.pull("a", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 7 * np.ones(SHAPE))
    monkeypatch.setenv("BYTEPS_ENABLE_ASYNC", "1")
    monkeypatch.setenv("MXTPU_PS_ADDR", "127.0.0.1:9")
    with pytest.raises(MXNetError, match="ps_server.py"):
        mt.kv.create("dist_async")
    with pytest.raises(MXNetError, match="unknown KVStore"):
        mt.kv.create("bogus")


@pytest.mark.parametrize("dump", [False, True])
def test_optimizer_states_cross_packages(tmp_path, dump):
    """The store's optimizer states file of either package loads in the
    other (the pickle names the JAX package's classes; the port reads them
    as its own) and both go on to the same weights."""
    rs = np.random.RandomState(6)
    w0 = rs.randn(*SHAPE).astype(np.float32)
    jkv, tkv = _pair()
    jkv.init(0, _j(w0))
    tkv.init(0, _t(w0))
    jkv.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    tkv.set_optimizer(mt.optimizer.Adam(learning_rate=0.01))
    g = rs.randn(*SHAPE).astype(np.float32)
    for _ in range(2):
        jkv.push(0, _j(g))
        tkv.push(0, _t(g))
    jf, tf = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jkv.save_optimizer_states(jf, dump_optimizer=dump)
    tkv.save_optimizer_states(tf, dump_optimizer=dump)
    assert b"mxnet_tpu_torch" not in open(tf, "rb").read()
    j2, t2 = _pair()
    j2.init(0, _j(w0))
    t2.init(0, _t(w0))
    j2.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    t2.set_optimizer(mt.optimizer.Adam(learning_rate=0.01))
    j2.load_optimizer_states(tf)         # the port's file in the JAX store
    t2.load_optimizer_states(jf)         # and the reverse
    for a, b in zip(t2._updater_obj.states[0], jkv._updater_obj.states[0]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    if dump:
        assert t2._updater_obj.optimizer._index_update_count == {0: 2}
        assert j2._updater_obj.optimizer._index_update_count == {0: 2}


# ---------------------------------------------------------------------------
# 2-bit compression
# ---------------------------------------------------------------------------

def test_quantize_2bit_matches_reference():
    from mxnet_tpu import gradient_compression as jgc
    from mxnet_tpu_torch import gradient_compression as tgc
    import torch
    rs = np.random.RandomState(7)
    arr = rs.uniform(-2, 2, (7, 9)).astype(np.float32)
    jres = tres = np.zeros_like(arr)
    for _ in range(3):
        jq, jres = jgc.quantize_2bit(arr, jres, 0.5)
        tq, tres = tgc.quantize_2bit(torch.from_numpy(arr),
                                     torch.as_tensor(np.asarray(tres)), 0.5)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert set(np.unique(tq.numpy())) <= {-0.5, 0.0, 0.5}


@pytest.mark.parametrize("n", [1, 16, 53, 160])
def test_pack_unpack_2bit_layout_matches_reference(n):
    from mxnet_tpu import gradient_compression as jgc
    from mxnet_tpu_torch import gradient_compression as tgc
    import torch
    rs = np.random.RandomState(n)
    q = rs.choice([-0.7, 0.0, 0.7], n).astype(np.float32)
    words = tgc.pack_2bit(torch.from_numpy(q), 0.7)
    want = np.asarray(jgc.pack_2bit(q, 0.7))
    assert words.dtype == torch.uint32 and words.shape == want.shape
    np.testing.assert_array_equal(words.to(torch.int64).numpy(),
                                  want.astype(np.int64))
    back = tgc.unpack_2bit(words, 0.7, n)
    np.testing.assert_array_equal(back.numpy(), q)
    gc = tgc.GradientCompression({"type": "2bit", "threshold": 0.7})
    summed = gc.decompress_sum(torch.stack([words, words]), (n,),
                               torch.float32)
    np.testing.assert_array_equal(summed.numpy(), 2 * q)


def test_compressed_push_error_feedback_matches_reference():
    rs = np.random.RandomState(8)
    jkv, tkv = _pair("device")
    for kv in (jkv, tkv):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    jkv.init("w", mx.nd.zeros(SHAPE))
    tkv.init("w", mt.nd.zeros(SHAPE, ctx=CPU))
    jkv.set_updater(lambda k, r, s: s._set_data((s + r).data))
    tkv.set_updater(lambda k, r, s: s._set_data((s + r).data))
    for _ in range(4):
        g = rs.uniform(-0.6, 0.6, SHAPE).astype(np.float32)
        jkv.push("w", _j(g))
        tkv.push("w", _t(g))
        j, t = _pull_both(jkv, tkv, "w")
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tkv._gc._residuals["w"].numpy(),
                                  np.asarray(jkv._gc._residuals["w"]))
    tkv.init("w", mt.nd.zeros(SHAPE, ctx=CPU))    # a re-init resets it
    assert "w" not in tkv._gc._residuals
    with pytest.raises(ValueError):
        tkv.set_gradient_compression({"type": "1bit"})
    with pytest.raises(ValueError):
        tkv.set_gradient_compression({"type": "2bit", "threshold": 0})


def test_optimizer_pickles_without_live_parameters():
    opt = mt.optimizer.SGD(learning_rate=0.1, param_dict={0: object()})
    back = pickle.loads(pickle.dumps(opt))
    assert back.param_dict == {} and back.lr == 0.1
