"""The port's `BucketingModule`, `Module` checkpoints and states, `model`
and the checkpoint callbacks on the CPU, against the JAX package: a small
fused-LSTM language model (the reference's
``example/rnn/bucketing/lstm_bucketing.py``, cut to vocab 20, embed 6,
hidden 8) trained through both packages' ``BucketingModule.fit`` across
three buckets from the same ``arg_params`` and batches; the buckets share
one set of parameter arrays and one optimizer; checkpoints interchange."""
import logging
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.rnn import io as tio
from mxnet_tpu_torch.symbol import symbol as tsym

# the reference's SGD parity tolerance (tests/test_torch_fit.py)
SGD_TOL = 1e-4
METRIC_TOL = 1e-5
VOCAB, EMBED, HIDDEN, BATCH = 20, 6, 8, 4
BUCKETS = (3, 5, 8)


@pytest.fixture(autouse=True)
def fresh_names():
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _sym_gen(pkg, layers=2, dropout=0.0):
    """The example's ``sym_gen`` over one `FusedRNNCell`."""
    cell = pkg.rnn.FusedRNNCell(HIDDEN, num_layers=layers, mode="lstm",
                                dropout=dropout, prefix="lstm_")

    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        label = pkg.sym.var("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                  name="embed")
        out, _ = cell.unroll(seq_len, embed, layout="NTC",
                             merge_outputs=True)
        pred = pkg.sym.Reshape(out, shape=(-1, HIDDEN))
        pred = pkg.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))
    return cell, sym_gen


def _batches(seed, n_per_bucket=2, buckets=BUCKETS):
    """Next-token batches of random ids per bucket, in a fixed
    interleaved order; label 0 pads the shifted tail, as the iterator's
    ``invalid_label=0``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_per_bucket):
        for t in buckets:
            data = rng.randint(1, VOCAB, (BATCH, t)).astype(np.float32)
            label = np.zeros_like(data)
            label[:, :-1] = data[:, 1:]
            out.append((t, data, label))
    return out


class _ListIter:
    """A fixed list of bucketed batches as a data iterator of ``pkg``."""

    def __init__(self, pkg, batches):
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        self.batches = [pkg.io.DataBatch(
            [pkg.nd.array(d, **ctx)], [pkg.nd.array(lab, **ctx)],
            bucket_key=t,
            provide_data=[pkg.io.DataDesc("data", d.shape)],
            provide_label=[pkg.io.DataDesc("softmax_label", lab.shape)])
            for t, d, lab in batches]
        key = max(t for t, _, _ in batches)
        self.default_bucket_key = key
        self.provide_data = [pkg.io.DataDesc("data", (BATCH, key))]
        self.provide_label = [pkg.io.DataDesc("softmax_label", (BATCH, key))]

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.batches)


def _arg_params(seed=0):
    """Seeded weights of the default bucket's graph."""
    _, gen = _sym_gen(mx)
    sym = gen(max(BUCKETS))[0]
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(BATCH, max(BUCKETS)), softmax_label=(BATCH, max(BUCKETS)))[0]))
    rng = np.random.RandomState(seed)
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _fit(pkg, batches, arg_params, epochs=2, optimizer="sgd",
         opt_params=None):
    _, gen = _sym_gen(pkg)
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = pkg.mod.BucketingModule(gen, default_bucket_key=max(BUCKETS),
                                  context=ctx)
    args = {n: (mt.nd.array(a, ctx=mt.cpu()) if pkg is mt else
                mx.nd.array(a)) for n, a in arg_params.items()}
    metric = pkg.metric.Perplexity(0)
    mod.fit(_ListIter(pkg, batches), eval_metric=metric, num_epoch=epochs,
            optimizer=optimizer, arg_params=args,
            optimizer_params=opt_params or {"learning_rate": 0.5,
                                            "momentum": 0.9, "wd": 1e-5})
    return mod, metric.get()[1]


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}),
    ("adam", {"learning_rate": 0.01})])
def test_bucketing_fit_matches_reference(optimizer, opt_params):
    batches = _batches(1)
    params = _arg_params()
    ref, ref_ppl = _fit(mx, batches, params, optimizer=optimizer,
                        opt_params=opt_params)
    got, ppl = _fit(mt, batches, params, optimizer=optimizer,
                    opt_params=opt_params)
    assert sorted(got._buckets) == sorted(ref._buckets) == list(BUCKETS)
    np.testing.assert_allclose(ppl, ref_ppl, rtol=METRIC_TOL)
    want, _ = ref.get_params()
    have, _ = got.get_params()
    assert sorted(have) == sorted(want)
    for name in want:
        w = want[name].asnumpy()
        assert not np.allclose(w, params[name]), name  # it trained
        np.testing.assert_allclose(have[name].asnumpy(), w, rtol=SGD_TOL,
                                   atol=SGD_TOL, err_msg=name)
    # the trained modules score alike, each batch on its bucket
    it_ref, it_got = _ListIter(mx, batches), _ListIter(mt, batches)
    np.testing.assert_allclose(
        got.score(it_got, mt.metric.Perplexity(0))[0][1],
        ref.score(it_ref, mx.metric.Perplexity(0))[0][1], rtol=SGD_TOL)


def test_buckets_share_parameter_storage_and_optimizer():
    mod, _ = _fit(mt, _batches(2), _arg_params(1), epochs=1)
    mods = list(mod._buckets.values())
    default = mod._buckets[max(BUCKETS)]
    for name in ("embed_weight", "lstm_parameters", "pred_weight",
                 "pred_bias"):
        ptrs = {m._exec.arg_dict[name].data.data_ptr() for m in mods}
        grads = {m._exec.grad_dict[name].data.data_ptr() for m in mods}
        assert len(ptrs) == 1 and len(grads) == 1, name
    assert {id(m._updater) for m in mods} == {id(default._updater)}
    assert {id(m._optimizer) for m in mods} == {id(default._optimizer)}
    # one optimizer state per parameter, created once
    n_params = len(default._exec._grad_arg_names)
    assert len(default._updater.states) == n_params
    # each bucket built its programs in its own slot of the cache
    assert sorted(mod._graph_programs) == list(BUCKETS)
    for key, m in mod._buckets.items():
        assert m._exec._programs is mod._graph_programs[key]
        assert True in mod._graph_programs[key]


def test_set_params_and_init_write_in_place():
    mod, _ = _fit(mt, _batches(3), _arg_params(2), epochs=1)
    ptrs = {n: a.data.data_ptr()
            for n, a in mod._buckets[3]._exec.arg_dict.items()}
    arg, aux = mod.get_params()
    mod.set_params({n: mt.nd.array(np.zeros(a.shape, np.float32),
                                   ctx=mt.cpu()) for n, a in arg.items()},
                   aux)
    mod.init_params(initializer=mt.init.Xavier(), force_init=True)
    for m in mod._buckets.values():
        for n, a in m._exec.arg_dict.items():
            if n in ptrs and n not in ("data", "softmax_label"):
                assert a.data.data_ptr() == ptrs[n], n
    assert float(np.abs(mod._buckets[3]._exec.arg_dict["pred_weight"]
                        .asnumpy()).sum()) > 0


def test_force_rebind_keeps_trained_values():
    mod, _ = _fit(mt, _batches(4), _arg_params(3), epochs=1)
    before, _ = mod.get_params()
    mod.bind(data_shapes=[mt.io.DataDesc("data", (BATCH, max(BUCKETS)))],
             label_shapes=[mt.io.DataDesc("softmax_label",
                                          (BATCH, max(BUCKETS)))],
             force_rebind=True)
    assert list(mod._buckets) == [max(BUCKETS)]
    after, _ = mod.get_params()
    for n in before:
        np.testing.assert_array_equal(after[n].asnumpy(),
                                      before[n].asnumpy())


#: the seed of the iterator's shuffles in the test below (final perplexity
#: 5.74 against the limit of 6.67); of seeds 0-39, all but 24 and 33 pass
SHUFFLE_SEED = 0


def _bucket_lm_perplexities(monkeypatch, shuffle_seed):
    """Per-epoch perplexity of the reference example's workflow on Markov
    sentences through `BucketSentenceIter`.  The iterator shuffles
    unseeded, as the reference's; here its Python and numpy streams are
    seeded, so the run is the same every time."""
    real_rng = np.random.default_rng
    rng = real_rng(shuffle_seed)
    monkeypatch.setattr(tio, "_pyrandom", random.Random(shuffle_seed))
    monkeypatch.setattr(tio.np.random, "default_rng",
                        lambda seed=None: rng if seed is None
                        else real_rng(seed))
    rs = np.random.RandomState(0)
    succ = rs.randint(1, VOCAB, (VOCAB, 2))
    sents = []
    for _ in range(96):
        s = [int(rs.randint(1, VOCAB))]
        for _ in range(int(rs.choice(BUCKETS)) - 1):
            s.append(int(succ[s[-1], rs.randint(2)]))
        sents.append(s)
    it = mt.rnn.BucketSentenceIter(sents, 8, buckets=list(BUCKETS),
                                   invalid_label=0)
    _, gen = _sym_gen(mt, layers=1)
    mt.random.seed(0)
    mod = mt.mod.BucketingModule(gen, default_bucket_key=it.default_bucket_key,
                                 context=mt.cpu())
    seen = []
    mod.fit(it, eval_metric=mt.metric.Perplexity(0), num_epoch=6,
            optimizer="adam", optimizer_params={"learning_rate": 0.02},
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            epoch_end_callback=lambda e, s, a, x: seen.append(
                mod.score(it, mt.metric.Perplexity(0))[0][1]))
    assert sorted(mod._buckets) == list(BUCKETS)
    return seen


def test_bucketing_lm_learns_from_bucket_sentence_iter(monkeypatch):
    """The reference example's workflow on Markov sentences through
    `BucketSentenceIter`: perplexity falls and every bucket trains."""
    seen = _bucket_lm_perplexities(monkeypatch, SHUFFLE_SEED)
    assert seen[-1] < seen[0] and seen[-1] < VOCAB / 3, seen


def _states_module(ctx):
    """A one-step fused LSTM whose begin states are module-held inputs."""
    cell = mt.rnn.FusedRNNCell(HIDDEN, mode="lstm", prefix="st_",
                               get_next_state=True)
    data = mt.sym.var("data")
    out, states = cell.unroll(2, data, begin_state=cell.begin_state(),
                              layout="TNC", merge_outputs=True)
    sym = mt.sym.Group([out] + states)
    mod = mt.mod.Module(sym, data_names=("data",), label_names=None,
                        state_names=["st_begin_state_0",
                                     "st_begin_state_1"], context=ctx)
    mod.bind([("data", (2, BATCH, EMBED))], for_training=False)
    mod.init_params(initializer=mt.init.Xavier())
    return mod


def test_module_states_are_held_and_set():
    mod = _states_module(mt.cpu())
    assert "st_begin_state_0" not in mod.get_params()[0]
    x = mt.io.DataBatch([mt.nd.array(np.ones((2, BATCH, EMBED), np.float32),
                                     ctx=mt.cpu())])
    mod.forward(x)
    zero_out = mod.get_outputs()[0].asnumpy()
    states = mod.get_states()
    assert [s.shape for s in states] == [(1, BATCH, HIDDEN)] * 2
    assert all(float(np.abs(s.asnumpy()).sum()) == 0 for s in states)
    mod.set_states(value=0.5)
    mod.forward(x)
    assert not np.allclose(mod.get_outputs()[0].asnumpy(), zero_out)
    assert float(states[0].asnumpy().sum()) == 0   # a copy, not a view
    mod.set_states(states=states)
    mod.forward(x)
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), zero_out)
    with pytest.raises(mt.MXNetError):
        mod.set_states(states=states, value=1.0)


def _mlp(pkg):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


def test_module_checkpoint_and_load(tmp_path):
    prefix = str(tmp_path / "mlp")
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    it = mt.io.NDArrayIter(x, y, batch_size=4)
    cb = mt.callback.module_checkpoint(mod, prefix, period=1,
                                       save_optimizer_states=True)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            epoch_end_callback=cb)
    for suffix in ("symbol.json", "0001.params", "0002.params",
                   "0002.states"):
        assert (tmp_path / f"mlp-{suffix}").exists(), suffix
    loaded = mt.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                context=mt.cpu())
    loaded.bind(it.provide_data, it.provide_label)
    want, _ = mod.get_params()
    got, _ = loaded.get_params()
    for n in want:
        np.testing.assert_array_equal(got[n].asnumpy(), want[n].asnumpy())
    loaded.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9})
    ref_states = mod._updater.states
    assert sorted(loaded._updater.states) == sorted(ref_states)
    for k in ref_states:
        np.testing.assert_array_equal(loaded._updater.states[k].asnumpy(),
                                      ref_states[k].asnumpy())
    # the JAX package reads the port's checkpoint
    _, jarg, _ = mx.model.load_checkpoint(prefix, 2)
    for n in want:
        np.testing.assert_array_equal(jarg[n].asnumpy(), want[n].asnumpy())


def test_do_checkpoint_and_model_interchange(tmp_path):
    prefix = str(tmp_path / "m")
    sym = _mlp(mt)
    arg = {"fc_weight": mt.nd.array(np.arange(12, dtype=np.float32)
                                    .reshape(3, 4), ctx=mt.cpu()),
           "fc_bias": mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu())}
    cb = mt.callback.do_checkpoint(prefix, period=2)
    for epoch in range(3):
        cb(epoch, sym, arg, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["m-0002.params", "m-symbol.json"]
    for pkg in (mx, mt):
        sym2, arg2, aux2 = pkg.model.load_checkpoint(prefix, 2)
        assert sym2.tojson() == sym.tojson() and aux2 == {}
        for n in arg:
            np.testing.assert_array_equal(arg2[n].asnumpy(),
                                          arg[n].asnumpy())
    # the JAX package's checkpoint loads in the port
    mx.model.save_checkpoint(prefix + "j", 1, _mlp(mx),
                             {n: mx.nd.array(a.asnumpy())
                              for n, a in arg.items()}, {})
    arg3, aux3 = mt.model.load_params(prefix + "j", 1)
    assert sorted(arg3) == sorted(arg) and aux3 == {}
    assert arg3["fc_weight"].data.device == torch.device("cpu")


def test_feedforward_wraps_module(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(16, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    model = mt.model.FeedForward.create(
        _mlp(mt), mt.io.NDArrayIter(x, y, batch_size=8), ctx=mt.cpu(),
        num_epoch=2, learning_rate=0.1,
        initializer=mt.init.Xavier())
    assert model.predict(mt.io.NDArrayIter(x, y, batch_size=8)).shape == \
        (16, 3)
    model.save(str(tmp_path / "ff"))
    back = mt.model.FeedForward.load(str(tmp_path / "ff"), 2,
                                     ctx=mt.cpu())
    assert sorted(back._arg_params) == ["fc_bias", "fc_weight"]


def test_bucketing_module_needs_a_default_key():
    with pytest.raises(mt.MXNetError):
        mt.mod.BucketingModule(lambda k: None, logger=logging)
    mod = mt.mod.BucketingModule(_sym_gen(mt)[1], default_bucket_key=5,
                                 context=mt.cpu())
    with pytest.raises(mt.MXNetError):
        mod.init_params()
