"""Multi-rank worker of the SPMD plane's CPU parity tests.

`tests/torch_spmd_launch.run_suite` starts N copies of this script through
``tools/launch.py --launcher local``; they form one gloo group
(`parallel.distributed.initialize` from the launcher's ``DMLC_*`` env) and
run one suite of checks on the port, each rank writing its results to
``OUTDIR/SUITE-RANK.npz``.  The tests compare them with the JAX package
run in their own process on its virtual devices, at the same mesh size.
The inputs are made here, from seeds, and the tests import the same
functions.  This script imports neither JAX nor the JAX package.

    python tests/torch_spmd_worker.py SUITE OUTDIR
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch import profiler  # noqa: E402
from mxnet_tpu_torch.parallel import collectives as C  # noqa: E402
from mxnet_tpu_torch.parallel import distributed as dist  # noqa: E402
from mxnet_tpu_torch.parallel.sharding import P  # noqa: E402

CPU = mt.cpu()


# ---------------------------------------------------------------------------
# inputs (the tests import these)
# ---------------------------------------------------------------------------

def mlp_weights(in_dim, seed, widths=(32, 16, 10)):
    """Dense weights (out, in) and zero biases of an MLP, by layer."""
    rs = np.random.RandomState(seed)
    out, d = [], in_dim
    for w in widths:
        out.append((rs.randn(w, d).astype(np.float32) * (2.0 / d) ** 0.5,
                    np.zeros(w, np.float32)))
        d = w
    return out


def gluon_mlp(pkg, weights, prefix="mlp_", ctx=None):
    """``pkg``'s Gluon MLP (relu, relu, linear) with ``weights``."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        for j, (w, _b) in enumerate(weights):
            net.add(nn.Dense(w.shape[0],
                             activation="relu" if j < len(weights) - 1
                             else None))
    kw = {"ctx": ctx} if ctx is not None else {}
    net.initialize(**kw)
    x = pkg.nd.zeros((2, weights[0][0].shape[1]), **kw)
    net(x)
    params = net.collect_params()
    for j, (w, b) in enumerate(weights):
        params[f"{prefix}dense{j}_weight"].set_data(pkg.nd.array(w, **kw))
        params[f"{prefix}dense{j}_bias"].set_data(pkg.nd.array(b, **kw))
    return net


def trainer_data(seed, n, feat, classes=10, k=None):
    rs = np.random.RandomState(seed)
    lead = (k,) if k else ()
    x = rs.randn(*lead, n, feat).astype(np.float32)
    y = rs.randint(0, classes, lead + (n,)).astype(np.float32)
    return x, y


def attention_inputs(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


RING_LM = dict(vocab=16, dim=32, heads=4, seq_len=64, batch=2)


def ring_lm_inputs():
    """The ring LM's weights and one needle batch, small."""
    from mxnet_tpu_torch.model_zoo import needle_batch, ring_lm_numpy_params
    c = RING_LM
    params = ring_lm_numpy_params(0, c["vocab"], c["dim"], c["seq_len"])
    tok, tgt = needle_batch(np.random.RandomState(1), c["batch"],
                            c["seq_len"], c["vocab"])
    return params, tok, tgt


def stage_weights(seed, s, d):
    rs = np.random.RandomState(seed)
    return [{"w": rs.randn(d, d).astype(np.float32) * 0.5,
             "b": rs.randn(d).astype(np.float32) * 0.1} for _ in range(s)]


def moe_weights(seed, d, h, e):
    rs = np.random.RandomState(seed)
    return (rs.randn(d, e).astype(np.float32) * 0.3,
            rs.randn(e, d, h).astype(np.float32) * (2.0 / d) ** 0.5,
            rs.randn(e, h, d).astype(np.float32) * (2.0 / h) ** 0.5)


def module_weights(seed, feat=16):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(24, feat).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(24, np.float32),
            "fc2_weight": rs.randn(10, 24).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(10, np.float32)}


def module_batches(n, seed=3, batch=16, feat=16):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, feat).astype(np.float32),
             rs.randint(0, 10, (batch,)).astype(np.float32))
            for _ in range(n)]


def make_module(pkg, opt="sgd", seed=0, batch=16, feat=16, ctx=None,
                **opt_kw):
    """``pkg``'s fc1-relu-fc2-SoftmaxOutput Module, bound and initialized
    from `module_weights`."""
    sym = pkg.sym
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    h = sym.FullyConnected(data, num_hidden=24, name="fc1")
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, num_hidden=10, name="fc2")
    out = sym.SoftmaxOutput(h, label, name="softmax")
    kw = {"context": ctx} if ctx is not None else {}
    mod = pkg.mod.Module(out, data_names=["data"],
                         label_names=["softmax_label"], **kw)
    mod.bind(data_shapes=[("data", (batch, feat))],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    akw = {"ctx": ctx} if ctx is not None else {}
    mod.init_params(arg_params={k: pkg.nd.array(v, **akw) for k, v in
                                module_weights(seed, feat).items()})
    mod.init_optimizer(optimizer=opt,
                       optimizer_params={"learning_rate": 0.05, **opt_kw})
    return mod


def data_batch(pkg, x, y, ctx=None):
    kw = {"ctx": ctx} if ctx is not None else {}
    return pkg.io.DataBatch(data=[pkg.nd.array(x, **kw)],
                            label=[pkg.nd.array(y, **kw)])


def snap(mod):
    """(params, flat states) of a Module, as numpy."""
    params, _ = mod.get_params()
    states = pickle.loads(mod._updater.get_states())
    flat = {}
    for k, v in states.items():
        for j, x in enumerate(v if isinstance(v, tuple) else (v,)):
            if x is not None:
                flat[f"{k}.{j}"] = np.asarray(x)
    return {k: v.asnumpy() for k, v in params.items()}, flat


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def suite_collectives(rank, n):
    res = {}
    mesh = par.make_mesh({par.DP: n})
    spec = P(par.DP)

    def run(body, x):
        return C.shard_map(body, mesh=mesh, in_specs=(spec,),
                           out_specs=spec)(_t(x))

    x = np.random.RandomState(0).randn(n, 64).astype(np.float32)

    def rs_body(xs):
        full = C.psum(xs[0], par.DP)
        mine = C.reduce_scatter(xs[0], par.DP)
        r = C.axis_index(par.DP)
        want = full[r * mine.shape[0]:(r + 1) * mine.shape[0]]
        return torch.equal(mine, want) * torch.ones(1)

    res["rs_bitwise"] = run(rs_body, x).numpy()
    x = np.random.RandomState(1).randn(n, 40).astype(np.float32)
    res["ag_rs"] = run(lambda xs: C.all_gather(
        C.reduce_scatter(xs[0], par.DP), par.DP)[None], x).numpy()
    res["psum"] = run(lambda xs: C.psum(xs[0], par.DP)[None], x).numpy()
    x = np.arange(n * 24, dtype=np.float32).reshape(n, 24)
    res["rs_vals"] = run(lambda xs: C.reduce_scatter(xs[0], par.DP)[None],
                         x).numpy()

    def order(xs):
        r = C.axis_index(par.DP)
        return C.all_gather(torch.full((3,), r, dtype=torch.int32),
                            par.DP)[None]

    res["ag_order"] = run(order, np.zeros((n, 1), np.float32)).numpy()
    x = np.random.RandomState(2).randn(n, 5, 3).astype(np.float32)
    res["mean"] = par.allreduce_mean(_t(x), mesh).numpy()
    # each verb's value and its transpose: grads of sum(out * w)
    x, w = collective_grad_inputs(n)
    for name, body in collective_bodies(C, par.DP, n).items():
        xt = _t(x, grad=True)
        out = C.shard_map(body, mesh=mesh, in_specs=(spec,),
                          out_specs=spec)(xt)
        (g,) = torch.autograd.grad((out * _t(w)).sum(), [xt])
        res[f"verb_{name}"] = out.detach().numpy()
        res[f"grad_{name}"] = g.numpy()
    return res


def collective_grad_inputs(n):
    rs = np.random.RandomState(5)
    return (rs.randn(n, 8, 4).astype(np.float32),
            rs.randn(n, 8, 4).astype(np.float32))


def collective_bodies(C_, axis, n):
    """Per-rank bodies over [1, 8, 4] blocks, written against either
    package's collectives module (the same names)."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    return {
        "psum": lambda xs: C_.psum(xs * xs, axis),
        "all_gather": lambda xs: C_.all_gather(xs[0] * 2.0, axis, axis=0,
                                               tiled=True)[None, :8],
        "reduce_scatter": lambda xs: C_.all_gather(
            C_.reduce_scatter(xs[0] * xs[0], axis), axis)[None],
        "ppermute": lambda xs: C_.ppermute(xs * 3.0, axis, perm),
        "all_to_all": lambda xs: C_.all_to_all(xs * xs, axis, 1, 2)
        .reshape(1, 8, 4),
    }


def suite_parallel(rank, n):
    from mxnet_tpu_torch.gluon import loss as gloss
    res = {}
    with CPU:
        # dp x tp training, loss falls
        net = gluon_mlp(mt, mlp_weights(20, 0), ctx=CPU)
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.2,
                                                   momentum=0.9),
                             gloss.SoftmaxCrossEntropyLoss(),
                             mesh=par.auto_mesh(n, tp=2))
        x, y = trainer_data(10, 32, 20)
        res["tp_losses"] = np.array([float(tr.step(x, y))
                                     for _ in range(40)])
        # dp = n against one device on the whole batch
        w0 = mlp_weights(12, 1)
        net = gluon_mlp(mt, w0, prefix="sgd_", ctx=CPU)
        x, y = trainer_data(11, 16, 12)
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.05),
                             gloss.SoftmaxCrossEntropyLoss(),
                             mesh=par.auto_mesh(n))
        res["sgd_loss"] = np.array(float(tr.step(x, y)))
        tr.sync_to_block()
        for k, v in net.collect_params().items():
            res[f"sgd_{k}"] = v.data().asnumpy()
        # step_many against K single steps
        w0 = mlp_weights(12, 3)
        xk, yk = trainer_data(13, 8, 12, k=4)
        trs = []
        for prefix in ("many_", "single_"):
            net = gluon_mlp(mt, w0, prefix=prefix, ctx=CPU)
            trs.append(par.SPMDTrainer(
                net, mt.optimizer.SGD(learning_rate=0.05, momentum=0.9),
                gloss.SoftmaxCrossEntropyLoss(), mesh=par.auto_mesh(n)))
        res["many_losses"] = trs[0].step_many(xk, yk).numpy()
        res["many_num_update"] = np.array(trs[0].optimizer.num_update)
        res["single_losses"] = np.array([float(trs[1].step(xk[i], yk[i]))
                                         for i in range(4)])
        for tag, t in zip(("many", "single"), trs):
            t.sync_to_block()
            for k, v in t.block.collect_params().items():
                res[f"{tag}_w_{k[len(tag) + 1:]}"] = v.data().asnumpy()
        xd, yd = trs[0].place_inputs(xk, yk, microbatched=True)
        res["placed_losses"] = trs[0].step_many(xd, yd).numpy()
        res["many_flops"] = np.array(trs[0].compiled_cost_analysis()
                                     ["flops"])
        res["single_flops"] = np.array(trs[1].compiled_cost_analysis()
                                       ["flops"])
        # Adam over dp x tp
        net = gluon_mlp(mt, mlp_weights(6, 4), prefix="adam_", ctx=CPU)
        tr = par.SPMDTrainer(net, mt.optimizer.Adam(learning_rate=0.01),
                             gloss.SoftmaxCrossEntropyLoss(),
                             mesh=par.auto_mesh(n, tp=2))
        x, y = trainer_data(14, 8, 6)
        res["adam_losses"] = np.array([float(tr.step(x, y))
                                       for _ in range(2)])
        # ring (both block kinds) and Ulysses attention over sp = n
        mesh = par.make_mesh({par.SP: n})
        q, k, v, w = attention_inputs(2, (2, 4, 64, 16))
        for causal in (False, True):
            for flash in ("1", "0"):
                os.environ["MXTPU_RING_FLASH"] = flash
                qt, kt, vt = (_t(a, grad=True) for a in (q, k, v))
                out = par.ring_attention(qt, kt, vt, mesh, causal=causal)
                grads = torch.autograd.grad((out * _t(w)).sum(),
                                            [qt, kt, vt])
                tag = f"ring_{int(causal)}_{flash}"
                res[tag] = out.detach().numpy()
                for name, g in zip("qkv", grads):
                    res[f"{tag}_d{name}"] = g.numpy()
        os.environ.pop("MXTPU_RING_FLASH", None)
        q, k, v, _w = attention_inputs(3, (2, 8, 64, 8))
        res["ulysses"] = par.ulysses_attention(_t(q), _t(k), _t(v), mesh,
                                               causal=True).numpy()
        # the ring LM over sp = n: loss, logits and parameter gradients
        from mxnet_tpu_torch.model_zoo import ring_lm_loss
        from mxnet_tpu_torch.serialization import tree_from_numpy
        p_np, tok, tgt = ring_lm_inputs()
        params = tree_from_numpy(p_np, CPU, requires_grad=True)
        loss, logits = ring_lm_loss(params, torch.tensor(tok),
                                    torch.tensor(tgt), mesh, RING_LM["heads"])
        grads = torch.autograd.grad(loss, list(params.values()))
        res["ring_lm_loss"] = loss.detach().numpy()
        res["ring_lm_logits"] = logits.detach().numpy()
        for name, g in zip(params, grads):
            res[f"ring_lm_d{name}"] = g.numpy()
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        res["allreduce_mean"] = par.allreduce_mean(
            _t(x), par.make_mesh({par.DP: n})).numpy()
    return res


def suite_pipeline_moe(rank, n):
    res = {}

    def fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    with CPU:
        for s, k in ((2, 4), (4, 8)):
            stages = stage_weights(0, s, 6)
            x = np.random.RandomState(1).randn(k, 3, 6).astype(np.float32)
            out = par.pipeline_apply(
                fn, par.stack_stage_params([{a: _t(b) for a, b in
                                             st.items()} for st in stages]),
                _t(x), par.auto_mesh(n, pp=s))
            res[f"pipe_{s}_{k}"] = out.numpy()
        stages = stage_weights(1, 2, 5)
        x = np.random.RandomState(2).randn(6, 2, 5).astype(np.float32)
        stacked = {a: b.requires_grad_(True) for a, b in
                   par.stack_stage_params(
                       [{a: _t(b) for a, b in st.items()}
                        for st in stages]).items()}
        out = par.pipeline_apply(fn, stacked, _t(x),
                                 par.auto_mesh(n, pp=2))
        gw, gb = torch.autograd.grad((out * out).mean(),
                                     [stacked["w"], stacked["b"]])
        res["pipe_dw"], res["pipe_db"] = gw.numpy(), gb.numpy()
        stages = stage_weights(4, 2, 5)
        x = np.random.RandomState(5).randn(4, 4, 5).astype(np.float32)
        res["pipe_dp"] = par.pipeline_apply(
            fn, par.stack_stage_params([{a: _t(b) for a, b in st.items()}
                                        for st in stages]), _t(x),
            par.auto_mesh(n, pp=2), io_spec=P(None, par.DP)).numpy()
        router, w_in, w_out = moe_weights(0, 8, 16, 4)
        params = par.MoEParams(_t(router, True), _t(w_in, True),
                               _t(w_out, True))
        x = np.random.RandomState(2).randn(32, 8).astype(np.float32)
        y, aux = par.moe_ffn(params, _t(x), capacity_factor=1.25,
                             mesh=par.auto_mesh(n, ep=4))
        grads = torch.autograd.grad((y * y).sum(), list(params))
        res["moe_y"] = y.detach().numpy()
        res["moe_dropped"] = np.array(float(aux["dropped_frac"]))
        res["moe_aux"] = np.array(float(aux["aux_loss"]))
        for name, g in zip(("router", "w_in", "w_out"), grads):
            res[f"moe_d{name}"] = g.numpy()
    return res


def _run_module(spmd, steps, zero1="1", opt="sgd", batch=16, seed=0,
                **kw):
    os.environ["MXTPU_SPMD"] = spmd
    os.environ["MXTPU_SPMD_ZERO1"] = zero1
    mod = make_module(mt, opt=opt, seed=seed, batch=batch, ctx=CPU, **kw)
    for x, y in module_batches(steps, batch=batch):
        assert mod.fused_step(data_batch(mt, x, y, CPU))
    return mod


def _put(res, tag, snapshot):
    params, states = snapshot
    for k, v in params.items():
        res[f"{tag}/p/{k}"] = v
    for k, v in states.items():
        res[f"{tag}/s/{k}"] = v


def _interchange(n_first, n_second, via_ckpt, workdir, batch=16):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    batches = module_batches(5, batch=batch)
    os.environ["MXTPU_SPMD"] = n_first
    mod = make_module(mt, opt="adam", batch=batch, ctx=CPU)
    for x, y in batches[:3]:
        assert mod.fused_step(data_batch(mt, x, y, CPU))
    extra = None
    if via_ckpt:
        mgr = CheckpointManager(os.path.join(
            workdir, f"ck_{n_first}_{n_second}_{batch}"))
        extra = mgr.save_module(mod, step=3).manifest["extra"]
        os.environ["MXTPU_SPMD"] = n_second
        mod = make_module(mt, opt="adam", seed=99, batch=batch, ctx=CPU)
        assert mgr.restore(module=mod) is not None
    else:
        os.environ["MXTPU_SPMD"] = n_second
    for x, y in batches[3:]:
        assert mod.fused_step(data_batch(mt, x, y, CPU))
    return snap(mod), extra


def suite_spmd_step(rank, n, workdir):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel.spmd_step import resolve_mesh
    res = {}
    workdir = os.path.join(workdir, f"rank{rank}")
    os.makedirs(workdir, exist_ok=True)
    N = str(n)
    for opt, kw in (("sgd", {"momentum": 0.9, "wd": 1e-4}), ("adam", {})):
        for z in ("1", "0"):
            _put(res, f"{opt}_{z}",
                 snap(_run_module(N, 3, zero1=z, opt=opt, **kw)))
    profiler.reset_spmd_counters()
    _run_module(N, 2, opt="adam")
    for k, v in profiler.spmd_counters().items():
        res[f"z1_counters/{k}"] = np.array(v)
    profiler.reset_spmd_counters()
    _run_module(N, 1, zero1="0", opt="adam")
    for k, v in profiler.spmd_counters().items():
        res[f"ar_counters/{k}"] = np.array(v)
    profiler.reset_spmd_counters()
    _run_module(N, 1)
    res["snapshot_steps"] = np.array(
        profiler.metrics_snapshot()["spmd"]["spmd_steps"])
    res["text_has_steps"] = np.array("spmd_steps" in profiler.metrics_text())
    _put(res, f"n{n}_mom", snap(_run_module(N, 3, momentum=0.9)))
    _put(res, "n1_mom", snap(_run_module("1", 3, momentum=0.9)))
    for a, b, batch in ((N, "1", 16), ("1", N, 16), (N, str(n - 1), 24),
                        (str(n - 1), str(n - 2), 24)):
        via, extra = _interchange(a, b, True, workdir, batch)
        direct, _ = _interchange(a, b, False, workdir, batch)
        _put(res, f"via_{a}_{b}", via)
        _put(res, f"direct_{a}_{b}", direct)
        spmd = extra.get("spmd")   # None on a rank outside the mesh
        res[f"extra_{a}_{b}"] = np.array(
            [spmd["replicas"], int(spmd["zero1"])] if spmd else [-1, -1])
    # a sharded save resumed on the dense step
    batches = module_batches(5)
    os.environ["MXTPU_SPMD"] = N
    mod = make_module(mt, opt="adam", ctx=CPU)
    for x, y in batches[:3]:
        assert mod.fused_step(data_batch(mt, x, y, CPU))
    mgr = CheckpointManager(os.path.join(workdir, "fused"))
    mgr.save_module(mod, step=3)
    os.environ["MXTPU_SPMD"] = ""
    resumed = make_module(mt, opt="adam", seed=99, ctx=CPU)
    mgr.restore(module=resumed)
    res["resumed_num_update"] = np.array(
        resumed._updater.optimizer.num_update)
    for x, y in batches[3:]:
        assert resumed.fused_step(data_batch(mt, x, y, CPU))
    os.environ["MXTPU_SPMD"] = N
    cont = make_module(mt, opt="adam", seed=98, ctx=CPU)
    mgr.restore(module=cont)
    os.environ["MXTPU_SPMD"] = ""
    for x, y in batches[3:]:
        assert cont.fused_step(data_batch(mt, x, y, CPU))
    _put(res, "fused_resumed", snap(resumed))
    _put(res, "fused_cont", snap(cont))
    # a torn save is skipped
    batches = module_batches(4)
    os.environ["MXTPU_SPMD"] = N
    mod = make_module(mt, opt="adam", ctx=CPU)
    mgr = CheckpointManager(os.path.join(workdir, "torn"))
    assert mod.fused_step(data_batch(mt, *batches[0], CPU))
    mgr.save_module(mod, step=1)
    assert mod.fused_step(data_batch(mt, *batches[1], CPU))
    ck2 = mgr.save_module(mod, step=2)
    os.remove(os.path.join(ck2.directory, "MANIFEST.json"))
    res["torn_latest"] = np.array(mgr.latest_valid().step)
    os.environ["MXTPU_SPMD"] = "1"
    resumed = make_module(mt, opt="adam", seed=99, ctx=CPU)
    res["torn_restored"] = np.array(mgr.restore(module=resumed)["step"])
    reference = make_module(mt, opt="adam", ctx=CPU)
    os.environ["MXTPU_SPMD"] = N
    assert reference.fused_step(data_batch(mt, *batches[0], CPU))
    os.environ["MXTPU_SPMD"] = "1"
    for m in (resumed, reference):
        assert m.fused_step(data_batch(mt, *batches[1], CPU))
    _put(res, "torn_resumed", snap(resumed))
    _put(res, "torn_reference", snap(reference))
    # a ragged tail batch takes the dense step, then the plane resumes
    profiler.reset_spmd_counters()
    os.environ["MXTPU_SPMD"] = N
    mod = make_module(mt, opt="adam", ctx=CPU)
    full = module_batches(2)
    ragged = module_batches(1, seed=7, batch=13)[0]
    assert mod.fused_step(data_batch(mt, *full[0], CPU))
    mod.reshape(data_shapes=[("data", (13, 16))],
                label_shapes=[("softmax_label", (13,))])
    assert mod.fused_step(data_batch(mt, *ragged, CPU))
    mod.reshape(data_shapes=[("data", (16, 16))],
                label_shapes=[("softmax_label", (16,))])
    assert mod.fused_step(data_batch(mt, *full[1], CPU))
    c = profiler.spmd_counters()
    res["ragged_counts"] = np.array([c["spmd_steps"],
                                     c["resharding_events"]])
    _put(res, "ragged", snap(mod))
    # predict after sharded steps, then the plane steps on
    mod = make_module(mt, opt="adam", ctx=CPU)
    for x, y in module_batches(2):
        assert mod.fused_step(data_batch(mt, x, y, CPU))
    x, y = module_batches(1, seed=11)[0]
    mod.forward(data_batch(mt, x, y, CPU), is_train=False)
    res["predict_out"] = mod.get_outputs()[0].asnumpy()
    before = profiler.spmd_counters()["spmd_steps"]
    assert mod.fused_step(data_batch(mt, *module_batches(1, seed=12)[0],
                                     CPU))
    res["predict_steps"] = np.array([before,
                                     profiler.spmd_counters()["spmd_steps"]])
    # MXTPU_SPMD parsing against the group
    sizes = []
    with CPU:
        for v in ("auto", "1", N, str(n - 1), "999"):
            os.environ["MXTPU_SPMD"] = v
            sizes.append(resolve_mesh().size)
    res["mesh_sizes"] = np.array(sizes)
    return res


def sync_bn_inputs():
    rs = np.random.RandomState(61)
    return (rs.randn(8, 3, 4, 4).astype(np.float32) *
            np.array([1.0, 2.0, 0.5], np.float32)[None, :, None, None],
            rs.uniform(0.5, 1.5, 3).astype(np.float32),
            rs.randn(3).astype(np.float32),
            rs.randn(3).astype(np.float32),
            rs.uniform(0.5, 2, 3).astype(np.float32))


def suite_sync_bn(rank, n):
    """``SyncBatchNorm`` in training inside `shard_map` over dp: each
    rank's output rows and the moving statistics it writes."""
    from mxnet_tpu_torch.ops.registry import Attrs, canonical_attrs, get_op
    fn = get_op("_contrib_SyncBatchNorm").fn
    attrs = Attrs(canonical_attrs(dict(axis_name="dp", fix_gamma=False,
                                       __train=True)))
    mesh = par.make_mesh({par.DP: n})
    x, gamma, beta, mm, mv = (_t(a) for a in sync_bn_inputs())
    rows = x.shape[0] // n
    out = {}

    def body(xb, g, b, m, v):
        o, nm, nv = fn(attrs, xb, g, b, m, v)
        out["moving_mean"], out["moving_var"] = nm, nv
        return o

    full = C.shard_map(body, mesh=mesh,
                       in_specs=(P(par.DP), P(), P(), P(), P()),
                       out_specs=P(par.DP))(x, gamma, beta, mm, mv)
    return {"out": full[rank * rows:(rank + 1) * rows].numpy(),
            "moving_mean": out["moving_mean"].numpy(),
            "moving_var": out["moving_var"].numpy()}


def main():
    suite, outdir = sys.argv[1], sys.argv[2]
    dist.initialize()
    rank, n = dist.rank(), dist.size()
    torch.manual_seed(0)
    with CPU:
        if suite == "spmd_step":
            res = suite_spmd_step(rank, n, outdir)
        else:
            res = globals()[f"suite_{suite}"](rank, n)
    np.savez(os.path.join(outdir, f"{suite}-{rank}.npz"), **res)
    dist.barrier()
    print(f"RANK {rank}/{n} {suite} DONE", flush=True)


if __name__ == "__main__":
    main()
