"""The port's optimizer ops and optimizer classes against the JAX
package's (`mxnet_tpu/ops/optimizer_ops.py`, `mxnet_tpu/optimizer/`).

Every registered update op runs 6 steps through both packages' `invoke`
on the same numpy weights, gradients and states, with weight decay,
gradient clipping and rescaling set (``multi_*`` ops over two weights
with their own lr and wd, the ``mp_`` ops on float16 weights with float32
masters, FTML with its step count); every optimizer class takes 6 steps
through both packages' `Updater` over a weight and a bias named as a
symbol's (so the bias takes no weight decay), with lr and wd multipliers
and ``multi_precision`` on float16 weights for SGD, NAG and Adam.  The
float32 results must agree within ``TOL`` = 1e-5 of the reference's
largest magnitude (float16 weights within one float16 rounding, 1e-3).
Each optimizer's states cross-load between the packages
(`Updater.get_states`/`set_states`) and the next step agrees again.
SGLD draws its noise from each package's generator, so it is held by
the noise's mean and variance.  Completeness tests hold that the port
registers every optimizer, optimizer op and initializer name the JAX
package does; `tests/test_optimizer_reference_cases.py`'s closed-form
grids run here on the port.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ndarray.register import invoke as jinvoke
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ndarray.register import invoke as tinvoke
from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-5
HALF_TOL = 1e-3
STEPS = 6
SHAPE = (5, 4)
COMMON = dict(lr=0.05, wd=0.01, rescale_grad=0.7, clip_gradient=1.5)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} against {scale}"


def _nds(pkg, arrays):
    if pkg is mx:
        return [mx.nd.array(a, dtype=a.dtype) for a in arrays]
    return [mt.nd.array(a, ctx=mt.cpu(), dtype=a.dtype) for a in arrays]


# op name -> (states as functions of the weight, attrs, weight dtype)
def _zeros(w):
    return np.zeros_like(w, np.float32)


def _master(w):
    return w.astype(np.float32)


OPS = {
    "sgd_update": ([], {}, np.float32),
    "sgd_mom_update": ([_zeros], dict(momentum=0.9), np.float32),
    "mp_sgd_update": ([_master], {}, np.float16),
    "mp_sgd_mom_update": ([_zeros, _master], dict(momentum=0.9),
                          np.float16),
    "adam_update": ([_zeros, _zeros], dict(beta1=0.8, beta2=0.99,
                                           epsilon=1e-6), np.float32),
    "nag_mom_update": ([_zeros], dict(momentum=0.9), np.float32),
    "rmsprop_update": ([_zeros], dict(gamma1=0.9, epsilon=1e-6),
                       np.float32),
    "rmspropalex_update": ([_zeros, _zeros, _zeros],
                           dict(gamma1=0.9, gamma2=0.8, epsilon=1e-6),
                           np.float32),
    "ftrl_update": ([_zeros, _zeros], dict(lamda1=0.01, beta=1.0),
                    np.float32),
    "signsgd_update": ([], {}, np.float32),
    "signum_update": ([_zeros], dict(momentum=0.9, wd_lh=0.01),
                      np.float32),
    "adagrad_update": ([_zeros], dict(epsilon=1e-7), np.float32),
    "_sparse_adagrad_update": ([_zeros], dict(epsilon=1e-7), np.float32),
    "ftml_update": ([_zeros, _zeros, _zeros],
                    dict(beta1=0.6, beta2=0.999, epsilon=1e-8), np.float32),
    "_contrib_group_adagrad_update": (
        [lambda w: np.zeros((w.shape[0], 1), np.float32)],
        dict(epsilon=1e-5), np.float32),
    "group_adagrad_update": (
        [lambda w: np.zeros((w.shape[0], 1), np.float32)],
        dict(epsilon=1e-5), np.float32),
}
ADAMW = ("_adamw_update", "_contrib_adamw_update", "_mp_adamw_update",
         "_contrib_mp_adamw_update")
MULTI = {"multi_sgd_update": (0, False), "multi_sgd_mom_update": (1, False),
         "multi_mp_sgd_update": (0, True),
         "multi_mp_sgd_mom_update": (1, True)}


def _run_op(pkg, invoke, name, w, states, grads, attrs, extra=()):
    nds = _nds(pkg, [w] + states)
    weight, st = nds[0], nds[1:]
    for k, g in enumerate(grads):
        kw = dict(attrs, t=k + 1) if name == "ftml_update" else attrs
        invoke(name, weight, _nds(pkg, [g])[0], *st,
               *_nds(pkg, list(extra)), out=weight, **kw)
    return [weight.asnumpy()] + [s.asnumpy() for s in st]


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_reference(name):
    makers, attrs, dtype = OPS[name]
    rs = np.random.RandomState(1)
    w = rs.randn(*SHAPE).astype(dtype)
    states = [m(w) for m in makers]
    grads = [(rs.randn(*SHAPE) * 2).astype(dtype) for _ in range(STEPS)]
    attrs = dict(COMMON, **attrs)
    if "group_adagrad" in name:
        attrs.pop("wd")
    want = _run_op(mx, jinvoke, name, w, states, grads, attrs)
    got = _run_op(mt, tinvoke, name, w, states, grads, attrs)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, HALF_TOL if a.dtype == np.float16 else TOL,
               f"{name} output {k}")


@pytest.mark.parametrize("name", ADAMW)
@pytest.mark.parametrize("scale", [0.5, np.inf])
def test_adamw_matches_reference(name, scale):
    """A finite scale updates; a non-finite one leaves everything as it
    was."""
    rs = np.random.RandomState(2)
    mp = "mp" in name
    w = rs.randn(*SHAPE).astype(np.float16 if mp else np.float32)
    states = [_zeros(w), _zeros(w)] + ([_master(w)] if mp else [])
    grads = [rs.randn(*SHAPE).astype(np.float32) for _ in range(STEPS)]
    attrs = dict(lr=0.01, eta=0.9, wd=0.01, clip_gradient=1.0)
    extra = [np.array([scale], np.float32)]
    want = _run_op(mx, jinvoke, name, w, states, grads, attrs, extra)
    got = _run_op(mt, tinvoke, name, w, states, grads, attrs, extra)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, HALF_TOL if a.dtype == np.float16 else TOL,
               f"{name} output {k}")


@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_update_op_matches_reference(name):
    """Two weights interleaved with their gradients and states, each with
    its own lr and wd; the updated masters and momenta too."""
    n_mom, mp = MULTI[name]
    rs = np.random.RandomState(3)
    dtype = np.float16 if mp else np.float32
    ws = [rs.randn(*SHAPE).astype(dtype), rs.randn(3).astype(dtype)]
    attrs = dict(num_weights=2, lrs=(0.05, 0.02), wds=(0.01, 0.0),
                 rescale_grad=0.7, clip_gradient=1.5)
    if n_mom:
        attrs["momentum"] = 0.9
    grads = [[(rs.randn(*w.shape) * 2).astype(dtype) for w in ws]
             for _ in range(STEPS)]
    results = []
    for pkg, invoke in ((mx, jinvoke), (mt, tinvoke)):
        groups = []
        for w in ws:
            st = [_zeros(w)] * n_mom + ([_master(w)] if mp else [])
            groups.append(_nds(pkg, [w] + st))
        for step in grads:
            flat = []
            for grp, g in zip(groups, step):
                flat += [grp[0]] + _nds(pkg, [g]) + grp[1:]
            invoke(name, *flat, out=[grp[0] for grp in groups], **attrs)
        results.append([a.asnumpy() for grp in groups for a in grp])
    for k, (a, b) in enumerate(zip(results[1], results[0])):
        _close(a, b, HALF_TOL if a.dtype == np.float16 else TOL,
               f"{name} array {k}")


def test_multi_sum_sq_matches_reference():
    rs = np.random.RandomState(4)
    arrays = [rs.randn(*s).astype(np.float32) for s in ((3, 4), (7,), (2,))]
    got = tinvoke("multi_sum_sq", *_nds(mt, arrays)).asnumpy()
    want = jinvoke("multi_sum_sq", *_nds(mx, arrays)).asnumpy()
    assert got.dtype == np.float32
    _close(got, want)


def test_multi_ops_equal_their_single_forms():
    """`multi_sgd_mom_update` and `multi_mp_sgd_mom_update` give the
    per-weight ops' results (the card's phase 13a check, on the CPU)."""
    rs = np.random.RandomState(5)
    for mp in (False, True):
        dtype = np.float16 if mp else np.float32
        ws = [rs.randn(*s).astype(dtype) for s in ((4, 3), (5,), (2, 2))]
        gs = [rs.randn(*w.shape).astype(dtype) for w in ws]
        lrs, wds = (0.1, 0.05, 0.2), (0.01, 0.0, 0.02)
        multi = [_nds(mt, [w, _zeros(w)] + ([_master(w)] if mp else []))
                 for w in ws]
        flat = []
        for grp, g in zip(multi, gs):
            flat += [grp[0]] + _nds(mt, [g]) + grp[1:]
        tinvoke("multi_mp_sgd_mom_update" if mp else
                "multi_sgd_mom_update", *flat, out=[m[0] for m in multi],
                num_weights=3, lrs=lrs, wds=wds, momentum=0.9,
                rescale_grad=0.5, clip_gradient=1.0)
        for k, (w, g) in enumerate(zip(ws, gs)):
            one = _nds(mt, [w, _zeros(w)] + ([_master(w)] if mp else []))
            tinvoke("mp_sgd_mom_update" if mp else "sgd_mom_update",
                    one[0], *_nds(mt, [g]), *one[1:], out=one[0],
                    lr=lrs[k], wd=wds[k], momentum=0.9, rescale_grad=0.5,
                    clip_gradient=1.0)
            for a, b in zip(multi[k], one):
                np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


# optimizer name -> constructor kwargs (beyond the common ones)
CLASSES = {
    "sgd": dict(momentum=0.9), "ccsgd": dict(momentum=0.9),
    "signum": dict(momentum=0.9, wd_lh=0.01), "signum0": dict(momentum=0.0),
    "nag": dict(momentum=0.9), "nag0": dict(momentum=0.0),
    "adam": {}, "adagrad": dict(eps=1e-6),
    "rmsprop": dict(gamma1=0.9), "rmsprop_centered": dict(centered=True),
    "adadelta": dict(rho=0.9, epsilon=1e-5), "ftrl": dict(lamda1=0.01),
    "adamax": {}, "nadam": {}, "ftml": {},
    "dcasgd": dict(momentum=0.9, lamda=0.04), "dcasgd0": {},
    "lbsgd": dict(momentum=0.9), "lbsgd_lars": dict(
        momentum=0.9, warmup_strategy="lars"),
    "test": {}, "groupadagrad": {},
    "sgd_mp": dict(momentum=0.9, multi_precision=True),
    "nag_mp": dict(momentum=0.9, multi_precision=True),
    "adam_mp": dict(multi_precision=True),
}


def _make(pkg, key):
    name = key.split("_")[0].rstrip("0")
    kw = dict(learning_rate=0.05, rescale_grad=0.7, clip_gradient=1.5,
              wd=0.01, param_idx2name={0: "fc_weight", 1: "fc_bias"})
    kw.update({k: v for k, v in CLASSES[key].items()})
    if key == "rmsprop_centered":
        kw["centered"] = True
    if name == "groupadagrad":
        kw.pop("wd")
    opt = pkg.optimizer.create(name, **kw)
    opt.set_lr_mult({0: 1.5})
    opt.set_wd_mult({0: 2.0})
    return opt


def _weights(pkg, dtype, seed=6):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(*SHAPE).astype(dtype), rs.randn(4).astype(dtype)]
    return _nds(pkg, arrays)


def _steps(pkg, upd, ws, grads):
    for gs in grads:
        for i, (w, g) in enumerate(zip(ws, gs)):
            upd(i, _nds(pkg, [g])[0], w)


def _grads(dtype, n=STEPS, seed=7):
    rs = np.random.RandomState(seed)
    return [[(rs.randn(*SHAPE) * 2).astype(dtype),
             (rs.randn(4) * 2).astype(dtype)] for _ in range(n)]


def _held(got, want, dtype):
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a.asnumpy(), b.asnumpy(),
               HALF_TOL if dtype == np.float16 else TOL, f"weight {k}")


@pytest.mark.parametrize("key", sorted(CLASSES))
def test_optimizer_matches_reference_and_states_cross_load(key):
    dtype = np.float16 if key.endswith("_mp") else np.float32
    grads = _grads(dtype, STEPS + 2)
    runs = {}
    for pkg in (mx, mt):
        upd = pkg.optimizer.get_updater(_make(pkg, key))
        ws = _weights(pkg, dtype)
        _steps(pkg, upd, ws, grads[:STEPS])
        runs[pkg] = (upd, ws)
    _held(runs[mt][1], runs[mx][1], dtype)
    # states of each package loaded into the other, then one more step
    blobs = {pkg: upd.get_states(dump_optimizer=True)
             for pkg, (upd, _) in runs.items()}
    for pkg, other in ((mx, mt), (mt, mx)):
        upd = pkg.optimizer.get_updater(_make(pkg, key))
        upd.set_states(blobs[other])
        ws = _nds(pkg, [w.asnumpy() for w in runs[other][1]])
        _steps(pkg, upd, ws, grads[STEPS:STEPS + 1])
        runs[pkg] = runs[pkg] + (ws,)
    for pkg in (mx, mt):
        _steps(pkg, runs[pkg][0], runs[pkg][1], grads[STEPS:STEPS + 1])
    _held(runs[mt][2], runs[mx][1], dtype)
    _held(runs[mx][2], runs[mx][1], dtype)


def test_sgld_noise_statistics():
    """SGLD's step minus its deterministic half step is N(0, lr) noise."""
    lr, n = 0.04, 200000
    opt = mt.optimizer.create("sgld", learning_rate=lr)
    upd = mt.optimizer.get_updater(opt)
    w = mt.nd.zeros((n,), ctx=mt.cpu())
    g = mt.nd.array(np.full(n, 2.0, np.float32), ctx=mt.cpu())
    mt.random.seed(11)
    upd(0, g, w)
    noise = w.asnumpy() + lr / 2 * 2.0
    se = np.sqrt(lr / n)
    assert abs(noise.mean()) < 5 * se
    assert abs(noise.var() / lr - 1) < 5 * np.sqrt(2.0 / n)


def test_every_optimizer_op_and_initializer_is_registered():
    from mxnet_tpu import initializer as jinit
    from mxnet_tpu.optimizer import optimizer as jopt
    from mxnet_tpu_torch import initializer as tinit
    from mxnet_tpu_torch.optimizer import optimizer as topt
    assert set(jopt._OPT_REGISTRY) <= set(topt._OPT_REGISTRY)
    ops = {n for n in jreg.list_ops()
           if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.optimizer_ops"}
    assert len(ops) == 25
    assert ops <= set(treg.list_ops())
    assert set(jinit._INIT_REGISTRY) <= set(tinit._INIT_REGISTRY)
    assert hasattr(mt.init, "Mixed") and hasattr(mt.optimizer, "contrib")


@pytest.mark.parametrize("rescale,clip,wd", [
    (1.0, None, 0.0), (0.5, None, 0.0), (1.0, 0.5, 0.0), (2.0, 1.0, 0.01),
    (1.0, None, 0.1)])
@pytest.mark.parametrize("name", ["sgd", "nag", "signum", "rmsprop"])
def test_flag_grid_matches_reference(name, rescale, clip, wd):
    """`tests/test_optimizer_reference_cases.py`'s flag grid on the port
    for each op-backed optimizer, two steps against the JAX package."""
    kw = dict(learning_rate=0.1, rescale_grad=rescale, clip_gradient=clip,
              wd=wd)
    rs = np.random.RandomState(11)
    w = rs.randn(*SHAPE).astype(np.float32)
    g = (rs.randn(*SHAPE) * 3).astype(np.float32)
    out = []
    for pkg in (mx, mt):
        opt = pkg.optimizer.create(name, **kw)
        (wn,) = _nds(pkg, [w])
        state = opt.create_state(0, wn)
        for _ in range(2):
            opt.update(0, wn, _nds(pkg, [g])[0], state)
        out.append(wn.asnumpy())
    _close(out[1], out[0])
