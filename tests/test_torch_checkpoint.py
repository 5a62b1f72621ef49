"""The PyTorch port's crash-consistent checkpoints against the JAX
package (`mxnet_tpu/checkpoint.py`, `mxnet_tpu/serialization.py`; cases
adapted from `tests/test_checkpoint.py`): the footer and atomic writes
with `fault_injection.FilePlan`'s injected faults, the
manager's commit, retention and `latest_valid` past torn, uncommitted and
corrupt steps, `fit`'s ``MXTPU_CKPT_DIR`` resume bit-equal to an
uninterrupted run, `module_checkpoint` with a manager, a Gluon Trainer's
restore, and checkpoints of either package restoring params and
optimizer states in the other (equal bits; one step on from them within
1e-6 of each other)."""
import json
import os
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch import serialization as S
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import MANIFEST_NAME, CheckpointManager

CPU = mt.cpu()


def _arr(x):
    return mt.nd.array(np.asarray(x, np.float32), ctx=CPU)


def _save_step(mgr, step, val):
    return mgr.save(step, params={"arg:w": _arr(np.full((3,), val))},
                    optimizer_states=b"states-%d" % step, epoch=step,
                    batch=7, extra={"val": val})


# -- the durable file layer ------------------------------------------------

def test_atomic_write_footer_matches_reference(tmp_path):
    payload = os.urandom(100)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert S.atomic_write(a, payload) == a
    mx.serialization.atomic_write(b, payload)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert S.read_payload(a) == payload
    assert S.crc32_file(a) == mx.serialization.crc32_file(b) == \
        zlib.crc32(open(a, "rb").read()) & 0xFFFFFFFF
    S.atomic_write(a, payload, checksum=False)
    assert open(a, "rb").read() == payload
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_atomic_write_keeps_the_old_file_on_a_failed_replace(tmp_path,
                                                             monkeypatch):
    f = str(tmp_path / "x.params")
    S.atomic_write(f, b"old")

    def boom(src, dst):
        raise OSError("disk gone")
    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        S.atomic_write(f, b"new")
    monkeypatch.undo()
    assert S.read_payload(f) == b"old"
    assert os.listdir(tmp_path) == ["x.params"]


def _listing(directory):
    """File names with a temporary file's random suffix cut off, and the
    bytes of every file that is not temporary."""
    names = sorted(n.split(".tmp.")[0] + ".tmp." if ".tmp." in n else n
                   for n in os.listdir(directory))
    data = {n: open(os.path.join(directory, n), "rb").read()
            for n in os.listdir(directory) if ".tmp." not in n}
    return names, data


def test_injected_crash_leaves_the_tmp_file_as_the_reference(tmp_path):
    """``FilePlan(kill_before_rename=2)`` in both packages: the second
    write dies between its temporary file and the rename, and each
    package's directory holds the same files -- the old file whole and the
    temporary file left behind, as after a real SIGKILL -- with equal
    bytes and equal plan summaries."""
    from mxnet_tpu import fault_injection as jfi
    from mxnet_tpu_torch import fault_injection as tfi
    out = {}
    for name, ser, fi in (("port", S, tfi), ("ref", mx.serialization, jfi)):
        d = tmp_path / name
        d.mkdir()
        f = str(d / "a.params")
        plan = fi.install_file(fi.FilePlan(kill_before_rename=2))
        try:
            ser.atomic_write(f, b"old payload")
            with pytest.raises(fi.InjectedCrash):
                ser.atomic_write(f, b"new payload")
        finally:
            fi.clear_file()
        out[name] = (_listing(d), plan.summary())
    assert out["port"] == out["ref"]
    (names, data), summary = out["port"]
    assert names == ["a.params", "a.params.tmp."]
    assert S.read_payload(str(tmp_path / "port" / "a.params")) == \
        b"old payload"
    assert summary == {"kills": 1, "fsync_fails": 0, "truncates": 0,
                       "flips": 0, "writes": 2}


@pytest.mark.parametrize("spec", ["fail_fsync=1", "truncate_on_write=1,"
                                  "truncate_at=7", "flip_on_write=1,"
                                  "flip_at=3,seed=5"])
def test_ckpt_fault_plan_env_as_the_reference(tmp_path, monkeypatch, spec):
    """``MXTPU_CKPT_FAULT_PLAN`` drives both packages' writers the same:
    an injected fsync failure keeps the old file (the port also removes
    its temporary file after an ``OSError``), a truncation or a flip
    leaves the same corrupt bytes; both plans' summaries agree."""
    from mxnet_tpu import fault_injection as jfi
    from mxnet_tpu_torch import fault_injection as tfi
    monkeypatch.setenv("MXTPU_CKPT_FAULT_PLAN", spec)
    payload = b"0123456789" * 3
    files, summaries = {}, {}
    for name, ser, fi in (("port", S, tfi), ("ref", mx.serialization, jfi)):
        f = str(tmp_path / f"{name}.params")
        open(f, "wb").write(b"before")
        fi._FILE_ENV_PLANS.clear()
        try:
            ser.atomic_write(f, payload)
        except OSError:
            pass
        files[name] = open(f, "rb").read()
        summaries[name] = fi.file_active().summary()
    assert files["port"] == files["ref"]
    assert summaries["port"] == summaries["ref"]
    assert summaries["port"]["writes"] == 1
    if spec.startswith("fail_fsync"):
        assert files["port"] == b"before"
        assert summaries["port"]["fsync_fails"] == 1
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith("port") and ".tmp." in n]
    else:
        assert files["port"] != payload + S.make_footer(payload)
        assert files["port"][:3] == payload[:3]


def test_corrupt_footer_is_structured(tmp_path):
    f = str(tmp_path / "p.params")
    S.save_ndarrays(f, {"w": _arr(np.arange(6.0))})
    raw = bytearray(open(f, "rb").read())
    raw[30] ^= 0x40
    open(f, "wb").write(bytes(raw))
    with pytest.raises(S.CheckpointCorruptError) as e:
        S.load_ndarrays(f)
    assert e.value.kind == "checksum" and e.value.what == f


# -- the manager ------------------------------------------------------------

def test_manager_roundtrip_manifest_and_generators(tmp_path):
    import torch
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    mt.random.seed(11)
    gen = mt.random.generator("cpu")
    torch.rand(2, generator=gen)                   # advance the stream
    ck = _save_step(mgr, 0, 1.0)
    manifest = json.load(open(os.path.join(ck.directory, MANIFEST_NAME)))
    assert set(manifest) == {"manifest_version", "step", "epoch", "batch",
                             "rng", "files", "extra", "wallclock"}
    assert set(manifest["files"]) == {"params.params", "optimizer.states"}
    got = mgr.load()
    assert (got["step"], got["epoch"], got["batch"]) == (0, 0, 7)
    assert got["extra"] == {"val": 1.0}
    assert got["optimizer_states"] == b"states-0"
    np.testing.assert_array_equal(got["params"]["arg:w"].asnumpy(),
                                  np.full((3,), 1.0))
    expect = torch.rand(4, generator=gen)
    mt.random.seed(999)
    mt.random.set_state(got["rng"])
    assert torch.equal(torch.rand(4, generator=mt.random.generator("cpu")),
                       expect)
    # the JAX package's manager reads the port's checkpoint (not its rng)
    jgot = jck.CheckpointManager(str(tmp_path)).load()
    assert jgot["optimizer_states"] == b"states-0"
    np.testing.assert_array_equal(jgot["params"]["arg:w"].asnumpy(),
                                  np.full((3,), 1.0))
    with pytest.raises(MXNetError, match="threefry"):
        mt.random.set_state(mx.random.get_state())


def test_manager_retention_keeps_newest_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in range(5):
        _save_step(mgr, s, float(s))
    assert sorted(os.listdir(tmp_path)) == ["step-00000003", "step-00000004"]
    assert mgr.latest_valid().step == 4


def test_retention_spares_the_pinned_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=1)
    _save_step(mgr, 0, 1.0)
    assert mgr.latest_valid().step == 0
    _save_step(mgr, 1, 2.0)
    assert os.path.isdir(mgr.step_dir(0))          # pinned
    assert mgr.latest_valid().step == 1
    _save_step(mgr, 2, 3.0)
    assert not os.path.isdir(mgr.step_dir(0))


@pytest.mark.parametrize("damage", ["uncommitted", "truncated_params",
                                    "flipped_states", "torn_manifest",
                                    "missing_member", "lost_footer"])
def test_latest_valid_scans_back_past_damage(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    _save_step(mgr, 0, 1.0)
    if damage == "uncommitted":
        os.makedirs(mgr.step_dir(1))
        open(os.path.join(mgr.step_dir(1), "params.params"),
             "wb").write(b"torn")
    else:
        ck = _save_step(mgr, 1, 2.0)
        p = ck.path("params.params")
        if damage == "truncated_params":
            open(p, "r+b").truncate(os.path.getsize(p) // 2)
        elif damage == "flipped_states":
            s = ck.path("optimizer.states")
            raw = bytearray(open(s, "rb").read())
            raw[len(raw) // 2] ^= 0x10
            open(s, "wb").write(bytes(raw))
        elif damage == "torn_manifest":
            open(os.path.join(ck.directory, MANIFEST_NAME),
                 "wb").write(b"{torn")
        elif damage == "missing_member":
            os.remove(p)
        else:
            # the file is intact by the manifest's CRC but has no footer:
            # rewrite the manifest to match the footless file
            raw = S.read_payload(p)
            open(p, "wb").write(raw)
            m = os.path.join(ck.directory, MANIFEST_NAME)
            man = json.load(open(m))
            man["files"]["params.params"].update(
                bytes=len(raw), crc32=zlib.crc32(raw) & 0xFFFFFFFF)
            open(m, "w").write(json.dumps(man))
    best = mgr.latest_valid()
    assert best.step == 0
    # the JAX package's manager judges the same directory the same way
    assert jck.CheckpointManager(str(tmp_path)).latest_valid().step == 0
    np.testing.assert_array_equal(
        mgr.load(best)["params"]["arg:w"].asnumpy(), np.full((3,), 1.0))


def test_aborted_save_cleaned_by_next_commit(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    _save_step(mgr, 0, 1.0)
    os.makedirs(mgr.step_dir(1))
    _save_step(mgr, 2, 3.0)
    assert not os.path.exists(mgr.step_dir(1))
    assert mgr.latest_valid().step == 2
    monkeypatch.setenv("MXTPU_CKPT_KEEP", "4")
    assert CheckpointManager(str(tmp_path)).keep_n == 4
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    assert tck.auto_manager() is None
    monkeypatch.setenv("MXTPU_CKPT_DIR", str(tmp_path / "auto"))
    assert tck.auto_manager().directory == str(tmp_path / "auto")


# -- fit's auto-resume -------------------------------------------------------

def _mlp(m):
    x = m.sym.var("data")
    h = m.sym.Activation(m.sym.FullyConnected(x, num_hidden=16, name="fc1"),
                         act_type="relu", name="relu1")
    h = m.sym.Dropout(h, p=0.3, name="drop1")
    h = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(h, name="softmax")


def _data(n=48, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 10).astype(np.float32),
            rs.randint(0, 4, n).astype(np.float32))


class _Killed(Exception):
    pass


def _fit(num_epoch, ckpt_dir, monkeypatch, kill_at_step=None):
    """Train the MLP with dropout and Adam; with ``ckpt_dir`` checkpoint
    every epoch and resume.  ``kill_at_step`` aborts that step's save
    after its data files, before its manifest (a crash in the window)."""
    if ckpt_dir is None:
        monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    else:
        monkeypatch.setenv("MXTPU_CKPT_DIR", ckpt_dir)
    if kill_at_step is not None:
        real = tck.atomic_write

        def dying(fname, payload, checksum=True):
            if fname.endswith(os.path.join(f"step-{kill_at_step:08d}",
                                           MANIFEST_NAME)):
                raise _Killed(fname)
            return real(fname, payload, checksum)
        monkeypatch.setattr(tck, "atomic_write", dying)
    mt.random.seed(42)
    x, y = _data()
    it = mt.io.NDArrayIter(x, y, batch_size=12)
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    epochs = set()
    try:
        mod.fit(it, num_epoch=num_epoch, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                initializer=mt.init.Xavier(),
                batch_end_callback=lambda p: epochs.add(p.epoch))
    except _Killed:
        return None
    finally:
        monkeypatch.undo()
    arg, _ = mod.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    upd = mod._active_updater()
    out.update({f"state{k}_{i}": s.asnumpy()
                for k, st in upd.states.items() for i, s in enumerate(st)})
    out["epochs_trained"] = np.array(sorted(epochs))
    return out


@pytest.mark.parametrize("fused", ["1", "0"])
def test_fit_resume_after_a_crash_in_the_save_is_bit_equal(
        tmp_path, monkeypatch, fused):
    monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
    clean = _fit(3, None, monkeypatch)
    monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
    d = str(tmp_path / "ckpt")
    assert _fit(3, d, monkeypatch, kill_at_step=1) is None
    mgr = CheckpointManager(d)
    assert mgr.latest_valid().step == 0
    assert os.path.isdir(mgr.step_dir(1))          # the aborted save
    monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
    resumed = _fit(3, d, monkeypatch)
    np.testing.assert_array_equal(clean.pop("epochs_trained"), [0, 1, 2])
    np.testing.assert_array_equal(resumed.pop("epochs_trained"), [1, 2])
    assert set(resumed) == set(clean)
    for k in clean:
        assert np.array_equal(resumed[k], clean[k]), k
    assert mgr.latest_valid().step == 2
    assert not os.path.isdir(mgr.step_dir(1)) or \
        os.path.exists(os.path.join(mgr.step_dir(1), MANIFEST_NAME))


def test_fit_resume_noop_when_run_complete(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    first = _fit(2, d, monkeypatch)
    again = _fit(2, d, monkeypatch)
    assert len(again.pop("epochs_trained")) == 0
    first.pop("epochs_trained")
    for k in first:
        assert np.array_equal(first[k], again[k])


def test_module_checkpoint_callback_with_manager(tmp_path, monkeypatch):
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    x, y = _data(40, 2)
    it = mt.io.NDArrayIter(x, y, batch_size=10)
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    mgr = CheckpointManager(str(tmp_path / "cb"), keep_n=8)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mt.init.Xavier(),
            epoch_end_callback=mt.callback.module_checkpoint(mod, mgr))
    ck = mgr.latest_valid()
    assert ck.step == 1 and ck.epoch == 1
    got = mgr.load(ck)
    arg, _ = mod.get_params()
    np.testing.assert_array_equal(got["params"]["arg:fc1_weight"].asnumpy(),
                                  arg["fc1_weight"].asnumpy())
    assert got["optimizer_states"]


def test_manager_restore_into_gluon_trainer(tmp_path):
    net = mt.gluon.nn.Dense(3, in_units=4, prefix="d0_")
    net.initialize(ctx=CPU)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    x = _arr(np.random.RandomState(0).randn(2, 4))
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(2)
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    params = {k: v.data() for k, v in
              net._collect_params_with_prefix().items()}
    mgr.save(0, params=params, trainer=tr, epoch=0)
    net2 = mt.gluon.nn.Dense(3, in_units=4, prefix="d0_")
    net2.initialize(ctx=CPU)
    tr2 = mt.gluon.Trainer(net2.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    state = mgr.restore(block=net2, trainer=tr2)
    assert state["step"] == 0
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            net2._collect_params_with_prefix()[k].data().asnumpy())
    assert sorted(tr2._updater.states) == sorted(tr._updater.states)
    assert tr2._optimizer._index_update_count == {0: 1, 1: 1}
    assert tr2._optimizer.param_dict[0] is \
        net2.collect_params()["d0_weight"]


# -- checkpoints across the two packages --------------------------------------

def _module(m, ctx_kw):
    x = m.sym.var("data")
    h = m.sym.FullyConnected(x, num_hidden=8, name="fc1")
    h = m.sym.Activation(h, act_type="tanh", name="t1")
    h = m.sym.FullyConnected(h, num_hidden=3, name="fc2")
    mod = m.mod.Module(m.sym.SoftmaxOutput(h, name="softmax"), **ctx_kw)
    mod.bind([("data", (6, 5))], [("softmax_label", (6,))])
    return mod


def _batch(m, arr, seed):
    rs = np.random.RandomState(seed)
    return m.io.DataBatch([arr(rs.randn(6, 5))],
                          [arr(rs.randint(0, 3, 6).astype(np.float32))])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    """Params and Adam states (with the update counts) written by one
    package restore in the other with ``restore_rng=False``; one more
    step on each side then agrees."""
    rs = np.random.RandomState(0)
    init = {"fc1_weight": rs.randn(8, 5) * 0.3, "fc1_bias": rs.randn(8),
            "fc2_weight": rs.randn(3, 8) * 0.3, "fc2_bias": rs.randn(3)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    jmod = _module(mx, {})
    tmod = _module(mt, {"context": CPU})
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in init.items()})
    tmod.init_params(arg_params={k: _arr(v) for k, v in init.items()})
    for mod in (jmod, tmod):
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
    src, dst = (jmod, tmod) if direction == "jax_to_port" else (tmod, jmod)
    src_pkg, src_arr = (mx, mx.nd.array) if src is jmod else (mt, _arr)
    for s in range(3):
        src.forward_backward(_batch(src_pkg, src_arr, s))
        src.update()
    d = str(tmp_path / "ck")
    Mgr = jck.CheckpointManager if src is jmod else CheckpointManager
    Mgr(d).save_module(src, step=2, epoch=2)
    Dst = CheckpointManager if dst is tmod else jck.CheckpointManager
    state = Dst(d).restore(module=dst, restore_rng=False)
    assert state["step"] == 2 and state["epoch"] == 2
    sa, _ = src.get_params()
    da, _ = dst.get_params()
    for k in init:
        np.testing.assert_array_equal(da[k].asnumpy(), sa[k].asnumpy())
    su, du = src._active_updater(), dst._active_updater()
    assert sorted(su.states) == sorted(du.states)
    for k in su.states:
        for a, b in zip(su.states[k], du.states[k]):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert du.optimizer._index_update_count == \
        su.optimizer._index_update_count
    for mod, pkg, arr in ((src, src_pkg, src_arr),
                          (dst, mt if dst is tmod else mx,
                           _arr if dst is tmod else mx.nd.array)):
        mod.forward_backward(_batch(pkg, arr, 9))
        mod.update()
    sa, _ = src.get_params()
    da, _ = dst.get_params()
    for k in init:
        np.testing.assert_allclose(da[k].asnumpy(), sa[k].asnumpy(),
                                   rtol=0, atol=1e-6)


def test_fit_refuses_a_mid_epoch_preemption_snapshot(tmp_path, monkeypatch):
    """A supervisor's ``preempted`` snapshot inside an epoch is no longer
    refused (`train_driver.py` is ported): fit redoes that epoch from the
    recorded batch cursor, skipping the batches the preempted run
    consumed, then goes on to the next epoch from its first batch."""
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    mgr.save(0, params={"arg:fc1_bias": _arr(np.zeros(16))}, epoch=0,
             batch=2, extra={"preempted": True})
    monkeypatch.setenv("MXTPU_CKPT_DIR", d)
    x, y = _data()
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    seen = []
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=12), num_epoch=2,
            batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)))
    n = -(-len(x) // 12)
    assert seen == [(0, b) for b in range(2, n)] + \
        [(1, b) for b in range(n)]
