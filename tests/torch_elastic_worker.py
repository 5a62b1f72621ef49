"""Multi-rank worker of the elastic mesh's CPU tests
(`tests/test_torch_elastic_mesh.py`).

`tests/torch_spmd_launch.run_ranks` starts three groups of four ranks of
this script at once (GROUPS), each its own gloo group, which run the
cases of `tests/test_elastic_mesh.py` at 4 -> 3 ranks instead of 8 -> 7.
In each case the mesh's last rank is the victim: it really exits
(``kill_device_at``) or stops (``hang_device_at``) at its probe, and the
survivors go on to the group's next case on a smaller mesh (the lost
ranks banned, as a supervisor bans them).  All members of a group do the
same things until one is lost, so they form their process groups alike.
The members of a case meet on the group's store; nothing here runs a
collective of the whole group once a member is lost.  Each surviving rank
writes its results to ``OUTDIR/SUITE-wGROUP-RANK.npz``.  This script
imports neither JAX nor the JAX package.

    python tests/torch_elastic_worker.py elastic OUTDIR GROUP
"""
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import fault_injection as fi  # noqa: E402
from mxnet_tpu_torch import profiler  # noqa: E402
from mxnet_tpu_torch import train_driver as drv  # noqa: E402
from mxnet_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from mxnet_tpu_torch.parallel import distributed as dist  # noqa: E402
from mxnet_tpu_torch.parallel import elastic_mesh as em  # noqa: E402

CPU = mt.cpu()
GROUPS = (4, 4, 4)
N = 4          # the mesh before the first loss
B = 24         # the global batch: divisible by 4, 3 and 2
FEAT = 16
ROWS = 48      # 2 batches an epoch
# the probe's bound: a healthy probe under a loaded test host must end
# within twice it (the census's one extension)
TIMEOUT_S = "2.0"
#: exit codes by group and rank (-9: stopped, then killed by the launcher)
EXIT_CODES = [[0, em.KILLED_EXIT_CODE, em.KILLED_EXIT_CODE, -9],
              [0, 0, -9, -9],
              [0, 0, 0, -9]]


# ---------------------------------------------------------------------------
# the reference's model and data
# ---------------------------------------------------------------------------

def mlp(pkg):
    data = pkg.sym.Variable("data")
    label = pkg.sym.Variable("softmax_label")
    h = pkg.sym.FullyConnected(data, num_hidden=24, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return pkg.sym.SoftmaxOutput(h, label, name="softmax")


def fit_data(seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(ROWS, FEAT).astype(np.float32)
    Y = (np.arange(ROWS) % 10).astype(np.float32)
    return X, Y


def step_batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, FEAT).astype(np.float32),
             rng.randint(0, 10, (B,)).astype(np.float32))
            for _ in range(n)]


def flat_states(states):
    out = {}
    for k, v in states.items():
        if v is None:
            continue
        for j, x in enumerate(v if isinstance(v, tuple) else (v,)):
            if x is not None:
                out[f"{k}.{j}"] = np.asarray(x)
    return out


def snap(mod):
    params, _ = mod.get_params()
    return ({k: v.asnumpy() for k, v in params.items()},
            flat_states(pickle.loads(mod._updater.get_states())))


def put(res, tag, snapshot):
    params, states = snapshot
    for k, v in params.items():
        res[f"{tag}/p/{k}"] = v
    for k, v in states.items():
        res[f"{tag}/s/{k}"] = v


def make_module(opt="adam", seed=0):
    mod = mt.mod.Module(mlp(mt), data_names=["data"],
                        label_names=["softmax_label"], context=CPU)
    mod.bind(data_shapes=[("data", (B, FEAT))],
             label_shapes=[("softmax_label", (B,))], for_training=True)
    mt.random.seed(seed)
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    mod.init_optimizer(optimizer=opt,
                       optimizer_params={"learning_rate": 1e-3})
    return mod


def batch(x, y):
    return mt.io.DataBatch(data=[mt.nd.array(x, ctx=CPU)],
                           label=[mt.nd.array(y, ctx=CPU)])


def fit(X, Y, epochs=2, sup=None):
    mt.random.seed(42)
    it = mt.io.NDArrayIter(X, Y, B, shuffle=False)
    mod = mt.mod.Module(mlp(mt), data_names=("data",),
                        label_names=("softmax_label",), context=CPU)
    try:
        if sup is not None:
            sup.activate()
        mod.fit(it, num_epoch=epochs, optimizer="adam",
                optimizer_params={"learning_rate": 1e-3},
                initializer=mt.init.Xavier())
    finally:
        if sup is not None:
            sup.deactivate()
    return snap(mod), mod


# ---------------------------------------------------------------------------
# meeting on the store
# ---------------------------------------------------------------------------


def meet(tag, members):
    """Every member of a case arrives before any goes on (the store, not a
    collective: lost ranks never arrive at a later meeting)."""
    from mxnet_tpu_torch.parallel.elastic_mesh import _store
    store = _store()
    store.set(f"meet/{tag}/{dist.rank()}", "1")
    keys = [f"meet/{tag}/{r}" for r in members]
    while not store.check(keys):
        time.sleep(0.01)


def case_mesh(n):
    """Reset the process's mesh record for a case on the first ``n``
    ranks: the ranks past them, lost in earlier cases, stay banned."""
    em.reset_state()
    for r in range(n, N):
        em.ban_device(r)
    profiler.reset_mesh_counters()
    fi.clear()
    os.environ["MXTPU_SPMD"] = str(n)


def env(**kw):
    for k, v in kw.items():
        os.environ[k] = str(v)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def healthy_cases(res):
    """The kill switch, buddy neutrality and the 2/N gauge, and the banned
    rank, on the four ranks."""
    from mxnet_tpu_torch.parallel.mesh import device_ids
    from mxnet_tpu_torch.parallel.spmd_step import resolve_mesh
    case_mesh(N)
    env(MXTPU_SPMD_ZERO1=1, MXTPU_SPMD_SHARD_REDUNDANCY=0,
        MXTPU_MESH_ELASTIC=0)
    plan = fi.install(fi.FaultPlan(hang_device_at=1, kill_device_at=2))
    try:
        mod = make_module()
        for x, y in step_batches(3):
            assert mod.fused_step(batch(x, y))
        put(res, "switch_off", snap(mod))
    finally:
        fi.clear()
    s = plan.summary()
    res["switch_plan"] = np.array([plan.mesh_steps, s["device_hangs"],
                                   s["device_kills"]])
    res["switch_counters_flat"] = np.array(not profiler.mesh_counters())
    env(MXTPU_MESH_ELASTIC=1)
    mod = make_module()
    for x, y in step_batches(3):
        assert mod.fused_step(batch(x, y))
    put(res, "switch_on", snap(mod))
    for red in ("0", "1"):
        env(MXTPU_SPMD_SHARD_REDUNDANCY=red)
        mod = make_module()
        for x, y in step_batches(3):
            assert mod.fused_step(batch(x, y))
        put(res, f"redundancy{red}", snap(mod))
    env(MXTPU_SPMD_SHARD_REDUNDANCY=1)
    profiler.reset_spmd_counters()
    mod = make_module()
    for x, y in step_batches(2):
        assert mod.fused_step(batch(x, y))
    res["buddy_fraction"] = np.array(
        profiler.spmd_counters()["shard_fraction"])
    env(MXTPU_SPMD_SHARD_REDUNDANCY=0)
    with CPU:
        mesh = resolve_mesh()
        ids = device_ids(mesh)
        em.ban_device(ids[-1])
        shrunk = resolve_mesh()
        em.reset_state()
        healed = resolve_mesh()
    res["banned"] = np.array([mesh.size, shrunk.size,
                              int(ids[-1] in device_ids(shrunk)),
                              healed.size])


def _error_record(res, tag, e, dt):
    res[f"{tag}/lost"] = np.array(e.lost)
    res[f"{tag}/mesh_size"] = np.array(e.mesh_size)
    res[f"{tag}/reason"] = np.array(e.reason)
    res[f"{tag}/step"] = np.array(-1 if e.step is None else e.step)
    res[f"{tag}/census"] = np.array([e.census[p] == "ok"
                                     for p in range(e.mesh_size)])
    res[f"{tag}/timeout_s"] = np.array(e.timeout_s)
    res[f"{tag}/lost_device_ids"] = np.array(e.lost_device_ids)
    res[f"{tag}/seconds"] = np.array(dt)


def lose(res, tag, n, plan, steps):
    """On the first ``n`` ranks, ``steps`` healthy fused steps, then one
    that the plan breaks (no supervisor: the error escapes); the error's
    record and ``num_update`` before and after it."""
    case_mesh(n)
    env(MXTPU_SPMD_ZERO1=1, MXTPU_SPMD_SHARD_REDUNDANCY=0)
    mod = make_module()
    batches = step_batches(steps + 1)
    fi.install(plan)
    try:
        for x, y in batches[:steps]:
            assert mod.fused_step(batch(x, y))
        before = mod._updater.optimizer.num_update
        t0 = time.monotonic()
        try:
            mod.fused_step(batch(*batches[steps]))
            raise AssertionError("the lost rank went unnoticed")
        except em.MeshDegradedError as e:
            _error_record(res, tag, e, time.monotonic() - t0)
    finally:
        fi.clear()
    s = plan.summary()
    res[f"{tag}/plan"] = np.array([s["device_hangs"], s["device_kills"],
                                   plan.mesh_steps])
    res[f"{tag}/num_update"] = np.array(
        [before, mod._updater.optimizer.num_update])
    res[f"{tag}/device_losses"] = np.array([
        profiler.mesh_counters()["device_losses"],
        profiler.metrics_snapshot()["mesh"]["device_losses"]])


def chaos_fit(res, workdir, tag, redundancy, policy="shrink", n=N):
    """A 2-epoch fit on the first ``n`` ranks under a supervisor; the
    mesh's last rank stops at epoch 1's first step (right after the
    epoch-0 checkpoint, so the live state equals it).  Returns the rank's
    checkpoint directory."""
    X, Y = fit_data()
    case_mesh(n)
    ck = os.path.join(workdir, f"{tag}{dist.rank()}")
    env(MXTPU_SPMD_ZERO1=1, MXTPU_SPMD_SHARD_REDUNDANCY=redundancy,
        MXTPU_MESH_ON_LOSS=policy, MXTPU_CKPT_DIR=ck)
    fi.install(fi.FaultPlan(hang_device_at=3))
    try:
        snapshot, mod = fit(X, Y, sup=drv.TrainingSupervisor())
        put(res, tag, snapshot)
        res[f"{tag}/after"] = np.array([mod._spmd_train_step._n,
                                        em.shrink_count()])
    except drv.TrainingPreempted as e:
        res[f"{tag}/committed"] = np.array(e.committed)
        latest = CheckpointManager(ck).latest_valid()
        res[f"{tag}/latest"] = np.array(
            [-1, -1] if latest is None else [latest.epoch, latest.batch])
    finally:
        fi.clear()
        for k in ("MXTPU_CKPT_DIR", "MXTPU_MESH_ON_LOSS"):
            os.environ.pop(k, None)
    m = profiler.mesh_counters()
    res[f"{tag}/counters"] = np.array([
        m.get(k, 0) for k in ("device_losses", "buddy_recoveries",
                              "disk_recoveries", "reshards",
                              "degraded_steps")], dtype=np.float64)
    res[f"{tag}/reshard_ms"] = np.array(m.get("reshard_ms", 0.0))
    res[f"{tag}/shrinks"] = np.array(em.shrink_count())
    return ck


def fresh_reference(res, workdir, chaos_dir):
    """A fresh fit at n' = 3 that resumes from the chaos run's epoch-0
    checkpoint (a clean n = 4 epoch): 'a fresh n' run from the same
    state'."""
    import shutil
    X, Y = fit_data()
    src = CheckpointManager(chaos_dir).step_dir(0)
    ref = os.path.join(workdir, f"fresh{dist.rank()}")
    shutil.copytree(src, os.path.join(ref, os.path.basename(src)))
    case_mesh(N - 1)
    env(MXTPU_SPMD_ZERO1=1, MXTPU_SPMD_SHARD_REDUNDANCY=0,
        MXTPU_CKPT_DIR=ref)
    try:
        snapshot, _ = fit(X, Y, epochs=2)
    finally:
        os.environ.pop("MXTPU_CKPT_DIR", None)
    put(res, "fresh_n3", snapshot)


def suite_elastic(rank, workdir, group):
    res = {}
    os.environ["MXTPU_MESH_STEP_TIMEOUT_S"] = TIMEOUT_S
    if group == 0:
        meet("healthy", range(4))
        healthy_cases(res)
        meet("hang", range(4))
        lose(res, "hang", 4, fi.FaultPlan(hang_device_at=2), 1)
        meet("mutation", range(3))
        lose(res, "mutation", 3, fi.FaultPlan(kill_device_at=2), 1)
        meet("kill", range(2))
        lose(res, "kill", 2, fi.FaultPlan(kill_device_at=1), 0)
    elif group == 1:
        meet("buddy", range(4))
        ck = chaos_fit(res, workdir, "buddy", 1)
        meet("fresh", range(3))
        fresh_reference(res, workdir, ck)
        meet("preempt", range(3))
        chaos_fit(res, workdir, "preempt", 1, policy="preempt", n=3)
    else:
        meet("disk", range(4))
        chaos_fit(res, workdir, "disk", 0)
    return res


class _StopAt(mt.io.DataIter):
    """``inner``, but the process stops itself (SIGSTOP) when it fetches
    batch ``at`` (1-based over the run) and ``stop`` holds: a rank that
    really stops answering between steps, with no fault plan."""

    def __init__(self, inner, stop, at):
        super().__init__(inner.batch_size)
        self._inner, self._stop, self._at = inner, stop, at
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label
        self.fetched = []

    def reset(self):
        self._inner.reset()

    def __next__(self):
        batch = next(self._inner)
        self.fetched.append(time.perf_counter())
        if self._stop and len(self.fetched) == self._at:
            import signal
            os.kill(os.getpid(), signal.SIGSTOP)
        return batch

    next = __next__


class _Recorder(drv.TrainingSupervisor):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_mesh_degraded(self, exc, **kw):
        self.losses.append((time.perf_counter(), exc))
        super().on_mesh_degraded(exc, **kw)


def suite_mesh_chaos(rank, workdir, group):
    """The slow lane: rank 3 stops itself as it fetches epoch 1's first
    batch (after the epoch-0 checkpoint), no fault plan installed; the
    survivors' real probe times out, the census attributes the loss, the
    mesh shrinks 4 -> 3 with the buddy copy, and a fresh n' = 3 fit from
    the epoch-0 checkpoint is the reference."""
    res = {}
    os.environ["MXTPU_MESH_STEP_TIMEOUT_S"] = "1.0"
    meet("chaos", range(4))
    X, Y = fit_data()
    case_mesh(N)
    ck = os.path.join(workdir, f"chaos{rank}")
    env(MXTPU_SPMD_ZERO1=1, MXTPU_SPMD_SHARD_REDUNDANCY=1, MXTPU_CKPT_DIR=ck)
    mt.random.seed(42)
    it = _StopAt(mt.io.NDArrayIter(X, Y, B, shuffle=False), rank == 3, 3)
    mod = mt.mod.Module(mlp(mt), data_names=("data",),
                        label_names=("softmax_label",), context=CPU)
    sup = _Recorder().activate()
    try:
        mod.fit(it, num_epoch=2, optimizer="adam",
                optimizer_params={"learning_rate": 1e-3},
                initializer=mt.init.Xavier())
    finally:
        sup.deactivate()
        os.environ.pop("MXTPU_CKPT_DIR", None)
    t_err, exc = sup.losses[0]
    res["chaos/seconds"] = np.array(t_err - it.fetched[2])
    res["chaos/reason"] = np.array(exc.reason)
    res["chaos/lost"] = np.array(exc.lost)
    res["chaos/census"] = np.array([exc.census[p] == "ok"
                                    for p in range(exc.mesh_size)])
    res["chaos/timeout_s"] = np.array(exc.timeout_s)
    m = profiler.mesh_counters()
    res["chaos/counters"] = np.array([
        m.get(k, 0) for k in ("device_losses", "buddy_recoveries",
                              "disk_recoveries", "reshards")])
    put(res, "chaos", snap(mod))
    fresh_reference(res, workdir, ck)
    return res


def main():
    suite, outdir, group = sys.argv[1], sys.argv[2], int(sys.argv[3])
    dist.initialize()
    rank = dist.rank()
    with CPU:
        res = globals()[f"suite_{suite}"](rank, outdir, group)
    np.savez(os.path.join(outdir, f"{suite}-w{group}-{rank}.npz"), **res)
    print(f"RANK {rank} {suite} DONE", flush=True)
    # the group has lost members: skip the teardown of its groups
    os._exit(0)


if __name__ == "__main__":
    main()
