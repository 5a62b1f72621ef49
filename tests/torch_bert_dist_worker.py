"""BERT-base masked-LM training across worker processes of the PyTorch
port: the processes of `chip_smoke.py`'s phase 18 (and of its CPU
rehearsal at a small width).

    python tests/torch_bert_dist_worker.py MODE OUTDIR [--cfg JSON]
        [--batch B] [--seq L] [--steps N] [--async-steps N] [--ctx gpu|cpu]

The model is `model_zoo.bert_mlm` (``_fused_attention``, so a step on the
card launches K1, K2 and K3 once per layer) with the loss head's gradient
summed over the masked positions (``normalization='null'``), weights from
``random_params(seed 0)`` and one fixed batch of ``B`` x ``L`` tokens from
a seed; worker ``r`` of ``n`` takes rows ``[r·B/n, (r+1)·B/n)``.

MODE:

* ``reference`` -- one process on the whole batch: ``--steps`` steps of
  BERT's Adam through `Module` with the local updater (dropout 0); writes
  ``OUTDIR/reference.npz``.
* ``sync`` -- a worker of ``tools/launch.py -n 2``: the same steps through
  ``Module.init_optimizer(kvstore='dist_sync')`` (the store over the gloo
  group runs Adam on the summed gradient); prints a digest of every
  parameter after each step (the workers must agree bit for bit) and rank
  0 writes ``OUTDIR/sync.npz``.
* ``async`` -- a worker of ``BYTEPS_ENABLE_ASYNC=1 tools/launch.py -n 2
  -s 1``, whose server is this same command importing the package under
  ``DMLC_ROLE=server``.  Part 1, no server optimizer: ``--steps`` pushes of
  this worker's gradients into ``dist_async`` keys (the server adds them),
  their float64 sums exchanged through ``OUTDIR``; after a barrier each
  worker's pull must equal the initial weights plus both workers' sums,
  within ``pushes · 2^-24 · (max|w0| + Σ max|g|)`` per key.  Part 2:
  ``Module`` over ``dist_async`` with BERT's Adam set on the server
  (``set_optimizer``), dropout 0.1, ``--async-steps`` steps, whose loss
  must fall.

Each process writes its record to ``OUTDIR/<mode>-<rank>.json`` (its
step times, the share of a step spent in the store's push and pull, the
comm counters, and its K1-K3 launch counts; rank 0 of ``async`` adds the
server's stats) and prints a ``DIST-WORKER`` line naming it: the
workers share one output pipe, where a long line of one process could
interleave with another's.  It imports neither JAX nor the JAX package.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# first: under DMLC_ROLE=server with BYTEPS_ENABLE_ASYNC this import is the
# parameter server, and returns only to exit
import mxnet_tpu_torch as mt  # noqa: E402

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import profiler  # noqa: E402
from mxnet_tpu_torch.model_zoo import (BERT_BASE, bert_mlm,  # noqa: E402
                                       random_params)
from mxnet_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

SEED = 0
# BERT's published Adam settings, in MXNet's L2 form of weight decay
ADAM = dict(learning_rate=1e-4, wd=0.01, beta2=0.999, epsilon=1e-6)
ATTN_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def summed_head(cfg, dropout):
    """`bert_mlm` with the head's gradient summed over the masked
    positions, so the shards' gradients add up to the whole batch's."""
    internals = bert_mlm(mt.sym, **dict(cfg, dropout=dropout)) \
        .get_internals()
    return mt.sym.SoftmaxOutput(internals["mlm_flat_output"],
                                internals["mlm_label_flat_output"],
                                use_ignore=True, ignore_label=-1,
                                normalization="null", name="mlm")


def fixed_batch(vocab, batch, seq):
    """Token ids and labels (the token at 15 % of the positions, -1
    elsewhere) from a seed, as numpy."""
    rng = np.random.RandomState(SEED + 18)
    data = rng.randint(0, vocab, (batch, seq)).astype(np.float32)
    label = np.where(rng.rand(batch, seq) < 0.15, data, -1.0) \
        .astype(np.float32)
    return data, label


def initial_params(sym, batch, seq):
    shapes = {"data": (batch, seq), "positions": (1, seq),
              "mlm_label": (batch, seq)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return random_params({n: s for n, s in zip(sym.list_arguments(),
                                               arg_shapes)
                          if n not in shapes}, SEED)


def module(sym, params, rows, seq, ctx):
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)
    mod.bind([("data", (rows, seq)), ("positions", (1, seq))],
             [("mlm_label", (rows, seq))])
    mod.init_params(arg_params=params)
    return mod


def data_batch(data, label, seq, ctx):
    pos = np.arange(seq, dtype=np.float32)[None]
    return mt.io.DataBatch([mt.nd.array(data, ctx=ctx),
                            mt.nd.array(pos, ctx=ctx)],
                           [mt.nd.array(label, ctx=ctx)])


def mlm_loss(mod, label):
    """Summed -log p(label) over the masked positions, per position."""
    prob = mod.get_outputs()[0].data
    flat = torch.as_tensor(label.reshape(-1), device=prob.device)
    rows = torch.nonzero(flat >= 0).squeeze(1)
    return -torch.log(prob[rows, flat[rows].long()]).mean().item()


def trained(mod):
    arg, _ = mod.get_params()
    return {n: a.asnumpy() for n, a in arg.items()}


def digest(params):
    h = hashlib.sha1()
    for n in sorted(params):
        h.update(n.encode())
        h.update(params[n].tobytes())
    return h.hexdigest()


def sync_device(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def train_steps(mod, batch, label, steps, ctx, kv=None):
    """``steps`` forward/backward/update steps; the ms of each and the
    ms of each spent in the store's push and pull (the update's pushpull
    until the comm plane has finished), with each step's digest when the
    store is a dist one."""
    step_ms, comm_ms, losses, digests = [], [], [], []
    for _ in range(steps):
        sync_device(ctx)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        losses.append(mlm_loss(mod, label))
        sync_device(ctx)
        t1 = time.perf_counter()
        mod.update()
        if kv is not None:
            kv.comm.flush()
        for a in mod._exec.arg_dict.values():
            a.data  # lands a pending pull
        sync_device(ctx)
        t2 = time.perf_counter()
        step_ms.append((t2 - t0) * 1e3)
        comm_ms.append((t2 - t1) * 1e3)
        if kv is not None:
            digests.append(digest(trained(mod)))
    return step_ms, comm_ms, losses, digests


def launches():
    return {k: int(hk.LAUNCHES.get(k, 0)) for k in ATTN_KERNELS}


def emit(outdir, rec):
    path = os.path.join(outdir, f"{rec['mode']}-{rec['rank']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, default=float)
    print(f"DIST-WORKER {rec['mode']} rank {rec['rank']}: {path}",
          flush=True)


def run_reference(args, cfg, ctx):
    sym = summed_head(cfg, 0.0)
    params = initial_params(sym, args.batch, args.seq)
    data, label = fixed_batch(cfg["vocab"], args.batch, args.seq)
    mod = module(sym, params, args.batch, args.seq, ctx)
    mod.init_optimizer(kvstore="local", optimizer="adam",
                       optimizer_params=ADAM)
    batch = data_batch(data, label, args.seq, ctx)
    hk.reset_launch_counts()
    step_ms, _, losses, _ = train_steps(mod, batch, label, args.steps, ctx)
    np.savez(os.path.join(args.outdir, "reference.npz"), **trained(mod))
    emit(args.outdir, {"mode": "reference", "rank": 0, "step_ms": step_ms,
                       "losses": losses, "launches": launches()})


def run_sync(args, cfg, ctx):
    sym = summed_head(cfg, 0.0)
    params = initial_params(sym, args.batch, args.seq)
    data, label = fixed_batch(cfg["vocab"], args.batch, args.seq)
    mod = module(sym, params, args.batch // 2, args.seq, ctx)
    mod.init_optimizer(kvstore="dist_sync", optimizer="adam",
                       optimizer_params=ADAM)
    kv = mod._kvstore
    rank, n = kv.rank, kv.num_workers
    assert n == int(os.environ["DMLC_NUM_WORKER"]) and \
        rank == int(os.environ["DMLC_WORKER_ID"]), (rank, n)
    rows = slice(rank * args.batch // n, (rank + 1) * args.batch // n)
    batch = data_batch(data[rows], label[rows], args.seq, ctx)
    profiler.reset_comm_counters()
    hk.reset_launch_counts()
    step_ms, comm_ms, losses, digests = train_steps(
        mod, batch, label[rows], args.steps, ctx, kv)
    if rank == 0:
        np.savez(os.path.join(args.outdir, "sync.npz"), **trained(mod))
    kv.barrier()
    emit(args.outdir, {
        "mode": "sync", "rank": rank, "workers": n, "step_ms": step_ms,
        "comm_ms": comm_ms,
        "comm_share": float(np.sum(comm_ms) / np.sum(step_ms)),
        "losses": losses, "digests": digests,
        "comm": profiler.comm_counters(), "launches": launches()})


def run_async(args, cfg, ctx):
    sym = summed_head(cfg, 0.0)
    params = initial_params(sym, args.batch, args.seq)
    data, label = fixed_batch(cfg["vocab"], args.batch, args.seq)
    kv = mt.kv.create("dist_async")
    assert kv._ps is not None, "the async hook is set but no server"
    rank, n = int(os.environ["DMLC_WORKER_ID"]), \
        int(os.environ["DMLC_NUM_WORKER"])
    rows = slice(rank * args.batch // n, (rank + 1) * args.batch // n)
    local = module(sym, params, args.batch // n, args.seq, ctx)
    batch = data_batch(data[rows], label[rows], args.seq, ctx)
    names = sorted(params)
    keys = ["g:" + k for k in names]
    hk.reset_launch_counts()
    profiler.reset_comm_counters()

    # part 1: the server adds what the workers push (stored += recved)
    kv.init(keys, [mt.nd.array(params[k], ctx=ctx) for k in names])
    kv._ps.barrier()
    sums = {k: np.zeros(params[k].shape, np.float64) for k in names}
    gmax = {k: 0.0 for k in names}
    push_ms = []
    for _ in range(args.steps):
        local.forward_backward(batch)
        grads = [local._exec.grad_dict[k] for k in names]
        for k, g in zip(names, grads):
            a = g.asnumpy()
            sums[k] += a
            gmax[k] += float(np.abs(a).max())
        sync_device(ctx)
        t0 = time.perf_counter()
        kv.push(keys, grads)
        kv.comm.flush()
        push_ms.append((time.perf_counter() - t0) * 1e3)
    np.savez(os.path.join(args.outdir, f"sums{rank}.npz"),
             **{k: v for k, v in sums.items()})
    with open(os.path.join(args.outdir, f"gmax{rank}.json"), "w") as f:
        json.dump(gmax, f)
    kv._ps.barrier()
    others = [np.load(os.path.join(args.outdir, f"sums{r}.npz"))
              for r in range(n)]
    gmaxes = []
    for r in range(n):
        with open(os.path.join(args.outdir, f"gmax{r}.json")) as f:
            gmaxes.append(json.load(f))
    outs = [mt.nd.zeros(params[k].shape, ctx=ctx) for k in names]
    t0 = time.perf_counter()
    kv.pull(keys, out=outs)
    pulled = [o.asnumpy() for o in outs]
    pull_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    pushes = args.steps * n
    for k, got in zip(names, pulled):
        want = params[k].astype(np.float64) + sum(o[k] for o in others)
        bound = pushes * 2.0 ** -24 * (
            float(np.abs(params[k]).max()) + sum(g[k] for g in gmaxes))
        err = float(np.abs(got - want).max())
        if err > bound:
            raise AssertionError(f"async sum of {k}: {err} > {bound}")
        worst = max(worst, err / bound if bound else 0.0)
    kv._ps.barrier()

    # part 2: BERT's Adam on the server, dropout 0.1, asynchronous steps
    sym2 = summed_head(cfg, 0.1)
    mod = module(sym2, params, args.batch // n, args.seq, ctx)
    mod.init_optimizer(kvstore="dist_async", optimizer="adam",
                       optimizer_params=ADAM)
    mt.random.seed(SEED + rank)
    step_ms, comm_ms, losses, _ = train_steps(
        mod, batch, label[rows], args.async_steps, ctx, mod._kvstore)
    first, last = losses[0], float(np.mean(losses[-3:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"async rank {rank}: loss {losses}")
    mod._kvstore._ps.barrier()
    rec = {"mode": "async", "rank": rank, "workers": n,
           "part1_push_ms": push_ms, "part1_pull_ms": pull_ms,
           "part1_worst_over_bound": worst, "part1_pushes": pushes,
           "step_ms": step_ms, "comm_ms": comm_ms,
           "comm_share": float(np.sum(comm_ms) / np.sum(step_ms)),
           "losses": losses, "comm": profiler.comm_counters(),
           "launches": launches()}
    if rank == 0:
        st = mod._kvstore.ps_counters()
        srv = st["server"]
        rec["server"] = {
            "sync_mode": srv.get("sync_mode"), "keys": srv.get("keys"),
            "dead_workers": srv.get("dead_workers"),
            "staleness_hist": srv.get("staleness_hist"),
            "worker_versions": srv.get("worker_versions"),
            "dedup_hits": srv.get("dedup_hits")}
        rec["client"] = st["client"]
    mod._kvstore._ps.barrier()
    emit(args.outdir, rec)


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("reference", "sync", "async"))
    p.add_argument("outdir")
    p.add_argument("--cfg", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--async-steps", type=int, default=10)
    p.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"))
    args = p.parse_args()
    cfg = dict(BERT_BASE if args.cfg is None else json.loads(args.cfg))
    ctx = mt.gpu(0) if args.ctx == "gpu" else mt.cpu()
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with ctx:
        {"reference": run_reference, "sync": run_sync,
         "async": run_async}[args.mode](args, cfg, ctx)


if __name__ == "__main__":
    main()
