#!/usr/bin/env python3
"""Time K4's call and the PTB LSTM LM's forward in two or more trees of
this repository on one CUDA card, by one method for all, in turns.

    python3 tools/torch_k4_ab.py TREE_A TREE_B [--pairs 2]

Each TREE is a checkout root holding `mxnet_tpu_torch` (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory,
and ``.``).  The trees run in ABBA order, ``--pairs`` times over, each run
a process of its own that imports the package of its tree and nothing of
another.  A run times, at the LM's [32, 800] gates and [32, 200] cell in
fp32, K4's wrapper (`hopper_kernels.lstm_gates`) and PyTorch's fused LSTM
cell (``aten._thnn_fused_lstm_cell``) as:

* ``mean_ms``: CUDA events over 100 back-to-back calls after 3 warm-ups;
* ``best5_ms``: the best of 5 such rounds, the two calls taking turns;
* ``host_us``: wall µs a call to issue 1000 back-to-back calls, the best
  of 3 rounds in turns;
* ``device_us``: the profiler's kernel µs a call over 200 calls;

and the LM's forward alone (2 x 200, embed 200, vocab 10000, batch 32,
T = 60, random weights from seed 0) through `Predictor` on the card: the
median ms over 30 requests, each ending in a device synchronize, with 120
K4 launches a forward checked.  Each run prints one JSON line; the last
line is the summary: for each tree, each number's median over its runs
and its range.  The card's name and power limit come first.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

N_REQUESTS = 30


def _time_ms(torch, fn, iters=100, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(torch, fn, n=1000):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def _device_us(torch, fn, n=200):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / n if total else None


def run_one(tree):
    """One run in ``tree``; returns its record."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.model_zoo import PTB_LSTM, lstm_lm, random_params
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    from mxnet_tpu_torch.serialization import dumps_ndarrays
    got = os.path.dirname(os.path.abspath(mt.__file__))
    if got != os.path.join(tree, "mxnet_tpu_torch"):
        raise SystemExit(f"torch_k4_ab: mxnet_tpu_torch came from {got}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch, hidden = 32, PTB_LSTM["num_hidden"]
    gates = torch.randn((batch, 4 * hidden), generator=gen, device=dev)
    c = torch.randn((batch, hidden), generator=gen, device=dev)
    zeros = torch.zeros_like(gates)
    lib = torch.ops.aten._thnn_fused_lstm_cell
    calls = {"k4": lambda: hk.lstm_gates(gates, c),
             "library": lambda: lib(gates, zeros, c)}
    with torch.no_grad():
        c_new, h_new = calls["k4"]()
        hy, cy, _ = calls["library"]()
        err = max((c_new - cy).abs().max().item(),
                  (h_new - hy).abs().max().item())
        if not err <= 1e-5:
            raise AssertionError(f"K4 off the library cell by {err}")
        rec = {"tree": tree, "k4_vs_library_max_abs_err": err}
        for name, fn in calls.items():
            rec[f"{name}_mean_ms"] = _time_ms(torch, fn)
        best = dict.fromkeys(calls, float("inf"))
        host = dict.fromkeys(calls, float("inf"))
        for _ in range(5):
            for name, fn in calls.items():
                best[name] = min(best[name], _time_ms(torch, fn))
        for _ in range(3):
            for name, fn in calls.items():
                host[name] = min(host[name], _host_us(torch, fn))
        for name, fn in calls.items():
            rec[f"{name}_best5_ms"] = best[name]
            rec[f"{name}_host_us"] = host[name]
            rec[f"{name}_device_us"] = _device_us(torch, fn)

    # the LM's forward alone through Predictor, every cell on K4
    t = 60
    sym = lstm_lm(mt, t, **PTB_LSTM)
    shapes = {"data": (batch, t)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n != "data"}, 0)
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    pred = mt.Predictor(sym.tojson(), blob, shapes)
    feed = np.random.RandomState(4).randint(
        0, PTB_LSTM["vocab"], (batch, t)).astype(np.float32)
    pred.forward(data=feed)
    pred.get_output(0).asnumpy()
    fwd = []
    for _ in range(N_REQUESTS):
        before = hk.LAUNCHES["lstm_gates"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(data=feed)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
        if hk.LAUNCHES["lstm_gates"] - before != 2 * t:
            raise AssertionError("a forward did not launch K4 2·T times")
    rec["lm_forward_p50_ms"] = float(np.median(fwd))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--one", action="store_true",
                    help="time one tree in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.trees[0])), flush=True)
        return
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0].strip(), flush=True)
    order = (trees + trees[::-1]) * args.pairs
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"torch_k4_ab: the run in {tree} failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {
            key: {"median": statistics.median(r[key] for r in mine),
                  "min": min(r[key] for r in mine),
                  "max": max(r[key] for r in mine)}
            for key in mine[0] if key != "tree" and
            all(isinstance(r[key], float) for r in mine)}
    print(json.dumps({"runs_per_tree": len(order) // len(trees),
                      "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
