#!/usr/bin/env python3
"""Time K1, or K2 and K3, in bf16 in two or more trees of this repository
on one CUDA card, beside PyTorch's fused attention, by one method for all,
in turns.

    python3 tools/torch_k1_ab.py TREE_A TREE_B [--pairs 2] [--backward]

Each TREE is a checkout root holding `mxnet_tpu_torch` (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory,
and ``.``).  The trees run in ABBA order, ``--pairs`` times over, each run
a process of its own that builds its tree's kernels and imports the
package of its tree and nothing of another.  By default a run holds K1's
wrapper (`hopper_kernels.flash_attention_with_lse`) against the plain
version on O (2e-2) and the logsumexp (2e-4), then times it and
``scaled_dot_product_attention`` on the same bf16 tensors.  With
``--backward`` it holds K2's and K3's wrappers (`_attn_dq_cuda`,
`_attn_dkv_cuda`) against their plain versions (dq, dk and dv within 2e-2
of each one's largest magnitude, on K1's residuals and a nonzero dLSE),
then times each of them and the backward of
``scaled_dot_product_attention`` (one call for the three gradients, dLSE
0 there) on the same tensors.  The cases:

* phase 22a's BERT-base call, q, k and v [8, 12, 512, 64], not causal
  and causal;
* the same queries over 64, 128, 256 and 1024 keys, not causal (how the
  time grows with the key tiles).

Each time is a device time: a CUDA graph captures 20 back-to-back calls,
10 replays are timed with CUDA events, and the time is divided by the
200 calls (no host time of the calls is in it).  Each run prints one JSON
line; the last line is the summary: for each tree, each time's median
over its runs and its range.  The card's name and power limit come first.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

CALLS, REPLAYS = 20, 10
TOL_O, TOL_LSE, TOL_GRAD = 2e-2, 2e-4, 2e-2
SHAPE = (8, 12, 512, 64)
KEYS = (64, 128, 256, 1024)


def _device_ms(torch, make):
    """Device ms of one call of the function ``make()`` returns; ``make``
    runs on the capture's stream (a backward is captured on its forward's
    stream)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn = make()
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (CALLS * REPLAYS)


def _forward_times(torch, hk, rec, name, q, k, v, causal):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal)
    o_ref, lse_ref = hk._flash_attention_with_lse_plain(
        q, k, v, causal=causal, scale=SHAPE[3] ** -0.5)
    torch.testing.assert_close(o, o_ref, rtol=TOL_O, atol=TOL_O)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL_LSE, atol=TOL_LSE)
    rec[f"{name}_k1_device_ms"] = _device_ms(
        torch, lambda: lambda: hk.flash_attention_with_lse(
            q, k, v, causal=causal))
    rec[f"{name}_sdpa_device_ms"] = _device_ms(
        torch, lambda: lambda: sdpa(q, k, v, is_causal=causal))


def _backward_times(torch, hk, rec, name, q, k, v, causal, gen):
    scale = SHAPE[3] ** -0.5
    do = torch.randn(q.shape, generator=gen, device=q.device).bfloat16()
    dlse = torch.randn(q.shape[:-1], generator=gen, device=q.device)
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse)
    kw = dict(causal=causal, scale=scale)
    got = (hk._attn_dq_cuda(*args, **kw), *hk._attn_dkv_cuda(*args, **kw))
    want = (hk._attn_dq_plain(*args, **kw), *hk._attn_dkv_plain(*args, **kw))
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        if not err <= TOL_GRAD:
            raise AssertionError(f"{name}: bf16 gradient off by {err}")

    def sdpa_backward():
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, scale=scale)
        return lambda: torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)

    rec[f"{name}_k2_device_ms"] = _device_ms(
        torch, lambda: lambda: hk._attn_dq_cuda(*args, **kw))
    rec[f"{name}_k3_device_ms"] = _device_ms(
        torch, lambda: lambda: hk._attn_dkv_cuda(*args, **kw))
    rec[f"{name}_sdpa_bwd_device_ms"] = _device_ms(torch, sdpa_backward)


def run_one(tree, backward):
    """One run in ``tree``; returns its record."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    got = os.path.dirname(os.path.abspath(mt.__file__))
    if got != os.path.join(tree, "mxnet_tpu_torch"):
        raise SystemExit(f"torch_k1_ab: mxnet_tpu_torch came from {got}")
    cuda_build.build(["flash_attn_fwd", "flash_attn_bwd"] if backward
                     else ["flash_attn_fwd"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(22)
    rec = {"tree": tree}
    cases = [("bert_base", SHAPE[2], False), ("bert_base_causal", SHAPE[2],
                                                 True)]
    cases += [(f"lk{lk}", lk, False) for lk in KEYS]
    with torch.no_grad():
        for name, lk, causal in cases:
            kv = SHAPE[:2] + (lk, SHAPE[3])
            q = torch.randn(SHAPE, generator=gen, device=dev).bfloat16()
            k, v = (torch.randn(kv, generator=gen, device=dev).bfloat16()
                    for _ in range(2))
            if backward:
                _backward_times(torch, hk, rec, name, q, k, v, causal, gen)
            else:
                _forward_times(torch, hk, rec, name, q, k, v, causal)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--backward", action="store_true",
                    help="time K2 and K3 and SDPA's backward")
    ap.add_argument("--one", action="store_true",
                    help="time one tree in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.trees[0], args.backward)), flush=True)
        return
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0].strip(), flush=True)
    order = (trees + trees[::-1]) * args.pairs
    runs = []
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        out = subprocess.run(cmd + (["--backward"] if args.backward else []),
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"torch_k1_ab: the run in {tree} failed")
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
            for key in mine[0] if key != "tree"}
    print(json.dumps({"runs_per_tree": len(order) // len(trees),
                      "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
