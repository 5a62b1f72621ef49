#!/usr/bin/env python3
"""Time K1, or K2 and K3, in two or more trees of this repository on one
CUDA card, beside PyTorch's fused attention, by one method for all, in
turns.

    python3 tools/torch_k1_ab.py TREE_A TREE_B [--pairs 2] [--backward]
    python3 tools/torch_k1_ab.py TREE_A TREE_B --dtype float32

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
of each one's largest magnitude in bf16, 2e-3 in fp32, on K1's residuals
and a nonzero dLSE),
then times each of them and the backward of
``scaled_dot_product_attention`` (one call for the three gradients, dLSE
0 there) on the same tensors.  The bf16 cases:

* phase 22a's BERT-base call, q, k and v [8, 12, 512, 64], not causal
  and causal;
* the same queries over 64, 128, 256 and 1024 keys, not causal (how the
  time grows with the key tiles).

With ``--dtype float32`` it times K1 in fp32 (the main path's type)
beside SDPA's fp32 forward, TF32 off in torch, after holding O and the
logsumexp at 2e-4, O within 2e-5 of its largest magnitude and its signed
bias toward zero mean((o - o_ref)·sign(o_ref)) / mean|o_ref| above
-1.5e-6 (chip_smoke's TOL, K1_SPLIT_TOL and K1_BIAS_TOL).  The fp32
cases: BERT-base's [8, 12, 512, 64], not causal and causal; its seq-128
serving call [8, 12, 128, 64]; the key sweep as above; a ring-attention
hop of the LM's [1, 12, 4096, 64], not causal and causal; and
[8, 12, 512, D] at the other head dims, D = 16, 32 and 128.

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
# fp32 O: chip_smoke's TOL[float32], K1_SPLIT_TOL and K1_BIAS_TOL
TOL_O32, TOL_SPLIT, TOL_BIAS = 2e-4, 2e-5, 1.5e-6
# fp32 gradients: chip_smoke's GRAD_TOL
TOL_GRAD32 = 2e-3
SHAPE = (8, 12, 512, 64)
KEYS = (64, 128, 256, 1024)
RING_HOP = (1, 12, 4096, 64)
OTHER_DIMS = (16, 32, 128)


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
        q, k, v, causal=causal, scale=q.shape[-1] ** -0.5)
    tol = TOL_O32 if q.dtype == torch.float32 else TOL_O
    torch.testing.assert_close(o, o_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL_LSE, atol=TOL_LSE)
    if q.dtype == torch.float32:
        diff = o - o_ref
        rel = (diff.abs().max() / o_ref.abs().max()).item()
        bias = ((diff * o_ref.sign()).mean() / o_ref.abs().mean()).item()
        if rel > TOL_SPLIT or bias < -TOL_BIAS:
            raise AssertionError(f"{name}: fp32 O off by {rel} of its "
                                 f"largest magnitude, signed bias {bias}")
        rec[f"{name}_k1_signed_bias"] = bias
    rec[f"{name}_k1_device_ms"] = _device_ms(
        torch, lambda: lambda: hk.flash_attention_with_lse(
            q, k, v, causal=causal))
    rec[f"{name}_sdpa_device_ms"] = _device_ms(
        torch, lambda: lambda: sdpa(q, k, v, is_causal=causal))


def _backward_times(torch, hk, rec, name, q, k, v, causal, gen):
    scale = SHAPE[3] ** -0.5
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    dlse = torch.randn(q.shape[:-1], generator=gen, device=q.device)
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse)
    kw = dict(causal=causal, scale=scale)
    got = (hk._attn_dq_cuda(*args, **kw), *hk._attn_dkv_cuda(*args, **kw))
    want = (hk._attn_dq_plain(*args, **kw), *hk._attn_dkv_plain(*args, **kw))
    tol = TOL_GRAD32 if q.dtype == torch.float32 else TOL_GRAD
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        if not err <= tol:
            raise AssertionError(f"{name}: {q.dtype} gradient off by {err}")

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


def _cases(dtype, backward):
    """(name, q shape, keys, causal) of one run."""
    cases = [("bert_base", SHAPE, SHAPE[2], False),
             ("bert_base_causal", SHAPE, SHAPE[2], True)]
    if dtype == "float32" and not backward:
        cases.append(("bert_base_128", SHAPE[:2] + (128, SHAPE[3]), 128,
                      False))
    cases += [(f"lk{lk}", SHAPE, lk, False) for lk in KEYS]
    if dtype == "float32" and not backward:
        cases += [("ring_hop", RING_HOP, RING_HOP[2], False),
                  ("ring_hop_causal", RING_HOP, RING_HOP[2], True)]
        cases += [(f"d{d}", SHAPE[:3] + (d,), SHAPE[2], False)
                  for d in OTHER_DIMS]
    return cases


def run_one(tree, backward, dtype="bfloat16"):
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(22)
    kind = getattr(torch, dtype)
    rec = {"tree": tree}
    with torch.no_grad():
        for name, shape, lk, causal in _cases(dtype, backward):
            kv = shape[:2] + (lk, shape[3])
            q = torch.randn(shape, generator=gen, device=dev).to(kind)
            k, v = (torch.randn(kv, generator=gen, device=dev).to(kind)
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the inputs' type")
    ap.add_argument("--one", action="store_true",
                    help="time one tree in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.trees[0], args.backward, args.dtype)),
              flush=True)
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
        cmd += ["--dtype", args.dtype] + (["--backward"] if args.backward
                                          else [])
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
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
