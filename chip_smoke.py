#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`mxnet_tpu_torch`) end to end on one
NVIDIA Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device of compute capability (9, 0), ``nvcc`` and
``nvidia-smi``, and builds the kernels from the sources in the checkout.

Phases; any failure ends the run with a non-zero exit and no result line:

1. device  -- the card's name and power limit (``nvidia-smi``), the
   capability check, TF32 off (parity is held in fp32).
2. build   -- every kernel of `mxnet_tpu_torch/csrc`, one ``nvcc`` per
   source, all started together; prints the seconds and the ptxas report.
3. kernels -- each kernel against its plain PyTorch version on the same
   inputs on the card (fp32 at 2e-4, bf16 compared in bf16 at 2e-2), at
   the main path's shape and others, with the kernel's, the plain
   version's and one PyTorch library call's times beside the bound.
4. slice   -- BERT-base (12 x 768, 12 heads, FFN 3072, vocab 30522, random
   weights from a seed, handed over as a `.params` blob) served by
   `mxnet_tpu_torch.Predictor` on cuda:0: 4 requests at (8, 512), a reshape
   to (8, 128), 2 more.  The graph optimizer must swap all 12 attention
   sites onto K1 and each forward must launch it 12 times; the outputs
   must match a second Predictor that runs the unfused graph on the card
   (``MXTPU_PALLAS=0``).  At each shape, after the checked requests and
   one warm-up, a few hundred more are timed for the latency percentiles.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.model_zoo import (BERT_BASE, bert_encoder,  # noqa: E402
                                       random_params)
from mxnet_tpu_torch.ndarray.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch.ops import cuda_build, hopper_kernels as hk  # noqa: E402
from mxnet_tpu_torch.serialization import dumps_ndarrays  # noqa: E402

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by input type;
# fp32 is the rate outside the tensor cores
MEM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# 12 LayerNorm'd layers of fp32 sums taken in another order
SLICE_TOL = 1e-3
# requests timed per bound sequence length, after the checked ones and one
# warm-up
TIMED = {512: 200, 128: 400}


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay warm in L2 where they fit)."""
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    got = os.path.dirname(os.path.abspath(mt.__file__))
    if got != os.path.join(HERE, "mxnet_tpu_torch"):
        raise SystemExit(f"chip_smoke: mxnet_tpu_torch came from {got}, "
                         "not from this checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels are built for sm_90a; "
                         f"this card has capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.perf_counter()
    logs = cuda_build.build()
    secs = time.perf_counter() - t0
    log(f"build: {len(logs)} kernel source(s) in {secs:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return secs


def _attention_bound(q, k, causal):
    """Least time for K1's work on these inputs: each input read once and
    each output written once over HBM, or the operations this mask needs
    over the peak rate for the input type, whichever is larger."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    bh = q.numel() // (lq * d)
    elem = q.element_size()
    nbytes = (2 * bh * lq * d + 2 * bh * lk * d) * elem + bh * lq * 4
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    flops = 4.0 * bh * d * pairs
    t_mem = nbytes / MEM_BPS
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem > t_ops
                                     else "operations")


def check_attention(name, q_shape, lk, dtype, causal, gen):
    """K1 against its plain version on one input; returns the record."""
    d = q_shape[-1]
    kv_shape = tuple(q_shape[:-2]) + (lk, d)
    dev = torch.device("cuda", 0)
    q = torch.randn(q_shape, generator=gen, device=dev).to(dtype)
    k = torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
    scale = d ** -0.5
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal)
    o_ref, lse_ref = hk._flash_attention_with_lse_plain(
        q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    # the library call gets the same tensors as [B, H, L, D] views, the
    # layout it is fastest on
    lib_qkv = (q, k, v) if q.dim() == 4 else (q[None], k[None], v[None])
    tol = TOL[dtype]
    torch.testing.assert_close(o, o_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    err = (o.float() - o_ref.float()).abs().max().item()
    rec = {
        "check": name, "q": list(q_shape), "lk": lk,
        "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "max_abs_err": err,
        "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
        "ms": time_ms(lambda: hk.flash_attention_with_lse(
            q, k, v, causal=causal)),
        "plain_ms": time_ms(lambda: hk._flash_attention_with_lse_plain(
            q, k, v, causal=causal, scale=scale)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *lib_qkv, is_causal=causal, scale=scale)),
    }
    rec["bound_ms"], rec["bound_by"] = _attention_bound(q, k, causal)
    log(json.dumps(rec))
    return rec


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # BERT-base attention as the main path calls it: the graph's
    # (batch * heads, seq, 64) batch_dot entries, at seq 512 and 128
    cases = [("bert_base", (96, 512, 64), 512, torch.float32, False),
             ("bert_base_128", (96, 128, 64), 128, torch.float32, False),
             ("bert_base", (96, 512, 64), 512, torch.float32, True)]
    for causal in (False, True):
        cases.append(("bert_base", (8, 12, 512, 64), 512, torch.bfloat16,
                      causal))
    for causal in (False, True):
        cases += [("small", (2, 3, 256, 16), 256, torch.float32, causal),
                  ("lq_ne_lk", (2, 4, 128, 64), 256, torch.float32, causal),
                  ("d32", (1, 2, 128, 32), 128, torch.float32, causal),
                  ("d128", (2, 2, 256, 128), 256, torch.bfloat16, causal)]
    with torch.no_grad():
        recs = [check_attention(*c, gen) for c in cases]
    # the main path's call: BERT-base attention at seq 512, fp32, no mask
    return recs[0]


def _serve(pred, requests, positions, launches_per_forward=None,
           keep=True):
    """Answer each request: forward plus the output copy to the host;
    returns the outputs (when ``keep``) and the latencies in ms.  With
    ``launches_per_forward``, each forward must launch K1 that many
    times."""
    outs, lat = [], []
    for data in requests:
        before = hk.LAUNCHES["flash_attn_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(data=data, positions=positions)
        out = pred.get_output(0).asnumpy()
        lat.append((time.perf_counter() - t0) * 1e3)
        if keep:
            outs.append(out)
        launched = hk.LAUNCHES["flash_attn_fwd"] - before
        if launches_per_forward is not None and \
                launched != launches_per_forward:
            raise AssertionError(f"a forward launched K1 {launched} times, "
                                 f"want {launches_per_forward}")
    return outs, lat


def _latency(pred, requests, positions, n, launches_per_forward=None):
    """Latency summary of ``n`` requests cycled from ``requests``, after one
    untimed warm-up request at the bound shape."""
    _serve(pred, requests[:1], positions, launches_per_forward, keep=False)
    _, lat = _serve(pred, [requests[i % len(requests)] for i in range(n)],
                    positions, launches_per_forward, keep=False)
    q = np.percentile(lat, [50, 90, 99])
    return {"n": n, "p50_ms": float(q[0]), "p90_ms": float(q[1]),
            "p99_ms": float(q[2]), "min_ms": float(min(lat)),
            "max_ms": float(max(lat))}


def profile_forward(tag, pred, data, positions):
    """Device time by kernel over one warm forward (with the output copy
    to the host), and the device's idle share of that wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pred.forward(data=data, positions=positions)
    pred.get_output(0).asnumpy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.forward(data=data, positions=positions)
        pred.get_output(0).asnumpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    rec = {"profile": tag, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else
           "not measured",
           "top": [[name[:90], ms, n] for name, ms, n in rows[:12]]}
    log(json.dumps(rec))


def _rewrites(pred):
    return [r.rewrites for r in pred._program.opt_reports
            if r.name == "pallas_select"][0]


@contextlib.contextmanager
def pallas_mode(value):
    """``MXTPU_PALLAS`` for the Predictors built and reshaped inside."""
    old = os.environ.get("MXTPU_PALLAS")
    os.environ["MXTPU_PALLAS"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS", None)
        else:
            os.environ["MXTPU_PALLAS"] = old


def phase_slice(card):
    cfg = dict(BERT_BASE)
    n_layers = cfg["num_layers"]
    batch, seq, short = 8, 512, 128
    sym = bert_encoder(mt.sym, **cfg)
    shapes = {"data": (batch, seq), "positions": (1, seq)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    t0 = time.perf_counter()
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    n_params = sum(a.size for a in params.values())
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    del params
    log(f"slice: BERT-base {n_params} parameters, blob {len(blob)} bytes, "
        f"made in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED + 1)
    reqs = [rng.randint(0, cfg["vocab"], (batch, seq)).astype(np.float32)
            for _ in range(4)]
    reqs_short = [rng.randint(0, cfg["vocab"], (batch, short))
                  .astype(np.float32) for _ in range(2)]
    pos = np.arange(seq, dtype=np.float32)[None]
    pos_short = np.arange(short, dtype=np.float32)[None]
    short_shapes = {"data": (batch, short), "positions": (1, short)}

    # the reference: the unfused graph on the same card
    with pallas_mode("0"):
        ref = mt.Predictor(sym.tojson(), blob, shapes)
        if _rewrites(ref) != 0:
            raise AssertionError("MXTPU_PALLAS=0 still swapped kernels in")
        ref_out, _ = _serve(ref, reqs, pos)
        ref_lat = _latency(ref, reqs, pos, TIMED[seq])
        ref.reshape(short_shapes)
        ref_out_s, _ = _serve(ref, reqs_short, pos_short)
        ref_lat_s = _latency(ref, reqs_short, pos_short, TIMED[short])
        ref.reshape(shapes)
        profile_forward("unfused seq 512", ref, reqs[0], pos)
    del ref
    torch.cuda.empty_cache()

    # the main path: Predictor with the default kernel selection
    with pallas_mode("auto"):
        pred = mt.Predictor(sym.tojson(), blob, shapes)
        if _rewrites(pred) != n_layers:
            raise AssertionError(f"pallas_select rewrote {_rewrites(pred)} "
                                 f"attention sites, want {n_layers}")
        hk.reset_launch_counts()
        outs, _ = _serve(pred, reqs, pos, n_layers)
        lat = _latency(pred, reqs, pos, TIMED[seq], n_layers)
        pred.reshape(short_shapes)
        if _rewrites(pred) != n_layers:
            raise AssertionError("pallas_select after reshape rewrote "
                                 f"{_rewrites(pred)} sites")
        outs_s, _ = _serve(pred, reqs_short, pos_short, n_layers)
        lat_s = _latency(pred, reqs_short, pos_short, TIMED[short], n_layers)
        launches = dict(hk.LAUNCHES)
        forwards = len(reqs) + len(reqs_short) + TIMED[seq] + TIMED[short] + 2
        if launches["flash_attn_fwd"] != n_layers * forwards:
            raise AssertionError(f"K1 launched {launches} times over "
                                 f"{forwards} forwards")
        # diagnostics after the counted run: where a forward's time goes
        profile_forward("K1 seq 128", pred, reqs_short[0], pos_short)
        pred.reshape(shapes)
        profile_forward("K1 seq 512", pred, reqs[0], pos)

    worst = 0.0
    for got, want, shape in ([(g, w, (batch, seq, cfg["hidden"]))
                              for g, w in zip(outs, ref_out)]
                             + [(g, w, (batch, short, cfg["hidden"]))
                                for g, w in zip(outs_s, ref_out_s)]):
        if got.shape != shape or not np.isfinite(got).all():
            raise AssertionError(f"output {got.shape} not finite {shape}")
        np.testing.assert_allclose(got, want, rtol=SLICE_TOL, atol=SLICE_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    rec = {
        "slice": "bert_base_predictor", "card": card,
        "batch": batch, "seq": seq, "short_seq": short,
        "latency": lat, "latency_short": lat_s,
        "tokens_per_s": batch * seq / (lat["p50_ms"] / 1e3),
        "tokens_per_s_short": batch * short / (lat_s["p50_ms"] / 1e3),
        "unfused_latency": ref_lat, "unfused_latency_short": ref_lat_s,
        "max_abs_diff_vs_unfused": worst, "launches": launches,
    }
    log(json.dumps(rec))
    return launches


def main():
    card = phase_device()
    phase_build()
    k1 = phase_kernels()
    launches = phase_slice(card)
    leaked = [m for m in ("jax", "mxnet_tpu") if m in sys.modules]
    if leaked:
        raise SystemExit(f"chip_smoke: the port imported {leaked}")
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:92",
        "launches": launches["flash_attn_fwd"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
    }]
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit("chip_smoke: a kernel of the path never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
