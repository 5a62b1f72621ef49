#!/usr/bin/env python3
"""Where `chip_smoke.py` phase 12c's fp32 DCGAN iteration leaves float64:
each cuDNN setting below runs in a process of its own (cuDNN's plans are
cached per process), and there

* runs the phase's check (`chip_smoke.dcgan_check`: MXNet's DCGAN at its
  published widths, one G/D iteration from the phase's seeded weights,
  noise and images) twice, printing the error of all gradients together
  and of D's and G's apart, relative to their norm, against the float64
  iteration on the fp32 iteration's ReLU and LeakyReLU branches
  ("pinned") and against the float64 iteration on its own ("unpinned"),
  and how many activation calls had an element switch branch, and how
  near zero the farthest such element lay;
* runs each of DCGAN's ten convolutions alone at its shape in the
  iteration (batch 64), forward and backward, in fp32 against the same
  convolution in float64 without cuDNN, printing each output's and
  gradient's error relative to its norm and the kernels that ran, by name,
  from a `torch.profiler` trace.

Run from the repository root on one NVIDIA Hopper card:
``python3 tools/torch_dcgan_diag.py`` (about 4 minutes); each record is
also written to ``chiprun_out/dcgan_diag.jsonl``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name: (cudnn flags, environment)
MODES = {
    "default": ({}, {}),
    "default, another process": ({}, {}),
    "benchmark": ({"benchmark": True}, {}),
    "deterministic": ({"deterministic": True}, {}),
    "deterministic + benchmark": ({"deterministic": True,
                                   "benchmark": True}, {}),
    "NVIDIA_TF32_OVERRIDE=0": ({}, {"NVIDIA_TF32_OVERRIDE": "0"}),
    "NVIDIA_TF32_OVERRIDE=0 + benchmark": ({"benchmark": True},
                                           {"NVIDIA_TF32_OVERRIDE": "0"}),
    "cudnn off": ({"enabled": False}, {}),
}
# (name, transposed, in channels, out channels, input side, stride, pad)
LAYERS = [("g1", True, 100, 512, 1, 1, 0), ("g2", True, 512, 256, 4, 2, 1),
          ("g3", True, 256, 128, 8, 2, 1), ("g4", True, 128, 64, 16, 2, 1),
          ("g5", True, 64, 3, 32, 2, 1), ("d1", False, 3, 64, 64, 2, 1),
          ("d2", False, 64, 128, 32, 2, 1), ("d3", False, 128, 256, 16, 2, 1),
          ("d4", False, 256, 512, 8, 2, 1), ("d5", False, 512, 1, 4, 1, 0)]
BATCH = 64
OUT = os.path.join(HERE, "chiprun_out", "dcgan_diag.jsonl")


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _conv(transposed, x, w, stride, pad):
    if transposed:
        return F.conv_transpose2d(x, w, None, stride, pad)
    return F.conv2d(x, w, None, stride, pad)


def _kernels(fn):
    """The names of the device kernels ``fn`` launched, with their counts."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            names[ev.name[:110]] = names.get(ev.name[:110], 0) + 1
    return names


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return {"norm": float((a - b).norm() / b.norm()),
            "elem": float((a - b).abs().max() / b.abs().max())}


def layer_sweep(mode):
    rs = np.random.RandomState(5)
    for name, transposed, cin, cout, side, stride, pad in LAYERS:
        x64 = torch.tensor(rs.randn(BATCH, cin, side, side))
        wshape = (cin, cout, 4, 4) if transposed else (cout, cin, 4, 4)
        w64 = torch.tensor(rs.randn(*wshape) * 0.02)
        out_side = ((side - 1) * stride - 2 * pad + 4 if transposed
                    else (side + 2 * pad - 4) // stride + 1)
        dy64 = torch.tensor(rs.randn(BATCH, cout, out_side, out_side))
        res = {}
        for tag, dt in (("fp32", torch.float32), ("float64", torch.float64)):
            x = x64.to("cuda", dt).requires_grad_()
            w = w64.to("cuda", dt).requires_grad_()
            dy = dy64.to("cuda", dt)
            with torch.backends.cudnn.flags(
                    enabled=tag == "fp32" and
                    torch.backends.cudnn.enabled,
                    benchmark=torch.backends.cudnn.benchmark,
                    deterministic=torch.backends.cudnn.deterministic,
                    allow_tf32=False):
                y = _conv(transposed, x, w, stride, pad)
                y.backward(dy)
                torch.cuda.synchronize()
                res[tag] = (y.detach(), x.grad, w.grad)
                if tag == "fp32":
                    fwd = _kernels(lambda: _conv(transposed, x.detach(),
                                                 w.detach(), stride, pad))
                    y2 = _conv(transposed, x, w, stride, pad)
                    bwd = _kernels(lambda: torch.autograd.grad(
                        y2, (x, w), dy))
        (y32, dx32, dw32), (y64, dx64, dw64) = res["fp32"], res["float64"]
        emit({"diag": "layer", "mode": mode, "layer": name,
              "y": _rel(y32, y64), "dx": _rel(dx32, dx64),
              "dw": _rel(dw32, dw64), "forward_kernels": fwd,
              "backward_kernels": bwd})


def child(mode):
    import chip_smoke as cs
    flags, _ = MODES[mode]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = flags.get("enabled", True)
    torch.backends.cudnn.benchmark = flags.get("benchmark", False)
    torch.backends.cudnn.deterministic = flags.get("deterministic", False)
    cs.DCGAN_GRAD_TOL = cs.DCGAN_SWITCH_TOL = float("inf")  # never stop
    conv = getattr(torch.backends.cudnn, "conv", None)
    emit({"diag": "process", "mode": mode, "torch": torch.__version__,
          "cudnn": torch.backends.cudnn.version(),
          "conv_fp32_precision": getattr(conv, "fp32_precision", None),
          "env_tf32_override": os.environ.get("NVIDIA_TF32_OVERRIDE")})
    for i in range(2):
        rec = cs.dcgan_check()
        emit({"diag": "check", "mode": mode, "call": i,
              **{k: rec[k] for k in (
                  "grad_norm_err", "grad_norm_err_by_net",
                  "grad_elementwise_err", "unpinned_grad_norm_err",
                  "unpinned_by_net", "switched_calls", "branch_calls",
                  "switch_worst")}})
    layer_sweep(mode)


def main():
    if len(sys.argv) > 1:
        child(sys.argv[1])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    emit({"diag": "card", "card": smi.stdout.strip()})
    for mode, (_, env) in MODES.items():
        subprocess.run([sys.executable, os.path.abspath(__file__), mode],
                       env={**os.environ, **env}, check=True, timeout=600)


if __name__ == "__main__":
    main()
