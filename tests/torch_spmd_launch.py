"""Start a group of gloo ranks of `tests/torch_spmd_worker.py` through
``tools/launch.py --launcher local`` and read back their results (the
SPMD plane's multi-rank CPU parity tests share it: one launch a file)."""
import os
import subprocess
import sys
import tempfile

import numpy as np

from test_torch_dist_multiprocess import free_port_pair

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_suite(suite: str, n: int, timeout: int = 240):
    """Each rank's results of ``suite`` over ``n`` ranks: a list of
    dicts of numpy arrays, by rank."""
    out = tempfile.mkdtemp(prefix=f"mxtpu_spmd_{suite}_")
    env = dict(os.environ)
    env["DMLC_PS_ROOT_PORT"] = str(free_port_pair())
    env.pop("MXTPU_SPMD", None)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "launch.py"),
         "-n", str(n), "--launcher", "local", "--",
         sys.executable, "-u",
         os.path.join(_REPO, "tests", "torch_spmd_worker.py"), suite, out],
        env=env, capture_output=True, text=True, timeout=timeout)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-6000:]
    assert text.count(f"{suite} DONE") == n, text[-6000:]
    results = []
    for rank in range(n):
        with np.load(os.path.join(out, f"{suite}-{rank}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results



def run_ranks(script: str, suite: str, worlds, timeout: int = 240):
    """Start one group of ranks of ``tests/SCRIPT`` per entry of ``worlds``
    (its size), all at once, each rank with the launcher's ``DMLC_*`` env
    (as ``tools/launch.py --launcher local`` sets it) and its group's
    index as a third argument, for suites in which ranks are lost on
    purpose: a rank that stopped itself (an injected hang) is killed once
    every other rank has exited.  Returns (each group's exit codes by
    rank, each group's results by rank, None for a rank that wrote none,
    and the output)."""
    import signal
    import time
    from mxnet_tpu_torch.parallel.elastic_mesh import _process_state
    out = tempfile.mkdtemp(prefix=f"mxtpu_ranks_{suite}_")
    procs, logs = [], []
    for w, n in enumerate(worlds):
        port = free_port_pair()
        for rank in range(n):
            env = dict(os.environ)
            env.update(DMLC_ROLE="worker", DMLC_PS_ROOT_URI="127.0.0.1",
                       DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER=str(n),
                       DMLC_NUM_SERVER="0", DMLC_WORKER_ID=str(rank),
                       OMP_NUM_THREADS="1")
            env.pop("MXTPU_SPMD", None)
            log = open(os.path.join(out, f"w{w}-rank{rank}.log"), "w+")
            logs.append((w, rank, log))
            procs.append(subprocess.Popen(
                [sys.executable, "-u",
                 os.path.join(_REPO, "tests", script), suite, out, str(w)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            live = [p for p in procs if p.poll() is None]
            if not live:
                break
            if all(_process_state(p.pid) == "T" for p in live):
                for p in live:
                    p.send_signal(signal.SIGKILL)
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = ""
    for w, rank, log in logs:
        log.seek(0)
        text += f"--- group {w} rank {rank}\n" + log.read()[-3000:]
        log.close()
    codes, results, k = [], [], 0
    for w, n in enumerate(worlds):
        codes.append([p.returncode for p in procs[k:k + n]])
        k += n
        group = []
        for rank in range(n):
            path = os.path.join(out, f"{suite}-w{w}-{rank}.npz")
            if os.path.exists(path):
                with np.load(path) as f:
                    group.append({key: f[key] for key in f.files})
            else:
                group.append(None)
        results.append(group)
    return codes, results, text
