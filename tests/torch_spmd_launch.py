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
