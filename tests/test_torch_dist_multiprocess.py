"""Real multi-process ``dist_sync`` in the PyTorch port: 2 and 4 workers
spawned through the unchanged `tools/launch.py --launcher local`, joined
into one gloo group by `parallel.distributed.initialize` from the
launcher's ``DMLC_*`` env, each asserting the closed-form arithmetic of
`tests/torch_dist_sync_worker.py` (the counterpart of
`tests/test_dist_multiprocess.py`): push/pull rounds for fp32 and fp16,
dense and row-sparse, the 2-bit path, and `gluon.Trainer` / `Module`
steps over the store equal to one process on the whole batch, and an
`SPMDTrainer` step over the mesh that spans the processes equal to one
process's.
"""
import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port_pair():
    """A port whose successor is free too: the group's store binds the
    first, a parameter server the second (`ps_server.ps_port`)."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s2 = socket.socket()
        try:
            s2.bind(("127.0.0.1", port + 1))
        except OSError:
            s.close()
            continue
        s.close()
        s2.close()
        return port


def _run_dist_sync(nworker: int, timeout: int):
    env = dict(os.environ)
    env["DMLC_PS_ROOT_PORT"] = str(free_port_pair())
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "launch.py"),
         "-n", str(nworker), "--launcher", "local", "--",
         sys.executable, "-u",
         os.path.join(_REPO, "tests", "torch_dist_sync_worker.py")],
        env=env, capture_output=True, text=True, timeout=timeout)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert out.count("ALL PASSED") == nworker, out[-4000:]


def test_dist_sync_two_processes():
    _run_dist_sync(2, timeout=120)


def test_dist_sync_four_processes():
    """n=4 catches rank-indexing and reduction-order bugs invisible at
    n=2; every closed-form assertion scales with the worker count."""
    _run_dist_sync(4, timeout=180)
