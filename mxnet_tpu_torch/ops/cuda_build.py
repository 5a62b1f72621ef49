"""Build and load the hand-written CUDA kernels of ``mxnet_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles, at first use, with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, bound with
`ctypes`.  Libraries go to ``build/mxnet_tpu_torch/`` beside the package
and are named by a hash of their source, the local headers it includes
(``csrc/*.cuh``) and the flags, so an edited source or header never loads
a stale library.  Nothing here runs at import: the CPU tests
import every module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

from ..base import MXNetError

__all__ = ["KERNELS", "BUILD_DIR", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mxnet_tpu_torch")

#: every kernel source, by name (``csrc/<name>.cu``)
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "lstm_gates")

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
# one build at a time in a process: a `load` during a build started on
# another thread waits for it, then finds the library built
_BUILD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (put it on PATH or set CUDA_HOME); "
                         "the Hopper kernels are built from source")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_digest(path: str, seen=None) -> bytes:
    """SHA-1 over a source and, depth first, every local header it
    includes (``#include "..."``, resolved beside the including file), so
    that an edited header changes the digest too.  Each file counts once."""
    seen = set() if seen is None else seen
    path = os.path.realpath(path)
    if path in seen:
        return b""
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    parts = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = os.path.join(os.path.dirname(path), inc.decode())
        if os.path.exists(header):
            parts.append(_source_digest(header, seen))
    return hashlib.sha1(b"\0".join(parts)).digest()


def _library_path(name: str) -> str:
    digest = hashlib.sha1(
        _source_digest(os.path.join(CSRC_DIR, name + ".cu")) +
        " ".join(_NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no current library, all
    ``nvcc`` processes at once.  Returns ``{name: compiler log}`` (the
    ``ptxas -v`` register and shared-memory report; empty when the library
    was already built).  Raises `MXNetError` with the log when one fails."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    logs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            logs[name] = ""
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(_library_path(name))
        return lib
