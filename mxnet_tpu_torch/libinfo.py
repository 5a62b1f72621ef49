"""Library-info helpers (the counterpart of `mxnet_tpu/libinfo.py`;
reference ``python/mxnet/libinfo.py``).

The reference locates ``libmxnet.so``.  This package's native libraries
are the Hopper kernels `ops/cuda_build.py` compiles into its
``BUILD_DIR`` (``lib<kernel>-<hash>.so``) and the host IO/decode library
`io_native` builds (``host/libmxtpu_io-<hash>.so``): ``find_lib_path``
returns the current builds that exist, so deploy tooling can package
them.
"""
import glob
import os

from .ops import cuda_build

__version__ = "1.3.0"  # parity version: the reference is MXNet ~1.3

__all__ = ["find_lib_path", "find_include_path"]


def _candidates():
    """The library files the checkout's sources build into: one per
    kernel of `cuda_build.KERNELS` (named by the hash of its source), and
    every variant of the host library."""
    kernels = [cuda_build._library_path(n) for n in cuda_build.KERNELS]
    host = os.path.join(cuda_build.BUILD_DIR, "host", "libmxtpu_io-*.so")
    return kernels + sorted(glob.glob(host)) + [host]


def find_lib_path():
    """List of native libraries built for this package.

    Raises RuntimeError with the candidate list if none is there (the
    reference's contract): nothing has been built yet, so run a kernel
    (`cuda_build.build()` on a machine with ``nvcc``) or open a RecordIO
    file (`io_native.ensure_built()`) first.
    """
    candidates = _candidates()
    paths = [p for p in candidates if os.path.isfile(p)]
    if not paths:
        raise RuntimeError('Cannot find the native library.\n'
                           'List of candidates:\n' + '\n'.join(candidates))
    return paths


def find_include_path():
    """The native sources' directory (the reference returns its C API
    include dir; here ``csrc``, which carries the kernels' plain C
    interfaces and the host library's sources)."""
    path = cuda_build.CSRC_DIR
    if os.path.isdir(path):
        return path
    raise RuntimeError('Cannot find the native include path.')
