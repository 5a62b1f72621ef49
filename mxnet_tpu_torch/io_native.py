"""ctypes bindings of the port's native host IO library (the counterpart
of `mxnet_tpu/io_native.py`).

`csrc/host/recordio.cc` and `csrc/host/imagedec.cc` (the port's own copies
of the JAX package's `_native` sources) compile with ``g++`` at first use
into ``build/mxnet_tpu_torch/host/`` beside the checkout, under a name
keyed by the sources and flags, so an edited source never loads stale.
When libjpeg is missing the build is retried with RecordIO alone: the
reader and prefetcher work and `decode_available` is False.  The JAX
package's prebuilt library is never loaded.

`NativeRecordIO` reads and writes the files of `recordio.MXRecordIO`;
`NativePrefetchReader` streams records off a background thread;
`decode_jpeg_batch` decodes a batch to one (n, H, W, C) uint8 array on a
persistent thread pool.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

from .config import get_env

__all__ = ["available", "decode_available", "NativeRecordIO",
           "NativePrefetchReader", "decode_jpeg_batch", "decode_pool_stats",
           "jpeg_dimensions", "lib_path", "ensure_built"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_PKG, "csrc", "host", "recordio.cc"),
         os.path.join(_PKG, "csrc", "host", "imagedec.cc")]
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch",
                         "host")
_BASE = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# the whole library with libjpeg, else RecordIO alone
_VARIANTS = ((_SRCS, ["-ljpeg"]), (_SRCS[:1], []))
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_file: Optional[str] = None
_build_failed = False


def _variant_path(srcs, extra) -> str:
    digest = hashlib.sha256(" ".join(_BASE + extra).encode())
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libmxtpu_io-{digest.hexdigest()[:12]}.so")


def lib_path() -> Optional[str]:
    """The library this process loaded, if any."""
    return _lib_file


def _build(srcs, extra, path) -> bool:
    """Compile one variant into ``path`` through a temporary file, so
    processes that build at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([*_BASE, *srcs, "-o", tmp, *extra], check=True,
                       capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, path)
    return True


def _open() -> Optional[ctypes.CDLL]:
    """The first variant that builds (or was built) and loads here; a
    build of another machine whose libjpeg this one lacks does not load,
    and the next variant is tried."""
    global _lib_file
    for srcs, extra in _VARIANTS:
        path = _variant_path(srcs, extra)
        if not os.path.exists(path) and not _build(srcs, extra, path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        _lib_file = path
        return lib
    return None


def ensure_built() -> bool:
    """Build and load the library; False when no variant compiles (no
    ``g++``)."""
    return _load() is not None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _LOCK:
        if _lib is None and not _build_failed:
            lib = _open()
            if lib is None:
                _build_failed = True
                return None
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.rio_open_reader.restype = ctypes.c_void_p
            lib.rio_open_reader.argtypes = [ctypes.c_char_p]
            lib.rio_read_next.restype = ctypes.c_int
            lib.rio_read_next.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(u8p),
                                          ctypes.POINTER(ctypes.c_int64)]
            lib.rio_read_at.restype = ctypes.c_int
            lib.rio_read_at.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.POINTER(u8p),
                                        ctypes.POINTER(ctypes.c_int64)]
            lib.rio_close_reader.argtypes = [ctypes.c_void_p]
            lib.rio_open_writer.restype = ctypes.c_void_p
            lib.rio_open_writer.argtypes = [ctypes.c_char_p]
            lib.rio_tell.restype = ctypes.c_int64
            lib.rio_tell.argtypes = [ctypes.c_void_p]
            lib.rio_write.restype = ctypes.c_int
            lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64]
            lib.rio_close_writer.argtypes = [ctypes.c_void_p]
            lib.rio_free.argtypes = [u8p]
            lib.rio_prefetcher_create.restype = ctypes.c_void_p
            lib.rio_prefetcher_create.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_int]
            lib.rio_prefetcher_next.restype = ctypes.c_int
            lib.rio_prefetcher_next.argtypes = [ctypes.c_void_p,
                                                ctypes.POINTER(u8p),
                                                ctypes.POINTER(ctypes.c_int64)]
            lib.rio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
            if hasattr(lib, "MXTPUDecodeJpegBatchEx"):  # jpeg-enabled build
                lib.MXTPUDecodeJpegBatchEx.restype = ctypes.c_int
                lib.MXTPUDecodeJpegBatchEx.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                lib.MXTPUDecodePoolThreads.restype = ctypes.c_int
                lib.MXTPUDecodePoolThreads.argtypes = []
                lib.MXTPUDecodePoolBatches.restype = ctypes.c_long
                lib.MXTPUDecodePoolBatches.argtypes = []
                lib.MXTPUDecodePoolSpawned.restype = ctypes.c_long
                lib.MXTPUDecodePoolSpawned.argtypes = []
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeRecordIO:
    """Sequential native reader/writer of `recordio.MXRecordIO`'s files."""

    def __init__(self, uri: str, flag: str):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native IO library unavailable")
        self.uri = uri
        self.flag = flag
        if flag == "r":
            self._h = self._lib.rio_open_reader(uri.encode())
        elif flag == "w":
            self._h = self._lib.rio_open_writer(uri.encode())
        else:
            raise ValueError(f"invalid flag {flag!r}")
        if not self._h:
            raise IOError(f"cannot open {uri}")

    def read(self) -> Optional[bytes]:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        rc = self._lib.rio_read_next(self._h, ctypes.byref(buf),
                                     ctypes.byref(n))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(f"RecordIO read error {rc} in {self.uri}")
        try:
            return ctypes.string_at(buf, n.value)
        finally:
            self._lib.rio_free(buf)

    def read_at(self, offset: int) -> bytes:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        rc = self._lib.rio_read_at(self._h, offset, ctypes.byref(buf),
                                   ctypes.byref(n))
        if rc != 0:
            raise IOError(f"RecordIO read_at({offset}) error {rc}")
        try:
            return ctypes.string_at(buf, n.value)
        finally:
            self._lib.rio_free(buf)

    def write(self, data: bytes) -> None:
        rc = self._lib.rio_write(self._h, data, len(data))
        if rc != 0:
            raise IOError("RecordIO write error")

    def tell(self) -> int:
        return int(self._lib.rio_tell(self._h))

    def close(self):
        if getattr(self, "_h", None):
            if self.flag == "r":
                self._lib.rio_close_reader(self._h)
            else:
                self._lib.rio_close_writer(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePrefetchReader:
    """Records streamed off a background thread (reference
    `iter_prefetcher.h`'s double buffering)."""

    def __init__(self, uri: str, capacity: int = 64):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native IO library unavailable")
        self._h = self._lib.rio_prefetcher_create(uri.encode(), capacity)
        if not self._h:
            raise IOError(f"cannot open {uri}")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        rc = self._lib.rio_prefetcher_next(self._h, ctypes.byref(buf),
                                           ctypes.byref(n))
        if rc == 1:
            raise StopIteration
        if rc < 0:
            raise IOError(f"RecordIO stream error {rc} (corrupt or "
                          "truncated file)")
        try:
            return ctypes.string_at(buf, n.value)
        finally:
            self._lib.rio_free(buf)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rio_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_jpeg_batch(bufs, out_h: int, out_w: int, channels: int = 3,
                      nthreads: int = 0, fast: Optional[bool] = None,
                      out=None):
    """Decode and resize JPEGs into one (n, H, W, C) uint8 array on the
    library's persistent thread pool (reference
    `iter_image_recordio_2.cc:799`).  ``fast=None`` reads
    ``MXTPU_FAST_DECODE`` (on: the IFAST DCT and plain chroma upsampling,
    about 1 LSB of luma error); ``fast=False`` decodes exactly (ISLOW).
    ``out`` is a caller's C-contiguous uint8 buffer of that shape (a
    pinned staging buffer, say); a failed decode leaves its slot as it
    was and is flagged.  Returns ``(batch, ok mask)``."""
    import numpy as np
    lib = _load()
    if lib is None or not hasattr(lib, "MXTPUDecodeJpegBatchEx"):
        raise RuntimeError("native JPEG decoder unavailable "
                           "(libjpeg missing at build time)")
    if fast is None:
        fast = bool(get_env("MXTPU_FAST_DECODE"))
    n = len(bufs)
    shape = (n, out_h, out_w, channels)
    if out is None:
        out = np.zeros(shape, np.uint8)
    elif (out.shape != shape or out.dtype != np.uint8
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"out must be a C-contiguous uint8 array of shape {shape}")
    if n == 0:
        return out, np.zeros((0,), bool)
    keep = [bytes(b) for b in bufs]  # alive while native code reads them
    arr = (ctypes.c_char_p * n)(*keep)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in keep])
    errs = (ctypes.c_int * n)()
    lib.MXTPUDecodeJpegBatchEx(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n,
        out_h, out_w, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nthreads, 1 if fast else 0, errs)
    ok = np.array([errs[i] == 0 for i in range(n)])
    return out, ok


def decode_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "MXTPUDecodeJpegBatchEx")


def decode_pool_stats() -> dict:
    """The decode pool's ``threads`` (workers alive), ``batches`` (served)
    and ``spawned`` (threads ever made: flat while ``batches`` grows)."""
    lib = _load()
    if lib is None or not hasattr(lib, "MXTPUDecodePoolThreads"):
        raise RuntimeError("native JPEG decoder unavailable")
    return {"threads": int(lib.MXTPUDecodePoolThreads()),
            "batches": int(lib.MXTPUDecodePoolBatches()),
            "spawned": int(lib.MXTPUDecodePoolSpawned())}


def jpeg_dimensions(buf) -> Optional[tuple]:
    """``(height, width)`` from a JPEG's SOF marker, without decoding it;
    None for bytes that are not a JPEG."""
    data = bytes(buf)
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                      0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return (h, w)
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = (data[i + 2] << 8) | data[i + 3]
        i += 2 + seg_len
    return None
