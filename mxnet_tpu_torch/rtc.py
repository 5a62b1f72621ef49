"""Runtime kernel compilation (the counterpart of `mxnet_tpu/rtc.py`;
reference `python/mxnet/rtc.py`: `CudaModule` compiles CUDA source via
NVRTC, `src/common/rtc.cc:35-69`).

`CudaModule(source, options=(), exports=())` is MXNet's own contract on
this card: the source is compiled at run time by NVRTC (``libnvrtc`` of
the CUDA toolkit `ops/cuda_build.py` finds) for the card's architecture
(``sm_90a`` on Hopper) into a CUBIN, loaded with the driver API
(``cuModuleLoadData`` from ``libcuda.so.1``) once per device, and
``get_kernel(name, signature)`` gives a kernel whose ``launch`` checks
each argument against MXNet's C signature string and launches on torch's
current stream, so a following torch op sees its writes without a
synchronize.  Templated kernels are named through ``exports``
(``nvrtcAddNameExpression``/``nvrtcGetLoweredName``).  Without a CUDA
device it raises `MXNetError`: there is no CPU path.

`PallasModule` keeps the JAX package's contract for kernels written in
Python: it wraps callables (a launcher of a ``@triton.jit`` kernel, or
any function of torch tensors) as launchable ops over NDArrays.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "PallasModule"]

# C argument types of a kernel signature, as MXNet's rtc reads them
_DTYPE_CPP_TO_NP = {
    "float": np.float32, "double": np.float64, "__half": np.float16,
    "half": np.float16, "uint8_t": np.uint8, "unsigned char": np.uint8,
    "int": np.int32, "int32_t": np.int32, "int8_t": np.int8,
    "char": np.int8, "int64_t": np.int64, "long long": np.int64,
    "bool": np.bool_,
}
_SCALAR_CTYPES = {
    np.dtype(np.float32): ctypes.c_float, np.dtype(np.float64):
    ctypes.c_double, np.dtype(np.float16): ctypes.c_uint16,
    np.dtype(np.uint8): ctypes.c_uint8, np.dtype(np.int32): ctypes.c_int32,
    np.dtype(np.int8): ctypes.c_int8, np.dtype(np.int64): ctypes.c_int64,
    np.dtype(np.bool_): ctypes.c_bool,
}
_ARG = re.compile(r"^\s*(const\s+)?((?:unsigned\s+|long\s+)?[A-Za-z_]\w*)"
                  r"\s*(\*)?\s*(?:__restrict__\s*)?([A-Za-z_]\w*)?\s*$")
# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_MAX_DYNAMIC_SHARED = 8
_STATIC_SHARED_LIMIT = 48 * 1024

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _cuda_home() -> str:
    from .ops import cuda_build
    try:
        return os.path.dirname(os.path.dirname(
            os.path.realpath(cuda_build._nvcc())))
    except MXNetError:
        return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvrtc() -> ctypes.CDLL:
    """The toolkit's NVRTC, its functions typed."""
    with _LOCK:
        lib = _LIBS.get("nvrtc")
        if lib is not None:
            return lib
        home = _cuda_home()
        dirs = [os.path.join(home, d) for d in
                ("lib64", "lib", os.path.join("targets", "x86_64-linux",
                                              "lib"))]
        cands = [p for d in dirs for p in
                 [os.path.join(d, "libnvrtc.so")] +
                 sorted(glob.glob(os.path.join(d, "libnvrtc.so.*")))]
        errors = []
        for path in cands:
            if not os.path.exists(path):
                continue
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError as e:
                errors.append(f"{path}: {e}")
        else:
            raise MXNetError("rtc: NVRTC (libnvrtc) not found in the CUDA "
                             f"toolkit at {home}; tried {cands} {errors}")
        vp, c = ctypes.c_void_p, ctypes.c_char_p
        pp = ctypes.POINTER(ctypes.c_char_p)
        sz = ctypes.POINTER(ctypes.c_size_t)
        lib.nvrtcGetErrorString.restype = c
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        for name, args in (
                ("nvrtcCreateProgram", [ctypes.POINTER(vp), c, c,
                                        ctypes.c_int, pp, pp]),
                ("nvrtcAddNameExpression", [vp, c]),
                ("nvrtcCompileProgram", [vp, ctypes.c_int, pp]),
                ("nvrtcGetProgramLogSize", [vp, sz]),
                ("nvrtcGetProgramLog", [vp, c]),
                ("nvrtcGetCUBINSize", [vp, sz]),
                ("nvrtcGetCUBIN", [vp, c]),
                ("nvrtcGetLoweredName", [vp, c, pp]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(vp)])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _LIBS["nvrtc"] = lib
        return lib


def _driver() -> ctypes.CDLL:
    """The CUDA driver API, its functions typed."""
    with _LOCK:
        lib = _LIBS.get("cuda")
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"rtc: the CUDA driver (libcuda.so.1) does not "
                             f"load: {e}") from e
        vp, u = ctypes.c_void_p, ctypes.c_uint
        for name, args in (
                ("cuInit", [u]),
                ("cuCtxGetCurrent", [ctypes.POINTER(vp)]),
                ("cuCtxSetCurrent", [vp]),
                ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int]),
                ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(vp),
                                              ctypes.c_int]),
                ("cuModuleLoadData", [ctypes.POINTER(vp), vp]),
                ("cuModuleUnload", [vp]),
                ("cuModuleGetFunction", [ctypes.POINTER(vp), vp,
                                         ctypes.c_char_p]),
                ("cuFuncSetAttribute", [vp, ctypes.c_int, ctypes.c_int]),
                ("cuLaunchKernel", [vp, u, u, u, u, u, u, u, vp,
                                    ctypes.POINTER(vp), ctypes.POINTER(vp)]),
                ("cuGetErrorString", [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _LIBS["cuda"] = lib
        return lib


def _check_nvrtc(lib, err, what, log=""):
    if err != 0:
        msg = lib.nvrtcGetErrorString(err).decode()
        raise MXNetError(f"rtc: {what} failed ({msg})" +
                         (f"\n{log}" if log else ""))


def _check_cu(err, what):
    if err != 0:
        s = ctypes.c_char_p()
        _driver().cuGetErrorString(err, ctypes.byref(s))
        name = s.value.decode() if s.value else f"CUresult {err}"
        raise MXNetError(f"rtc: {what} failed ({name})")


def _require_card(what: str):
    if not torch.cuda.is_available():
        raise MXNetError(f"{what}: no CUDA device is available; runtime "
                         "CUDA kernels compile with NVRTC and run only on "
                         "the card (write a CPU kernel as a Python callable "
                         "and wrap it with rtc.PallasModule)")


def _make_current(device_id: int):
    """Make the device's primary context current on this thread (the one
    torch's runtime uses), retaining it if no context is current."""
    torch.cuda.init()
    drv = _driver()
    _check_cu(drv.cuInit(0), "cuInit")
    cur = ctypes.c_void_p()
    _check_cu(drv.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value is None:
        dev = ctypes.c_int()
        _check_cu(drv.cuDeviceGet(ctypes.byref(dev), device_id),
                  "cuDeviceGet")
        _check_cu(drv.cuDevicePrimaryCtxRetain(ctypes.byref(cur), dev),
                  "cuDevicePrimaryCtxRetain")
        _check_cu(drv.cuCtxSetCurrent(cur), "cuCtxSetCurrent")


class CudaModule:
    """CUDA source compiled at run time (reference `rtc.CudaModule`).

    ``source`` is CUDA C++; ``options`` are NVRTC options (the
    architecture is the card's, ``-arch=sm_90a`` on Hopper);
    ``exports`` name the templated kernels to instantiate, such as
    ``"axpy<float>"``.  A compile error raises `MXNetError` carrying
    NVRTC's log."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        _require_card("rtc.CudaModule")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        major, minor = torch.cuda.get_device_capability(0)
        arch = f"sm_{major}{minor}{'a' if (major, minor) == (9, 0) else ''}"
        self.arch = arch
        self._cubin, self._lowered = self._compile(
            source, [f"--gpu-architecture={arch}", *options], list(exports))
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._mod_lock = threading.Lock()

    @staticmethod
    def _compile(source, options, exports) -> Tuple[bytes, Dict[str, str]]:
        lib = _nvrtc()
        prog = ctypes.c_void_p()
        _check_nvrtc(lib, lib.nvrtcCreateProgram(
            ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None,
            None), "nvrtcCreateProgram")
        try:
            for name in exports:
                _check_nvrtc(lib, lib.nvrtcAddNameExpression(
                    prog, name.encode()), f"exporting {name!r}")
            opts = (ctypes.c_char_p * len(options))(
                *[o.encode() for o in options])
            err = lib.nvrtcCompileProgram(prog, len(options), opts)
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            _check_nvrtc(lib, err, "NVRTC compilation",
                         log.value.decode(errors="replace"))
            _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                         "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for name in exports:
                out = ctypes.c_char_p()
                _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                    prog, name.encode(), ctypes.byref(out)),
                    f"lowering {name!r}")
                lowered[name] = out.value.decode()
            return cubin.raw, lowered
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))

    def _module(self, device_id: int) -> ctypes.c_void_p:
        with self._mod_lock:
            mod = self._modules.get(device_id)
            if mod is None:
                with torch.cuda.device(device_id):
                    _make_current(device_id)
                    mod = ctypes.c_void_p()
                    _check_cu(_driver().cuModuleLoadData(
                        ctypes.byref(mod), self._cubin), "cuModuleLoadData")
                self._modules[device_id] = mod
            return mod

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (a name of ``exports``, or an ``extern "C"``
        function) with its C ``signature``, such as ``"const float *x,
        float *y, float alpha"``."""
        args = []
        for i, arg in enumerate(signature.split(",")):
            m = _ARG.match(arg)
            if not m or m.group(2) == "const":
                raise MXNetError(f"rtc: invalid argument {i} {arg!r} in "
                                 f"signature {signature!r}")
            ctype = " ".join(m.group(2).split())
            if ctype not in _DTYPE_CPP_TO_NP:
                raise MXNetError(
                    f"rtc: unsupported argument type {ctype!r}; supported: "
                    f"{sorted(_DTYPE_CPP_TO_NP)}")
            args.append((bool(m.group(3)), np.dtype(_DTYPE_CPP_TO_NP[ctype]),
                         bool(m.group(1))))
        return CudaKernel(self, self._lowered.get(name, name), name, args)

    def __del__(self):
        mods = getattr(self, "_modules", {})
        lib = _LIBS.get("cuda")
        if lib is not None:
            for mod in mods.values():
                lib.cuModuleUnload(mod)


class CudaKernel:
    """One kernel of a `CudaModule` (reference `rtc.CudaKernel`)."""

    def __init__(self, module: CudaModule, symbol: str, name: str,
                 args: List[Tuple[bool, np.dtype, bool]]):
        self._module = module
        self._symbol = symbol
        self.name = name
        self._args = args
        self._funcs: Dict[int, ctypes.c_void_p] = {}

    def _function(self, device_id: int) -> ctypes.c_void_p:
        fn = self._funcs.get(device_id)
        if fn is None:
            fn = ctypes.c_void_p()
            _check_cu(_driver().cuModuleGetFunction(
                ctypes.byref(fn), self._module._module(device_id),
                self._symbol.encode()), f"finding kernel {self.name!r}")
            self._funcs[device_id] = fn
        return fn

    def launch(self, args: Sequence, ctx, grid_dims, block_dims,
               shared_mem: int = 0):
        """Launch on ``ctx`` (a `gpu` context) with a grid and block of up
        to three dimensions and ``shared_mem`` bytes of dynamic shared
        memory, on torch's current stream of that device."""
        if ctx.device_type != "gpu":
            raise MXNetError(f"rtc: CUDA kernels launch on a gpu context, "
                             f"not {ctx}")
        if len(args) != len(self._args):
            raise MXNetError(f"rtc: kernel {self.name!r} takes "
                             f"{len(self._args)} arguments, got {len(args)}")
        keep = []
        for i, (arg, (is_ptr, dtype, _)) in enumerate(zip(args,
                                                          self._args)):
            if is_ptr:
                if not isinstance(arg, NDArray):
                    raise MXNetError(f"rtc: argument {i} of {self.name!r} "
                                     "is a pointer and takes an NDArray, "
                                     f"not {type(arg).__name__}")
                t = arg.data
                if t.device != ctx.device:
                    raise MXNetError(f"rtc: argument {i} of {self.name!r} "
                                     f"is on {arg.context}, not {ctx}")
                if np.dtype(arg.dtype) != dtype:
                    raise MXNetError(f"rtc: argument {i} of {self.name!r} "
                                     f"is {arg.dtype}, the signature says "
                                     f"{dtype}")
                if not t.is_contiguous():
                    raise MXNetError(f"rtc: argument {i} of {self.name!r} "
                                     "is not contiguous")
                keep.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(arg, NDArray):
                    raise MXNetError(f"rtc: argument {i} of {self.name!r} "
                                     f"is a {dtype} scalar, not an NDArray")
                val = np.asarray(arg, dtype=dtype)
                if dtype == np.float16:
                    val = val.view(np.uint16)
                keep.append(_SCALAR_CTYPES[dtype](val.item()))
        grid = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(block_dims) + (1,) * (3 - len(block_dims))
        params = (ctypes.c_void_p * len(keep))(
            *[ctypes.cast(ctypes.byref(v), ctypes.c_void_p) for v in keep])
        with torch.cuda.device(ctx.device_id):
            fn = self._function(ctx.device_id)
            _make_current(ctx.device_id)
            if shared_mem > _STATIC_SHARED_LIMIT:
                _check_cu(_driver().cuFuncSetAttribute(
                    fn, _MAX_DYNAMIC_SHARED, int(shared_mem)),
                    "cuFuncSetAttribute")
            stream = torch.cuda.current_stream(ctx.device).cuda_stream
            _check_cu(_driver().cuLaunchKernel(
                fn, *[int(g) for g in grid], *[int(b) for b in block],
                int(shared_mem), ctypes.c_void_p(stream), params, None),
                f"launching {self.name!r}")


class PallasModule:
    """Kernels written as Python callables, wrapped as launchable ops over
    NDArrays (the JAX package's `PallasModule`; here a callable may be
    the launcher of a ``@triton.jit`` kernel)."""

    def __init__(self, **kernels: Callable):
        self._kernels = dict(kernels)

    def get_kernel(self, name: str) -> "_Kernel":
        if name not in self._kernels:
            raise MXNetError(f"kernel {name!r} not found")
        return _Kernel(self._kernels[name])


class _Kernel:
    def __init__(self, fn: Callable):
        self._fn = fn

    def launch(self, args: Sequence, ctx=None, grid_dims=None,
               block_dims=None, shared_mem=0):
        """grid and block dims are accepted for CUDA-API parity; a Python
        kernel chooses its own grid.  NDArrays reach the callable as their
        torch tensors, and tensors it returns come back as NDArrays."""
        tensors = [a.data if isinstance(a, NDArray) else a for a in args]
        out = self._fn(*tensors)
        if isinstance(out, tuple):
            return tuple(NDArray(o) for o in out)
        return NDArray(out)
