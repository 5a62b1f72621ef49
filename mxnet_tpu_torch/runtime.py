"""Runtime feature detection (the counterpart of `mxnet_tpu/runtime.py`;
reference `python/mxnet/runtime.py` + `src/libinfo.cc`): which optional
capabilities this build and host have.

The feature names are the JAX package's; the values are this package's
own: no TPU and no Pallas, CUDA when torch sees a CUDA device, NATIVE_IO
when the host library with its JPEG decoder builds and loads.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    feats = OrderedDict()

    def add(name, enabled):
        feats[name] = Feature(name, bool(enabled))

    add("TPU", False)
    add("CPU", True)
    add("CUDA", torch.cuda.is_available())
    add("BF16", True)
    add("INT64_TENSOR_SIZE", True)
    add("SIGNAL_HANDLER", True)
    add("PROFILER", True)
    add("PALLAS", False)
    add("DIST_KVSTORE", True)
    from . import io_native
    add("NATIVE_IO", io_native.decode_available())
    add("OPENCV", False)
    add("TENSORRT", False)
    add("MKLDNN", False)
    return feats


class Features(OrderedDict):
    """`mx.runtime.Features()` (reference `runtime.py:Features`)."""

    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, name):
        name = name.upper()
        if name not in self:
            raise RuntimeError(f"feature {name!r} unknown")
        return self[name].enabled


def feature_list():
    return list(Features().values())
