"""Shared small utilities: the dtype registry (the counterpart of
`mxnet_tpu/util.py`).

The reference's mshadow dtype enum (`include/mxnet/tensor_blob.h`
`type_flag_`) keyed by numpy dtypes, with the int codes kept for
checkpoint compatibility (`src/ndarray/ndarray.cc:1571` save format).
bfloat16, which numpy lacks, is ``torch.bfloat16`` here (the JAX package
keys it by ``ml_dtypes.bfloat16``); its code is 100 in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_np", "dtype_name", "DTYPE_TO_ID", "ID_TO_DTYPE"]

# mshadow type_flag values (reference 3rdparty/mshadow base.h enum)
DTYPE_TO_ID = {
    np.dtype("float32"): 0,
    np.dtype("float64"): 1,
    np.dtype("float16"): 2,
    np.dtype("uint8"): 3,
    np.dtype("int32"): 4,
    np.dtype("int8"): 5,
    np.dtype("int64"): 6,
    # extensions outside the reference enum
    np.dtype("bool"): 7,
    torch.bfloat16: 100,
}

ID_TO_DTYPE = {v: k for k, v in DTYPE_TO_ID.items()}

_ALIASES = {
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}


def dtype_np(dtype):
    """Normalize any dtype spec (str, numpy or torch dtype, python type)
    to a numpy dtype; bfloat16 gives ``torch.bfloat16``."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, str):
        dtype = _ALIASES.get(dtype, dtype)
        if dtype == "bfloat16":
            return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        from .base import dtype_np as _torch_to_np
        return _torch_to_np(dtype)
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    d = dtype_np(dtype)
    if d is torch.bfloat16:
        return "bfloat16"
    return d.name

