"""Gluon utilities (the counterpart of `mxnet_tpu/gluon/utils.py`; reference
`python/mxnet/gluon/utils.py`): splitting a batch across contexts,
global-norm gradient clipping, the SHA-1 file check and `download`,
which serves local paths and ``file://`` URLs and fetches nothing from
the network."""
from __future__ import annotations

import hashlib
import os
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` pieces of ``data`` along ``batch_axis`` (reference
    `utils.py:split_data`); with ``even_split=False`` the pieces differ by
    at most one row and none is empty."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}; set "
            "even_split=False, or adjust the batch size")
    if not even_split and size < num_slice:
        num_slice = size
    if even_split:
        step = size // num_slice
        bounds = [i * step for i in range(num_slice)] + [size]
    else:
        bounds = [int(round(i * size / num_slice))
                  for i in range(num_slice + 1)]
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(bounds[i], bounds[i + 1])
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One piece of ``data`` on each context of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping, summed in float64 as
    the reference sums it on the host."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    with torch.no_grad():
        total = sum((a.data.double() ** 2).sum().to("cpu")
                    for a in arrays)
        norm = float(total.sqrt())
        if check_isfinite and not torch.isfinite(torch.tensor(norm)):
            warnings.warn("nan or inf found in clip_global_norm; clipping "
                          "skipped", stacklevel=2)
            return norm
        scale = max_norm / (norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._set_data((a * scale).data)
    return norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """``url`` copied to ``path`` (reference `utils.py:download`), through
    `test_utils.download`: a local path or a ``file://`` URL; a network
    URL raises."""
    from ..test_utils import download as _dl
    fname = None
    dirname = None
    if path is not None:
        if os.path.isdir(path) or path.endswith(os.sep):
            dirname = path
        else:
            dirname, fname = os.path.split(path)
    out = _dl(url, fname=fname, dirname=dirname or None)
    if sha1_hash and not check_sha1(out, sha1_hash):
        raise MXNetError(f"downloaded file {out} failed sha1 check")
    return out
