"""NDArray save/load in MXNet's `.params` binary format, byte-compatible
with `mxnet_tpu/serialization.py` (and so with MXNet): one blob loads in
both packages.

The stream is little-endian::

    uint64 0x112; uint64 reserved
    uint64 ndarray_count; [ndarray blobs]
    uint64 name_count;    [uint64 len + utf8 bytes]

and each ndarray blob (`src/ndarray/ndarray.cc` NDArray::Save)::

    uint32 0xF993FAC9; int32 stype (0 dense, 1 row_sparse, 2 csr)
    [sparse: uint32 ndim; int64 dims of the stored values]
    uint32 ndim; int64 dims; int32 dev_type; int32 dev_id; int32 type_flag
    [sparse: per aux array (csr: indptr, indices; row_sparse: indices)
     int32 type_flag; uint32 ndim; int64 dims]
    raw data bytes; [raw aux bytes, int64]

A blob may end in the JAX package's 24-byte CRC32 footer (`make_footer`),
which `loads_ndarrays` verifies and strips.  The pre-V2 layouts are not
ported.  `atomic_write` is the JAX package's crash-consistent writer
(a temporary file beside the target, fsync, rename, fsync of the
directory); `crc32_file` is the checksum a checkpoint manifest records.
"""
from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from . import fault_injection as _fault
from .base import DTYPE_TO_ID, ID_TO_DTYPE, MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["dumps_ndarrays", "loads_ndarrays", "save_ndarrays",
           "load_ndarrays", "strip_arg_aux", "atomic_write", "read_payload",
           "make_footer", "split_footer", "params_from_numpy",
           "tree_from_numpy", "block_params_from_numpy", "crc32_file",
           "CheckpointCorruptError"]

_LIST_MAGIC = 0x112
_ND_MAGIC_V2 = 0xF993FAC9
# the reference's storage-type enum (`include/mxnet/ndarray.h:62`)
_STYPE_DENSE, _STYPE_RSP, _STYPE_CSR = 0, 1, 2

FOOTER_MAGIC = b"MXTPCKF1"
FOOTER_VERSION = 1
_FOOTER_STRUCT = struct.Struct("<QII")          # payload_len, crc32, version
FOOTER_SIZE = _FOOTER_STRUCT.size + len(FOOTER_MAGIC)


class CheckpointCorruptError(MXNetError):
    """A blob failed its footer check (torn write, bit rot, truncation)."""

    def __init__(self, what, offset, expected, actual, kind="checksum"):
        self.what = what
        self.offset = int(offset)
        self.expected = expected
        self.actual = actual
        self.kind = kind
        super().__init__(
            f"corrupt checkpoint {what}: {kind} mismatch at offset "
            f"{offset}: expected {expected!r}, actual {actual!r}")


def make_footer(payload) -> bytes:
    """The 24-byte versioned footer for ``payload``, appended past the
    legacy stream so that readers without footers never see it."""
    return _FOOTER_STRUCT.pack(len(payload),
                               zlib.crc32(payload) & 0xFFFFFFFF,
                               FOOTER_VERSION) + FOOTER_MAGIC


def split_footer(raw: bytes, what: str = "<memory>"):
    """Verify and strip a footer: ``(payload, footer_dict_or_None)``.  No
    trailing magic means a legacy blob, returned unchanged."""
    if len(raw) < FOOTER_SIZE or raw[-len(FOOTER_MAGIC):] != FOOTER_MAGIC:
        return raw, None
    foot_off = len(raw) - FOOTER_SIZE
    payload_len, crc, version = _FOOTER_STRUCT.unpack_from(raw, foot_off)
    if version > FOOTER_VERSION:
        raise CheckpointCorruptError(what, foot_off, FOOTER_VERSION,
                                     version, kind="footer version")
    if payload_len != foot_off:
        raise CheckpointCorruptError(what, foot_off, payload_len, foot_off,
                                     kind="payload length")
    actual = zlib.crc32(raw[:foot_off]) & 0xFFFFFFFF
    if actual != crc:
        raise CheckpointCorruptError(what, foot_off, f"crc32=0x{crc:08x}",
                                     f"crc32=0x{actual:08x}")
    return raw[:foot_off], {"payload_len": payload_len, "crc32": crc,
                            "version": version}


def _need(view, off, nbytes, what):
    """Every read of the stream is bounds-checked: a truncated blob fails
    with its offset instead of a short read."""
    if off < 0 or off + nbytes > len(view):
        raise MXNetError(
            f"truncated NDArray file {what} at offset {off}: need "
            f"{nbytes} bytes, have {max(0, len(view) - off)}")


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _write_shape(buf: bytearray, shape):
    buf += struct.pack("<I", len(shape))
    for d in shape:
        buf += struct.pack("<q", int(d))


def _write_ndarray(buf: bytearray, arr: NDArray):
    stype = arr.stype
    if stype == "csr":
        data = arr._sp_data
        aux = [arr._sp_indptr.to(torch.int64), arr._sp_indices.to(torch.int64)]
    elif stype == "row_sparse":
        data = arr._sp_data
        aux = [arr._sp_indices.to(torch.int64)]
    else:
        data, aux = arr.data, []
    if data.dtype not in DTYPE_TO_ID:
        raise MXNetError(f"cannot serialize dtype {data.dtype}")
    buf += struct.pack("<Ii", _ND_MAGIC_V2,
                       {"csr": _STYPE_CSR, "row_sparse": _STYPE_RSP}.get(
                           stype, _STYPE_DENSE))
    if aux:
        _write_shape(buf, data.shape)                # the stored values
    _write_shape(buf, arr.shape)
    buf += struct.pack("<ii", 1, 0)                  # saved from cpu(0)
    buf += struct.pack("<i", DTYPE_TO_ID[data.dtype])
    for a in aux:
        buf += struct.pack("<i", DTYPE_TO_ID[a.dtype])
        _write_shape(buf, a.shape)
    buf += _tensor_bytes(data)
    for a in aux:
        buf += _tensor_bytes(a)


def _read_shape(view, off, what):
    _need(view, off, 4, what)
    (ndim,) = struct.unpack_from("<I", view, off)
    off += 4
    _need(view, off, 8 * ndim, what)
    shape = struct.unpack_from(f"<{ndim}q", view, off) if ndim else ()
    if any(d < 0 for d in shape):
        raise MXNetError(f"truncated NDArray file {what} at offset {off}: "
                         f"negative dimension in shape {tuple(shape)}")
    return tuple(shape), off + 8 * ndim


def _read_dtype(view, off, what):
    _need(view, off, 4, what)
    (type_flag,) = struct.unpack_from("<i", view, off)
    if type_flag not in ID_TO_DTYPE:
        raise MXNetError(f"truncated NDArray file {what} at offset {off}: "
                         f"unknown dtype id {type_flag}")
    return ID_TO_DTYPE[type_flag], off + 4


def _read_tensor(view, off, shape, dtype, what):
    count = 1
    for d in shape:
        count *= int(d)
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    _need(view, off, nbytes, what)
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype), off
    raw = np.frombuffer(view, dtype=np.uint8, count=nbytes, offset=off)
    return torch.from_numpy(raw.copy()).view(dtype).reshape(shape), \
        off + nbytes


def _read_ndarray(view: memoryview, off: int, what: str):
    _need(view, off, 8, what)
    magic, stype = struct.unpack_from("<Ii", view, off)
    off += 8
    if magic != _ND_MAGIC_V2:
        raise MXNetError(f"NDArray file {what} at offset {off - 8}: only "
                         "the V2 layout is read here")
    # aux arrays per storage type; -1 (old revisions of the JAX package)
    # loads as dense, like the reference's kUndefinedStorage
    n_aux = {_STYPE_RSP: 1, _STYPE_CSR: 2}.get(stype, 0)
    if stype not in (_STYPE_DENSE, -1) and not n_aux:
        raise MXNetError(f"NDArray file {what} at offset {off - 4}: "
                         f"unknown storage type {stype}")
    sshape = None
    if n_aux:
        sshape, off = _read_shape(view, off, what)
    shape, off = _read_shape(view, off, what)
    _need(view, off, 8, what)
    off += 8                                         # dev_type, dev_id
    dtype, off = _read_dtype(view, off, what)
    if not n_aux:
        t, off = _read_tensor(view, off, shape, dtype, what)
        return NDArray(t), off
    aux_meta = []
    for _ in range(n_aux):
        adtype, off = _read_dtype(view, off, what)
        ashape, off = _read_shape(view, off, what)
        aux_meta.append((adtype, ashape))
    data, off = _read_tensor(view, off, sshape, dtype, what)
    auxs = []
    for adtype, ashape in aux_meta:
        a, off = _read_tensor(view, off, ashape, adtype, what)
        auxs.append(a)
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    if stype == _STYPE_CSR:
        indptr, indices = auxs
        return CSRNDArray(data, indices, indptr, shape), off
    return RowSparseNDArray(data, auxs[0], shape), off


def dumps_ndarrays(data: Union[NDArray, Sequence[NDArray],
                               Mapping[str, NDArray]]) -> bytes:
    """Encode the `.params` payload (no footer), byte for byte what the
    JAX package and MXNet write."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, Mapping):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    for a in arrays:
        if not isinstance(a, NDArray):
            raise MXNetError("save expects NDArrays")
    buf = bytearray()
    buf += struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays))
    for a in arrays:
        _write_ndarray(buf, a)
    buf += struct.pack("<Q", len(names))
    for n in names:
        raw = n.encode("utf-8")
        buf += struct.pack("<Q", len(raw))
        buf += raw
    return bytes(buf)


def loads_ndarrays(raw: bytes, what: str = "<memory>"
                   ) -> Union[List[NDArray], Dict[str, NDArray]]:
    """Parse a `.params` blob (footer verified and stripped when present);
    a dict when the blob carries names, else a list.  Arrays land on the
    CPU."""
    raw, _ = split_footer(bytes(raw), what=what)
    view = memoryview(raw)
    _need(view, 0, 24, what)
    magic, _, count = struct.unpack_from("<QQQ", view, 0)
    if magic != _LIST_MAGIC:
        raise MXNetError(f"invalid NDArray data {what}")
    off = 24
    arrays: List[NDArray] = []
    for _ in range(count):
        arr, off = _read_ndarray(view, off, what)
        arrays.append(arr)
    _need(view, off, 8, what)
    (name_count,) = struct.unpack_from("<Q", view, off)
    off += 8
    names = []
    for _ in range(name_count):
        _need(view, off, 8, what)
        (ln,) = struct.unpack_from("<Q", view, off)
        off += 8
        _need(view, off, ln, what)
        names.append(bytes(view[off:off + ln]).decode("utf-8"))
        off += ln
    if names:
        return dict(zip(names, arrays))
    return arrays


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      ctx: Context) -> Dict[str, NDArray]:
    """Carry parameters across as numpy arrays (for example the JAX
    package's ``{name: nd.asnumpy()}``): the port's NDArrays on ``ctx``,
    dtypes kept."""
    return {name: NDArray(torch.tensor(np.ascontiguousarray(a),
                                       device=ctx.device))
            for name, a in arrays.items()}


def tree_from_numpy(tree, device=None, requires_grad: bool = False):
    """A tree of numpy arrays (dicts, lists, tuples, NamedTuples: the ring
    LM's parameter dict, stage-stacked pipeline parameters, `MoEParams`)
    as the same tree of tensors on ``device`` (a torch device or a
    Context), dtypes kept; ``requires_grad`` marks the floating leaves."""
    dev = getattr(device, "device", device)

    def conv(a):
        t = torch.tensor(np.ascontiguousarray(a), device=dev)
        return t.requires_grad_(True) if requires_grad and \
            t.is_floating_point() else t

    if isinstance(tree, dict):
        return type(tree)((k, tree_from_numpy(v, device, requires_grad))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_from_numpy(v, device, requires_grad)
                            for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device, requires_grad)
                          for v in tree)
    return conv(tree)


def block_params_from_numpy(block, arrays: Mapping[str, np.ndarray]):
    """Write ``{parameter name: numpy array}`` into a Gluon block's
    initialized parameters (a block `SPMDTrainer` then trains); returns
    the block.  Every name must be one of the block's."""
    params = block.collect_params()
    for name, a in arrays.items():
        params[name].set_data(np.array(a))   # a writable copy
    return block


def _fsync_dir(dirname: str) -> None:
    """Persist a rename (the directory entry); best effort, since some
    file systems refuse to fsync a directory."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(fname: str, payload, checksum: bool = True) -> str:
    """Write ``payload`` (with the CRC32 footer when ``checksum``) so that a
    crash at any instant leaves the old file or the new one whole: a
    temporary file beside ``fname``, fsync, `os.replace`, fsync of the
    directory (the JAX package's order).  Returns ``fname``.

    Consults the active `fault_injection.FilePlan` at the JAX package's
    four points (tests): an injected crash (`InjectedCrash`) leaves the
    temporary file behind exactly as a real death between write and rename
    would.  An ``OSError`` (a failed write, fsync or rename, injected or
    genuine) removes the temporary file before it propagates."""
    payload = bytes(payload)
    blob = payload + make_footer(payload) if checksum else payload
    dirname = os.path.dirname(os.path.abspath(fname)) or "."
    plan = _fault.file_active()
    n = plan.write_begin(fname) if plan is not None else 0
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(fname) + ".tmp.",
                               dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            if plan is not None:
                plan.on_fsync(n)             # may raise an injected OSError
            os.fsync(f.fileno())
        if plan is not None:
            plan.on_pre_rename(n)            # may raise InjectedCrash
        os.replace(tmp, fname)
    except OSError:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(dirname)
    if plan is not None:
        plan.on_committed(n, fname)          # may corrupt the final file
    return fname


def crc32_file(fname: str, chunk: int = 1 << 20) -> int:
    """CRC32 of a file's whole contents, streamed (what a checkpoint
    manifest records for each member file)."""
    crc = 0
    with open(fname, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def read_payload(fname: str) -> bytes:
    """A file written by `atomic_write`, its footer verified and
    stripped."""
    with open(fname, "rb") as f:
        raw = f.read()
    return split_footer(raw, what=fname)[0]


def save_ndarrays(fname: str, data) -> None:
    """Reference `mx.nd.save`: the `.params` stream, with the footer."""
    atomic_write(fname, dumps_ndarrays(data), checksum=True)


def load_ndarrays(fname: str):
    """Reference `mx.nd.load`: a dict when names were saved, else a
    list; arrays land on the CPU."""
    with open(fname, "rb") as f:
        return loads_ndarrays(f.read(), what=fname)


def strip_arg_aux(loaded):
    """``(name -> array, had_prefixes)``: `export` files key by
    ``arg:``/``aux:``-prefixed names, plain saves by bare ones."""
    had = any(k.startswith(("arg:", "aux:")) for k in loaded)
    if not had:
        return dict(loaded), False
    return {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in loaded.items()}, True
