"""Zero-pickle wire format v2 (the counterpart of `mxnet_tpu/ps_wire.py`,
byte for byte: a frame one package encodes, the other decodes, so a
`ServeClient` of either package talks to a `ModelServer` of the other).

The frame BODY is a fixed struct encoding -- magic + version, then a
tagged value tree whose tensor leaves are `(dtype, ndim, shape, raw
bytes)` struct headers followed by the buffer itself, the `ps-lite`
KVPairs shape (keys/lens/vals) the reference ships over ZMQ.  Nothing on
the wire is pickled; an opaque payload travels as tagged raw bytes whose
content the receiver hands on unchanged.

The codec is a closed tagged union -- exactly the vocabulary the
protocols use, nothing more (no arbitrary object graphs, no code):

====  =========  =======================================================
tag   type       encoding after the tag byte
====  =========  =======================================================
0x00  None       --
0x01  False      --
0x02  True       --
0x03  int        ``<q``
0x04  float      ``<d``
0x05  str        ``<I`` byte length + UTF-8
0x06  bytes      ``<I`` length + raw
0x07  ndarray    ``<B`` dtype-name length + ASCII dtype name, ``<B``
                 ndim, ndim x ``<I`` dims, ``<Q`` nbytes + raw C-order
                 buffer (native endianness -- both ends of a link run
                 the same build, as with ps-lite)
0x08  list       ``<I`` count + values
0x09  tuple      ``<I`` count + values
0x0A  dict       ``<I`` count + (key value)*
====  =========  =======================================================

Every frame body begins with ``MAGIC`` (``b"MXW2"``); a body that does
not is a protocol desync (or a v1 peer) and decodes to
:class:`WireError`, which subclasses ``ConnectionError`` so both ends
treat it exactly like a poisoned socket: the server drops the
connection, the client discards it and replays the request.  All reads
are bounds-checked -- a truncated or corrupt frame can never index past
the buffer.  Pure numpy and sockets: no tensor of the port crosses here.
"""
from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np

__all__ = ["encode", "decode", "WireError", "MAGIC",
           "send_frame", "recv_frame", "recv_exact", "LEN_PREFIX",
           "MAX_FRAME_BYTES", "SERVE_OPS", "ok_frame", "err_frame"]

MAGIC = b"MXW2"

# The serving-plane request vocabulary riding this framing (the
# ModelServer front door):
#
#   ("ping",)                                  liveness probe -> ("pong",)
#   ("stats",)                                 counters + metrics + model
#                                              version/CRC/queue depth
#   ("infer", req_id, {name: arr}[, ctx])      micro-batched inference
#   ("generate", req_id,                       continuous-batched decode
#             {"prompt": int32 arr,            (generation.py slot arena);
#              "max_new_tokens": n}[, ctx])    ok payload {"tokens": arr,
#                                              "ttft_ms": f}
#   ("drain", req_id[, timeout_s])             stop admitting rows, flush
#                                              queued ones (bounded)
#   ("resume", req_id)                         end a drain
#   ("deploy", req_id, {"path","version"})     hot-swap the served model
#   ("rollback", req_id)                       router only: previous
#                                              registry version back
#
# Replies are ("ok", req_id, payload) / ("err", req_id, kind, detail,
# info) built by :func:`ok_frame` / :func:`err_frame`, so every error a
# peer sees is structured the same way.
SERVE_OPS = frozenset({"ping", "stats", "infer", "generate", "drain",
                       "resume", "deploy", "rollback"})


def ok_frame(req_id, payload=None) -> tuple:
    """A structured success reply for the non-infer serving ops."""
    return ("ok", req_id, payload)


def err_frame(req_id, kind: str, detail, info=None) -> tuple:
    """A structured error reply: ``kind`` is the machine-readable class
    ("overload", "draining", "drain_timeout", "deploy_failed",
    "no_healthy_replica", "bad_request", "internal", ...), ``detail``
    the human message, ``info`` a flat dict of wire-encodable fields."""
    return ("err", req_id, str(kind), str(detail), dict(info or {}))

# One framing convention for every wire-v2 transport (PS plane AND the
# serving front door): a <Q byte-length prefix followed by the encoded
# body.  The length is bounds-checked on receive — a desynced peer whose
# "length" is really payload bytes must raise a WireError, not drive a
# multi-gigabyte allocation.
LEN_PREFIX = struct.Struct("<Q")
MAX_FRAME_BYTES = 1 << 31

_B = struct.Struct("<B")
_I = struct.Struct("<I")
_Q = struct.Struct("<Q")
_q = struct.Struct("<q")
_d = struct.Struct("<d")

_T_NONE, _T_FALSE, _T_TRUE = 0x00, 0x01, 0x02
_T_INT, _T_FLOAT, _T_STR, _T_BYTES = 0x03, 0x04, 0x05, 0x06
_T_NDARRAY, _T_LIST, _T_TUPLE, _T_DICT = 0x07, 0x08, 0x09, 0x0A


class WireError(ConnectionError):
    """Malformed / desynchronized wire-v2 frame.  A ConnectionError on
    purpose: the transport's fault handling (discard socket, reconnect,
    replay) is the correct recovery."""


def _enc_value(out: bytearray, v: Any) -> None:
    if v is None:
        out += _B.pack(_T_NONE)
    elif v is True:
        out += _B.pack(_T_TRUE)
    elif v is False:
        out += _B.pack(_T_FALSE)
    elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        out += _B.pack(_T_INT) + _q.pack(int(v))
    elif isinstance(v, (float, np.floating)):
        out += _B.pack(_T_FLOAT) + _d.pack(float(v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += _B.pack(_T_STR) + _I.pack(len(b)) + b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out += _B.pack(_T_BYTES) + _I.pack(len(b)) + b
    elif isinstance(v, np.ndarray) or isinstance(v, np.generic):
        arr = np.ascontiguousarray(v)
        name = arr.dtype.name.encode("ascii")
        out += _B.pack(_T_NDARRAY) + _B.pack(len(name)) + name
        out += _B.pack(arr.ndim)
        for dim in arr.shape:
            out += _I.pack(int(dim))
        raw = arr.tobytes()
        out += _Q.pack(len(raw)) + raw
    elif isinstance(v, list):
        out += _B.pack(_T_LIST) + _I.pack(len(v))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, tuple):
        out += _B.pack(_T_TUPLE) + _I.pack(len(v))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, dict):
        out += _B.pack(_T_DICT) + _I.pack(len(v))
        for k, item in v.items():
            _enc_value(out, k)
            _enc_value(out, item)
    else:
        raise WireError(
            f"type {type(v).__name__} is not in the PS wire-v2 vocabulary")


def encode(obj: Any) -> bytes:
    """Serialize one protocol message (a tuple tree) to a v2 frame body."""
    out = bytearray(MAGIC)
    _enc_value(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise WireError(
                f"truncated wire-v2 frame: need {n} bytes at offset "
                f"{self.pos}, frame is {len(self.buf)} bytes")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def u8(self) -> int:
        return _B.unpack(self.take(1))[0]

    def u32(self) -> int:
        return _I.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _Q.unpack(self.take(8))[0]


def _dec_value(r: _Reader) -> Any:
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        return _q.unpack(r.take(8))[0]
    if tag == _T_FLOAT:
        return _d.unpack(r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u32()).decode("utf-8")
    if tag == _T_BYTES:
        return r.take(r.u32())
    if tag == _T_NDARRAY:
        name = r.take(r.u8()).decode("ascii")
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise WireError(f"unknown wire-v2 dtype {name!r}") from e
        ndim = r.u8()
        shape = tuple(r.u32() for _ in range(ndim))
        nbytes = r.u64()
        expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if shape else dtype.itemsize
        if nbytes != expect:
            raise WireError(
                f"wire-v2 tensor header inconsistent: shape {shape} "
                f"dtype {name} implies {expect} bytes, frame says {nbytes}")
        raw = r.take(nbytes)
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if tag == _T_LIST:
        return [_dec_value(r) for _ in range(r.u32())]
    if tag == _T_TUPLE:
        return tuple(_dec_value(r) for _ in range(r.u32()))
    if tag == _T_DICT:
        return {_dec_value(r): _dec_value(r) for _ in range(r.u32())}
    raise WireError(f"unknown wire-v2 tag 0x{tag:02x}")


def decode(body: bytes) -> Any:
    """Parse one v2 frame body back into the protocol message."""
    if body[:4] != MAGIC:
        raise WireError(
            "frame does not start with the wire-v2 magic (protocol "
            "desync, or a pre-v2 peer on the other end)")
    r = _Reader(body)
    r.pos = 4
    obj = _dec_value(r)
    if r.pos != len(body):
        raise WireError(
            f"{len(body) - r.pos} trailing bytes after wire-v2 message")
    return obj


# ---------------------------------------------------------------------------
# socket framing (shared by ps_server and serving)
# ---------------------------------------------------------------------------

def send_frame(sock, obj: Any) -> int:
    """Encode ``obj`` as one length-prefixed wire-v2 frame and send it.
    Returns the total bytes put on the wire (for the comm counters)."""
    payload = encode(obj)
    sock.sendall(LEN_PREFIX.pack(len(payload)) + payload)
    return LEN_PREFIX.size + len(payload)


def recv_exact(sock, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes, or None on a clean connection close.
    A close MID-read also returns None — the caller treats any short
    frame as a closed/poisoned connection."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock, max_frame: int = MAX_FRAME_BYTES) -> Any:
    """Receive one length-prefixed frame and decode it.  Returns None on
    a clean close; raises :class:`WireError` on a malformed body or an
    implausible length prefix (both mean protocol desync — the caller
    discards the connection exactly like a poisoned socket)."""
    hdr = recv_exact(sock, LEN_PREFIX.size)
    if hdr is None:
        return None
    (n,) = LEN_PREFIX.unpack(hdr)
    if n > max_frame:
        raise WireError(
            f"frame length prefix {n} exceeds the {max_frame}-byte bound "
            "(protocol desync: mid-stream bytes read as a length)")
    body = recv_exact(sock, n)
    return None if body is None else decode(body)
