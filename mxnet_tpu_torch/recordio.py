"""RecordIO, the splittable binary record format (the counterpart of
`mxnet_tpu/recordio.py`; reference `python/mxnet/recordio.py` and
dmlc-core's `recordio.h`).

The files are byte-identical to the JAX package's and the reference's:
either reads the other's.  Layout per record:
  uint32 magic = 0xced7230a
  uint32 lrec  = (cflag << 29) | length      (cflag: 0 whole, 1 start,
                                              2 middle, 3 end — for records
                                              split across the magic-aligned
                                              chunks)
  data bytes, padded to 4-byte alignment
The indexed variant keeps a text `.idx` of `key\\tbyte-offset` lines.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "scan_record_offsets"]

_kMagic = 0xced7230a


def _pad(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference `recordio.py:MXRecordIO`,
    C++ `dmlc::RecordIOWriter/Reader`)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if not self.is_open:
            self.open()

    def write(self, buf):
        assert self.writable
        if len(buf) >= (1 << 29):
            raise ValueError("RecordIO records must be < 2**29 bytes "
                             "(dmlc recordio.h contract)")
        # dmlc-core's WriteRecord: the record splits at each 4-aligned
        # magic word inside it, whose 4 bytes are dropped (the reader puts
        # them back); only the last chunk needs padding
        magic = struct.pack("<I", _kMagic)
        lower_align = (len(buf) >> 2) << 2
        out = []
        dptr = 0
        i = buf.find(magic, 0, lower_align)
        while i != -1:
            if i % 4 == 0:
                cflag = 1 if dptr == 0 else 2
                out.append(struct.pack("<II", _kMagic,
                                       (cflag << 29) | (i - dptr)))
                out.append(buf[dptr:i])
                dptr = i + 4
                i = buf.find(magic, dptr, lower_align)
            else:
                i = buf.find(magic, i + 1, lower_align)
        cflag = 3 if dptr != 0 else 0
        tail = buf[dptr:]
        out.append(struct.pack("<II", _kMagic, (cflag << 29) | len(tail)))
        out.append(tail)
        out.append(b"\x00" * _pad(len(tail)))
        self.handle.write(b"".join(out))

    def tell(self):
        return self.handle.tell()

    def read(self):
        assert not self.writable
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _kMagic:
            raise IOError(f"invalid RecordIO magic {magic:#x} in {self.uri}")
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        buf = self.handle.read(length)
        self.handle.read(_pad(length))
        if cflag in (0, 3):
            return buf
        # a split record: the magic word goes back between its chunks
        # (dmlc-core's RecordIOReader::NextRecord)
        parts = [buf]
        while cflag in (1, 2):
            parts.append(struct.pack("<I", _kMagic))
            header = self.handle.read(8)
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                raise IOError(
                    f"invalid RecordIO magic {magic:#x} in {self.uri}")
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            parts.append(self.handle.read(length))
            self.handle.read(_pad(length))
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a `.idx` sidecar (reference
    `recordio.py:MXIndexedRecordIO`)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# the header in front of an image record (reference `recordio.py:IRHeader`,
# `src/io/image_recordio.h`)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack (header, payload) into a record string (reference
    `recordio.py:pack`)."""
    header = IRHeader(*header)
    if isinstance(header.label, (np.ndarray, list, tuple)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Unpack a record into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """An image encoded behind its header (reference
    `recordio.py:pack_img`)."""
    from .image import imencode
    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s, iscolor=-1):
    """``(header, HWC uint8 numpy image)`` of a record."""
    header, img_bytes = unpack(s)
    from .image import imdecode
    return header, imdecode(img_bytes, iscolor).asnumpy()


def scan_record_offsets(uri):
    """The byte offset of every record of a ``.rec`` file, read from the
    8-byte chunk headers alone (the payloads are skipped): the index of a
    file without its ``.idx``."""
    with open(uri, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(8)
            if len(header) < 8:
                return
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                raise IOError(f"invalid RecordIO magic {magic:#x} in {uri}")
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            f.seek(length + _pad(length), 1)
            while cflag in (1, 2):  # continuation chunks of this record
                header = f.read(8)
                if len(header) < 8:
                    return
                magic, lrec = struct.unpack("<II", header)
                if magic != _kMagic:
                    raise IOError(
                        f"invalid RecordIO magic {magic:#x} in {uri}")
                cflag = lrec >> 29
                length = lrec & ((1 << 29) - 1)
                f.seek(length + _pad(length), 1)
            yield offset
