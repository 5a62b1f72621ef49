"""The port's RecordIO against the JAX package's (`mxnet_tpu/recordio.py`):
the same records give byte-identical ``.rec`` and ``.idx`` files, records
with the magic word inside them (split into chunks) included; each
package reads the other's files, sequentially, by index and through the
other's native reader; `pack`/`unpack` with scalar and vector labels and
`pack_img`/`unpack_img` agree byte for byte and pixel for pixel."""
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import io_native as jnative
from mxnet_tpu_torch import io_native as tnative

MAGIC = struct.pack("<I", 0xced7230a)


def _records():
    rs = np.random.RandomState(0)
    out = [b"", b"a", b"abcd", MAGIC, b"xy" + MAGIC + b"zw" + MAGIC,
           b"1234" + MAGIC + b"5678" + MAGIC * 2 + b"9"]
    out += [rs.bytes(int(n)) for n in rs.randint(1, 300, 20)]
    return out


def _write(pkg, prefix, records):
    rec = pkg.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i, r in enumerate(records):
        rec.write_idx(i, r)
    rec.close()


def _read_all(pkg, path):
    rec = pkg.recordio.MXRecordIO(path, "r")
    out = []
    while True:
        r = rec.read()
        if r is None:
            break
        out.append(r)
    rec.close()
    return out


def test_files_are_byte_identical(tmp_path):
    recs = _records()
    _write(mx, str(tmp_path / "j"), recs)
    _write(mt, str(tmp_path / "t"), recs)
    for ext in (".rec", ".idx"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()


@pytest.mark.parametrize("writer,reader", [(mx, mt), (mt, mx)])
def test_each_reads_the_others_files(tmp_path, writer, reader):
    recs = _records()
    prefix = str(tmp_path / "d")
    _write(writer, prefix, recs)
    assert _read_all(reader, prefix + ".rec") == recs
    idx = reader.recordio.MXIndexedRecordIO(prefix + ".idx",
                                            prefix + ".rec", "r")
    for i in (5, 0, len(recs) - 1, 3):
        assert idx.read_idx(i) == recs[i]
    idx.close()
    offsets = list(reader.recordio.scan_record_offsets(prefix + ".rec"))
    with open(prefix + ".idx") as f:
        assert offsets == [int(line.split("\t")[1]) for line in f]


def test_native_readers_read_the_others_files(tmp_path):
    recs = _records()
    _write(mx, str(tmp_path / "j"), recs)
    _write(mt, str(tmp_path / "t"), recs)
    for native, path in ((tnative, tmp_path / "j.rec"),
                         (jnative, tmp_path / "t.rec")):
        r = native.NativeRecordIO(str(path), "r")
        got = []
        while True:
            x = r.read()
            if x is None:
                break
            got.append(x)
        r.close()
        assert got == recs
        assert list(native.NativePrefetchReader(str(path), 4)) == recs


def test_native_writer_writes_the_same_file(tmp_path):
    recs = _records()
    w = tnative.NativeRecordIO(str(tmp_path / "n.rec"), "w")
    for r in recs:
        w.write(r)
    w.close()
    _write(mx, str(tmp_path / "j"), recs)
    assert (tmp_path / "n.rec").read_bytes() == \
        (tmp_path / "j.rec").read_bytes()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(5)])
def test_pack_unpack_equal_reference(label):
    header = (0, label, 7, 2)
    got = mt.recordio.pack(header, b"payload")
    assert got == mx.recordio.pack(header, b"payload")
    (th, tb), (jh, jb) = mt.recordio.unpack(got), mx.recordio.unpack(got)
    assert tb == jb == b"payload"
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_equal_reference(fmt):
    img = (np.random.RandomState(1).rand(12, 10, 3) * 255).astype(np.uint8)
    header = (0, 1.0, 3, 0)
    got = mt.recordio.pack_img(header, img, quality=90, img_fmt=fmt)
    assert got == mx.recordio.pack_img(header, img, quality=90, img_fmt=fmt)
    (th, ti), (jh, ji) = (mt.recordio.unpack_img(got),
                          mx.recordio.unpack_img(got))
    np.testing.assert_array_equal(ti, ji)
    if fmt == ".png":
        np.testing.assert_array_equal(ti, img)
