"""The port's data iterators against the JAX package's (`mxnet_tpu/io.py`),
on the same numpy inputs and files: `NDArrayIter`'s shards
(``num_parts``/``part_index``, every ``last_batch_handle``,
``repartition`` between epochs), `MNISTIter` over idx files the test
writes, `CSVIter`, `ResizeIter`, `PrefetchingIter` under the
``NaiveEngine``, `ImageRecordIter` on its native path and on its Python
`ImageIter` path, and the Gluon datasets over RecordIO files and image
folders.  Batches must be equal: the pixels of both packages come from
the same decoder (PIL, or the native library's copies of one source),
and the normalization is the same float32 arithmetic, so the float
batches are held to 1e-6 and everything else exactly.
"""
import gzip
import io as _io
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import io_native as jnative
from mxnet_tpu.engine import Engine as JEngine
from mxnet_tpu_torch import io_native as tnative
from mxnet_tpu_torch.engine import Engine as TEngine

TOL = 1e-6
EPOCHS = 2


def _batches(it, epochs=EPOCHS):
    """Every epoch's batches as (data, label, pad) numpy tuples."""
    out = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same(got, want, tol=0.0):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _arrays(n=10):
    data = (np.arange(n, dtype=np.float32) * 2)[:, None] + \
        np.arange(2, dtype=np.float32)
    return data, np.arange(n, dtype=np.float32)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("num_parts", [1, 2, 3])
def test_ndarrayiter_shards_match_reference(num_parts, handle):
    data, label = _arrays(10)
    for part in range(num_parts):
        kw = dict(batch_size=2 if num_parts == 3 else 3,
                  last_batch_handle=handle, num_parts=num_parts,
                  part_index=part)
        want = _batches(mx.io.NDArrayIter(data, label, **kw))
        got = _batches(mt.io.NDArrayIter(data, label, **kw))
        _same(got, want)


def test_ndarrayiter_shard_of_ten_rows():
    """Rows 1, 3, 5, 7, 9 of ``2·arange(10)``, padded from the shard's
    start."""
    x = np.arange(10, dtype=np.float32) * 2
    it = mt.io.NDArrayIter(x, batch_size=2, num_parts=2, part_index=1)
    got = [b.data[0].asnumpy().tolist() for b in it]
    assert got == [[2, 6], [10, 14], [18, 2]]
    _same(_batches(it, 1),
          _batches(mx.io.NDArrayIter(x, batch_size=2, num_parts=2,
                                     part_index=1), 1))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_repartition_between_epochs_matches_reference(handle):
    data, label = _arrays(11)
    its = [pkg.io.NDArrayIter(data, label, batch_size=2, num_parts=2,
                              part_index=0, last_batch_handle=handle)
           for pkg in (mx, mt)]
    got = []
    for it in its:
        seen = _batches(it, 1)
        it.repartition(3, 2)
        seen += _batches(it, 2)
        it.repartition(1, 0)
        seen += _batches(it, 1)
        got.append(seen)
    _same(got[1], got[0])


def test_partition_out_of_range_raises_in_both():
    data, label = _arrays(6)
    for pkg in (mx, mt):
        with pytest.raises(pkg.base.MXNetError, match="out of range"):
            pkg.io.NDArrayIter(data, label, num_parts=2, part_index=2)


def _write_mnist(tmp_path, n, gz):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbl = rs.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    ip, lp = (str(tmp_path / f"img{suffix}"), str(tmp_path / f"lbl{suffix}"))
    with opener(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbl.tobytes())
    with opener(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    return ip, lp


@pytest.mark.parametrize("gz,flat", [(False, False), (True, True)])
def test_mnistiter_reads_idx_files_as_reference(tmp_path, gz, flat):
    ip, lp = _write_mnist(tmp_path, 23, gz)
    kw = dict(image=ip, label=lp, batch_size=5, shuffle=False, flat=flat)
    _same(_batches(mt.io.MNISTIter(**kw)), _batches(mx.io.MNISTIter(**kw)))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csviter_matches_reference(tmp_path, round_batch):
    rs = np.random.RandomState(4)
    d, l = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(d, rs.rand(11, 6).astype(np.float32), delimiter=",")
    np.savetxt(l, rs.randint(0, 3, 11).astype(np.float32), delimiter=",")
    kw = dict(data_csv=d, data_shape=(2, 3), label_csv=l, batch_size=4,
              round_batch=round_batch)
    _same(_batches(mt.io.CSVIter(**kw)), _batches(mx.io.CSVIter(**kw)))


def test_resizeiter_matches_reference():
    data, label = _arrays(10)
    got, want = (_batches(pkg.io.ResizeIter(
        pkg.io.NDArrayIter(data, label, batch_size=3), 7))
        for pkg in (mt, mx))
    _same(got, want)


def test_prefetchingiter_under_naive_engine_matches_reference():
    data, label = _arrays(17)
    got = _batches(mt.io.PrefetchingIter(
        mt.io.NDArrayIter(data, label, batch_size=4), prefetch_depth=3,
        engine=TEngine("NaiveEngine")))
    want = _batches(mx.io.PrefetchingIter(
        mx.io.NDArrayIter(data, label, batch_size=4), prefetch_depth=3,
        engine=JEngine("NaiveEngine")))
    _same(got, want)


def _jpegs(n, size, seed=0):
    from PIL import Image
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = np.linspace(0, 255, size, dtype=np.float32)
        img = (base[None, :, None] + rs.uniform(0, 60, (size, 1, 3))
               + rs.uniform(0, 20, (size, size, 3))).clip(0, 255)
        b = _io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(b, "JPEG", quality=90)
        out.append(b.getvalue())
    return out


def _rec(tmp_path, n, size, name="data"):
    from mxnet_tpu_torch.recordio import IRHeader, MXIndexedRecordIO, pack
    prefix = str(tmp_path / name)
    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, buf in enumerate(_jpegs(n, size)):
        rec.write_idx(i, pack(IRHeader(0, float(i % 3), i, 0), buf))
    rec.close()
    return prefix + ".rec"


def test_imagerecorditer_native_path_matches_reference(tmp_path):
    if not (jnative.decode_available() and tnative.decode_available()):
        pytest.skip("the native JPEG decoder needs libjpeg")
    rec = _rec(tmp_path, 11, 16)
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=4,
              shuffle=True, rand_mirror=True, mean=True, std=True, seed=5,
              seed_aug=7)
    with mt.cpu():
        it = mt.io.ImageRecordIter(**kw)
    assert isinstance(it.iters[0], mt.io.NativeImageRecordIter)
    ref = mx.io.ImageRecordIter(**kw)
    assert isinstance(ref.iters[0], mx.io.NativeImageRecordIter)
    _same(_batches(it), _batches(ref), TOL)


def test_imagerecorditer_python_path_matches_reference(tmp_path):
    """Records not packed at the shape: `ImageIter` (random crop, mirror,
    normalize) with the augmentation stream seeded.  A resize rounds its
    ties apart in the two packages (`tests/test_torch_image.py`), so the
    crop here takes windows of the decoded images as they are."""
    rec = _rec(tmp_path, 9, 16)
    kw = dict(path_imgrec=rec, data_shape=(3, 12, 12), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True,
              mean=True, std=True, seed=3, seed_aug=9)
    with mt.cpu():
        it = mt.io.ImageRecordIter(**kw)
    assert isinstance(it.iters[0], mt.image.ImageIter)
    assert it.iters[0]._tail is not None  # the device tail serves
    _same(_batches(it), _batches(mx.io.ImageRecordIter(**kw)), TOL)


def test_recordfiledataset_matches_reference(tmp_path):
    rec = _rec(tmp_path, 5, 8)
    got = mt.gluon.data.RecordFileDataset(rec)
    want = mx.gluon.data.RecordFileDataset(rec)
    assert len(got) == len(want) == 5
    assert [got[i] for i in range(5)] == [want[i] for i in range(5)]


def test_imagerecorddataset_matches_reference(tmp_path):
    rec = _rec(tmp_path, 5, 8)
    got = mt.gluon.data.vision.ImageRecordDataset(rec)
    want = mx.gluon.data.vision.ImageRecordDataset(rec)
    assert len(got) == len(want)
    for i in range(len(got)):
        (gi, gl), (wi, wl) = got[i], want[i]
        np.testing.assert_array_equal(gi.asnumpy(), wi.asnumpy())
        assert gl == wl


def test_imagefolderdataset_matches_reference(tmp_path):
    for k, cls in enumerate(("cat", "dog")):
        os.makedirs(tmp_path / cls)
        for i, buf in enumerate(_jpegs(2, 8, seed=k)):
            (tmp_path / cls / f"{i}.jpg").write_bytes(buf)
    (tmp_path / "notes.txt").write_text("not a class")
    got = mt.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    want = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert got.synsets == want.synsets == ["cat", "dog"]
    assert len(got) == len(want) == 4
    for i in range(4):
        np.testing.assert_array_equal(got[i][0].asnumpy(),
                                      want[i][0].asnumpy())
        assert got[i][1] == want[i][1]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_normalize_mirror_batch_op_matches_reference(layout):
    rs = np.random.RandomState(8)
    x = rs.randint(0, 256, (3, 4, 5, 3)).astype(np.uint8)
    flip = np.array([1.0, 0.0, 1.0], np.float32)
    kw = dict(mean=(10.0, 20.0, 30.0), std=(2.0, 3.0, 4.0), layout=layout)
    from mxnet_tpu.ndarray.register import invoke as jinvoke
    from mxnet_tpu_torch.ndarray.register import invoke as tinvoke
    want = jinvoke("_image_normalize_mirror_batch",
                   mx.nd.array(x, dtype=np.uint8), mx.nd.array(flip), **kw)
    got = tinvoke("_image_normalize_mirror_batch",
                  mt.nd.array(x, ctx=mt.cpu(), dtype=np.uint8),
                  mt.nd.array(flip, ctx=mt.cpu()), **kw)
    want = want.asnumpy()
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
