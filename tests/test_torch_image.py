"""The port's image module against the JAX package's (`mxnet_tpu/image.py`,
`mxnet_tpu/image_detection.py`) on the same images, with Python's
`random` seeded alike: decode and encode, the crops, every augmenter,
`CreateAugmenter`'s lists, `ImageIter` over a RecordIO file and over an
image list (with ``seed_aug``, twice: each epoch's draws are the same),
the detection augmenters and `ImageDetIter`.  Pixels must be equal and
float outputs within 1e-5 of the reference's largest magnitude.

A bilinear resize of uint8 pixels rounds its exact halves (half to
even) after float32 arithmetic that the two packages order differently,
so where the exact value is a half-integer the packages may round to
neighbouring levels: the resize test holds the port to round-half-even
of the float64 resize everywhere, and to the JAX package's pixels
everywhere but at such ties.  The other tests crop without resizing.

The port's native decoder (its own build of `csrc/host/imagedec.cc`)
must give the JAX package's decoder's pixels on the same bytes in both
decode modes.
"""
import io as _io
import os
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import io_native as jnative
from mxnet_tpu_torch import io_native as tnative

TOL = 1e-5


def _jpeg(seed, h=16, w=16, quality=90):
    from PIL import Image
    rs = np.random.RandomState(seed)
    img = np.clip(np.linspace(0, 255, w)[None, :, None]
                  + rs.uniform(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    b = _io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=quality)
    return b.getvalue()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got.astype(np.float64) - want).max() <= TOL * scale, what


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_equals_reference(flag, to_rgb):
    buf = _jpeg(0)
    _close(mt.image.imdecode(buf, flag, to_rgb),
           mx.image.imdecode(buf, flag, to_rgb))
    img = mt.image.imdecode(buf)
    assert img.context == mt.cpu() and img.asnumpy().dtype == np.uint8
    assert mt.image.imencode(img) == mx.image.imencode(img.asnumpy())


def test_resize_rounds_ties_apart_only():
    from mxnet_tpu_torch.image import _host
    rs = np.random.RandomState(0)
    for k in range(12):
        x = mt.image.imdecode(_jpeg(k, 20, 20))
        got = mt.image.resize_short(x, 14).asnumpy()
        want = mx.image.resize_short(mx.image.imdecode(_jpeg(k, 20, 20)),
                                     14).asnumpy()
        exact = mt.image.resize_short(
            _host(x.asnumpy().astype(np.float64)), 14).asnumpy()
        tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-4
        np.testing.assert_array_equal(got, np.clip(np.round(exact), 0, 255))
        assert (got[~tie] == want[~tie]).all()
        assert (np.abs(got.astype(int) - want) <= 1).all()
    del rs


def _augment(pkg, aug, buf, seed):
    random.seed(seed)
    return aug(pkg.image.imdecode(buf))


def _pair(make, seed=3, buf=None):
    buf = buf or _jpeg(1)
    return (_augment(mt, make(mt), buf, seed),
            _augment(mx, make(mx), buf, seed))


AUGS = {
    "center_crop": lambda p: p.image.CenterCropAug((12, 12)),
    "random_crop": lambda p: p.image.RandomCropAug((10, 12)),
    "random_sized_crop_small": lambda p: p.image.RandomSizedCropAug(
        (16, 16), (0.95, 1.0), (0.99, 1.01)),
    "flip": lambda p: p.image.HorizontalFlipAug(1.0),
    "cast": lambda p: p.image.CastAug(),
    "normalize": lambda p: p.image.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
    "brightness": lambda p: p.image.BrightnessJitterAug(0.3),
    "contrast": lambda p: p.image.ContrastJitterAug(0.3),
    "saturation": lambda p: p.image.SaturationJitterAug(0.3),
    "hue": lambda p: p.image.HueJitterAug(0.2),
    "color_jitter": lambda p: p.image.ColorJitterAug(0.2, 0.2, 0.2),
    "lighting": lambda p: p.image.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]])),
    "gray": lambda p: p.image.RandomGrayAug(1.0),
    "sequential": lambda p: p.image.SequentialAug(
        [p.image.RandomCropAug((12, 12)), p.image.HorizontalFlipAug(0.5)]),
    "random_order": lambda p: p.image.RandomOrderAug(
        [p.image.CastAug(), p.image.BrightnessJitterAug(0.2),
         p.image.ContrastJitterAug(0.2)]),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_equals_reference(name):
    for seed in (3, 4):
        got, want = _pair(AUGS[name], seed)
        _close(got, want, name)


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_mirror=True, brightness=0.2, contrast=0.2, saturation=0.2,
         hue=0.1, pca_noise=0.1, rand_gray=0.3, mean=True),
    dict(rand_crop=True, rand_resize=True)])
def test_create_augmenter_lists_equal_reference(kw):
    tl, jl = (pkg.image.CreateAugmenter((3, 12, 12), **kw)
              for pkg in (mt, mx))
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    if kw.get("rand_resize"):
        return  # its crop resizes (see the resize test)
    for seed in (5, 6):
        buf = _jpeg(seed)
        outs = []
        for pkg, augs in ((mt, tl), (mx, jl)):
            random.seed(seed)
            img = pkg.image.imdecode(buf)
            for a in augs:
                img = a(img)
            outs.append(img)
        _close(*outs, str(kw))


def _write_rec(tmp_path, n, size=16):
    prefix = str(tmp_path / "img")
    rec = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    for i in range(n):
        rec.write_idx(i, mt.recordio.pack((0, float(i % 4), i, 0),
                                          _jpeg(10 + i, size, size)))
    rec.close()
    return prefix + ".rec"


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.reset()
        out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it]
    return out


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_mirror=True, brightness=0.2, mean=True),
    dict(rand_crop=True)])
def test_imageiter_over_rec_equals_reference(tmp_path, kw):
    rec = _write_rec(tmp_path, 7)
    args = dict(batch_size=3, data_shape=(3, 12, 12), path_imgrec=rec,
                shuffle=True, seed=1, seed_aug=2, **kw)
    with mt.cpu():
        it = mt.image.ImageIter(**args)
    got = _epochs(it)
    want = _epochs(mx.image.ImageIter(**args))
    assert len(got) == len(want) == 6
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        _close(gd, wd)
        _close(gl, wl)
        assert gp == wp


def test_imageiter_over_image_list_equals_reference(tmp_path):
    lines = []
    for i in range(5):
        (tmp_path / f"{i}.jpg").write_bytes(_jpeg(20 + i))
        lines.append(f"{i}\t{i % 2}\t{i}.jpg")
    (tmp_path / "l.lst").write_text("\n".join(lines) + "\n")
    args = dict(batch_size=2, data_shape=(3, 14, 14),
                path_imglist=str(tmp_path / "l.lst"),
                path_root=str(tmp_path), rand_crop=True, seed_aug=4)
    with mt.cpu():
        it = mt.image.ImageIter(**args)
    for g, w in zip(_epochs(it), _epochs(mx.image.ImageIter(**args))):
        _close(g[0], w[0])
        _close(g[1], w[1])
        assert g[2] == w[2]


def _det_label(n_obj, rs):
    boxes = []
    for _ in range(n_obj):
        x0, y0 = rs.uniform(0, 0.5, 2)
        boxes.append([rs.randint(0, 3), x0, y0, x0 + rs.uniform(0.2, 0.5),
                      y0 + rs.uniform(0.2, 0.5)])
    return np.concatenate([[2, 5], np.array(boxes).ravel()]).astype(
        np.float32)


DET_AUGS = {
    "flip": lambda p: p.image.DetHorizontalFlipAug(1.0),
    "crop": lambda p: p.image.DetRandomCropAug(0.1, (0.75, 1.33),
                                               (0.3, 1.0)),
    "pad": lambda p: p.image.DetRandomPadAug((0.9, 1.1), (1.5, 2.0)),
    "select": lambda p: p.image.CreateMultiRandCropAugmenter(
        [0.1, 0.3], skip_prob=0.2),
    "borrow": lambda p: p.image.DetBorrowAug(p.image.CastAug()),
}


@pytest.mark.parametrize("name", sorted(DET_AUGS))
def test_detection_augmenter_equals_reference(name):
    rs = np.random.RandomState(7)
    label = mx.image.ImageDetIter._parse_label(_det_label(3, rs))
    buf = _jpeg(30, 20, 20)
    outs = []
    for pkg in (mt, mx):
        random.seed(8)
        img, lab = DET_AUGS[name](pkg)(pkg.image.imdecode(buf), label)
        outs.append((img, lab))
    _close(outs[0][0], outs[1][0], name)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6)


def test_imagedetiter_equals_reference(tmp_path):
    rs = np.random.RandomState(9)
    prefix = str(tmp_path / "det")
    rec = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    for i in range(5):
        rec.write_idx(i, mt.recordio.pack(
            (0, _det_label(1 + i % 3, rs), i, 0), _jpeg(40 + i, 16, 16)))
    rec.close()
    args = dict(batch_size=2, data_shape=(3, 16, 16),
                path_imgrec=prefix + ".rec", rand_mirror=True, seed_aug=3)
    with mt.cpu():
        it = mt.image.ImageDetIter(**args)
    ref = mx.image.ImageDetIter(**args)
    assert it.label_shape == ref.label_shape
    for g, w in zip(_epochs(it), _epochs(ref)):
        _close(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
        assert g[2] == w[2]


@pytest.mark.parametrize("fast", [False, True])
def test_native_decoder_equals_reference(fast):
    if not (tnative.decode_available() and jnative.decode_available()):
        pytest.skip("the native JPEG decoder needs libjpeg")
    assert not tnative.lib_path().startswith(
        os.path.dirname(jnative.__file__))
    bufs = [_jpeg(50 + i, 32, 24) for i in range(6)]
    for oh, ow in ((32, 24), (16, 12), (20, 30)):
        got, gok = tnative.decode_jpeg_batch(bufs, oh, ow, 3, 2, fast=fast)
        want, wok = jnative.decode_jpeg_batch(bufs, oh, ow, 3, 2, fast=fast)
        assert gok.all() and wok.all()
        np.testing.assert_array_equal(got, want)
    assert tnative.jpeg_dimensions(bufs[0]) == (32, 24)
