"""Image I/O and augmenters (the counterpart of `mxnet_tpu/image.py`;
reference `python/mxnet/image/image.py`).

Images decode on the host with PIL into CPU NDArrays of uint8 HWC pixels,
as MXNet's `imdecode` gives them, and the augmenters run the port's image
ops on them.  Augmentation draws come from Python's `random` (or an
iterator's private `random.Random` under ``seed_aug``), the JAX package's
stream, so both packages augment alike for a seed.

`ImageIter` returns its batches on the current context of its
construction.  When its augmenter list ends in the standard tail (an
optional `HorizontalFlipAug`, `CastAug` to float32, an optional
`ColorNormalizeAug`) after crops and resizes alone, it draws the mirror
flags on the host and stages the uint8 images to the device, where the
tail runs batched (`io._Stager`); the numbers are those of the
per-image tail.
"""
from __future__ import annotations

import io as _io
import os
import random as _pyrandom
import threading as _threading

import numpy as np
import torch

from .base import MXNetError
from .context import default_context
from .ndarray.ndarray import NDArray, array
from .ndarray.register import invoke

__all__ = ["imdecode", "imencode", "imread", "imresize", "fixed_crop",
           "center_crop", "random_crop", "resize_short", "color_normalize",
           "scale_down", "copyMakeBorder", "random_size_crop",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "HorizontalFlipAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "CastAug", "CreateAugmenter", "ImageIter"]


# augmentation draws go through _rng(), so that an iterator with seed_aug
# installs its own generator on the thread that runs its fetch
_thread_rng = _threading.local()


def _rng():
    return getattr(_thread_rng, "rng", None) or _pyrandom


def _set_thread_rng(rng):
    _thread_rng.rng = rng


def _host(arr) -> NDArray:
    """A numpy array as a CPU NDArray of its dtype (copied when numpy
    holds it read-only)."""
    return NDArray(torch.from_numpy(np.require(arr, requirements="CW")))


def _as_np(src) -> np.ndarray:
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def imdecode(buf, flag=1, to_rgb=True):
    """An encoded image as a CPU NDArray of HWC uint8 pixels: RGB, BGR
    without ``to_rgb``, one channel with ``flag=0`` (reference
    `image.py:imdecode`)."""
    from PIL import Image
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _host(arr)


def imencode(img, quality=95, img_fmt=".jpg"):
    """A uint8 HWC image encoded by PIL as JPEG (``.jpg``/``.jpeg``) or
    PNG."""
    from PIL import Image
    img = np.asarray(_as_np(img), dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    pil = Image.fromarray(img)
    out = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    if fmt == "JPEG" and pil.mode not in ("L", "RGB"):
        pil = pil.convert("RGB")
    pil.save(out, fmt, quality=quality)
    return out.getvalue()


def imread(filename, flag=1, to_rgb=True):
    """`imdecode` of a file."""
    with open(filename, "rb") as fin:
        return imdecode(fin.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    """Bilinear resize to ``w`` x ``h`` (every ``interp`` resizes
    bilinearly, as in the JAX package)."""
    return invoke("_image_resize", src, size=(w, h))


def resize_short(src, size, interp=2):
    """Resize so the shorter edge == size (reference `image.py:resize_short`)."""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The ``w`` x ``h`` window at (``x0``, ``y0``), resized to ``size``
    when given."""
    out = NDArray(src.data[y0:y0 + h, x0:x0 + w, :])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _rng().randint(0, w - new_w)
    y0 = _rng().randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def _like(value, src) -> NDArray:
    if isinstance(value, NDArray):
        return value
    return array(np.asarray(value, np.float32), ctx=src.context)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std``, either left out when None."""
    if mean is not None:
        src = src - _like(mean, src)
    if std is not None:
        src = src / _like(std, src)
    return src


def scale_down(src_size, size):
    """Scale `size` down proportionally so it fits inside `src_size`
    (reference `image.py:scale_down`)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def copyMakeBorder(src, top, bot, left, right, border_type=0, values=0):
    """Pad an HWC image with a constant border (reference
    `image.py:copyMakeBorder`, cv2.copyMakeBorder BORDER_CONSTANT path)."""
    arr = _as_np(src)
    pad = ((top, bot), (left, right)) + ((0, 0),) * (arr.ndim - 2)
    return _host(np.pad(arr, pad, mode="constant", constant_values=values))


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    """Random crop by [area-fraction, aspect-ratio] then resize to `size`
    (reference `image.py:random_size_crop`)."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if "min_area" in kwargs:
        area = kwargs.pop("min_area")
        area = (area, 1.0)
    if np.isscalar(area):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _rng().uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(_rng().uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _rng().randint(0, w - new_w)
            y0 = _rng().randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    # fall back to center crop
    return center_crop(src, size, interp)


# ---------------------------------------------------------------------------
# Augmenters (reference `image.py:Augmenter` family)
# ---------------------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """Compose augmenters sequentially (reference `image.py:SequentialAug`)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__.lower(), [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference
    `image.py:RandomOrderAug`)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__.lower(), [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        _rng().shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """Random area/aspect crop then resize (reference
    `image.py:RandomSizedCropAug`)."""

    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _rng().random() < self.p:
            return invoke("_image_flip_left_right", src)
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


_GRAY_COEF = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _as_float_np(src):
    return _as_np(src).astype(np.float32, copy=False)


class BrightnessJitterAug(Augmenter):
    """Scale pixel values by 1±U(0, brightness) (reference
    `image.py:BrightnessJitterAug`)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.brightness, self.brightness)
        return _host(_as_float_np(src) * alpha)


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (reference
    `image.py:ContrastJitterAug`)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.contrast, self.contrast)
        arr = _as_float_np(src)
        gray = arr @ _GRAY_COEF        # (H, W) weighted gray per pixel
        gray_mean = (1.0 - alpha) * gray.mean()
        return _host(arr * alpha + gray_mean)


class SaturationJitterAug(Augmenter):
    """Blend each pixel with its own gray value (reference
    `image.py:SaturationJitterAug`)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.saturation, self.saturation)
        arr = _as_float_np(src)
        gray = (arr @ _GRAY_COEF)[..., None] * (1.0 - alpha)
        return _host(arr * alpha + gray)


class HueJitterAug(Augmenter):
    """Rotate hue in YIQ space (reference `image.py:HueJitterAug`,
    the Gil-Werman yiq/ityq matrix pair)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        alpha = _rng().uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], dtype=np.float32)
        t = self.ityiq @ bt @ self.tyiq
        return _host(_as_float_np(src) @ t.T)


class ColorJitterAug(RandomOrderAug):
    """Random-order brightness/contrast/saturation jitter (reference
    `image.py:ColorJitterAug`)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference
    `image.py:LightingAug`)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        # drawn through _rng() so seed_aug covers the lighting noise too
        alpha = np.array([_rng().gauss(0, self.alphastd)
                          for _ in range(3)], np.float32)
        rgb = self.eigvec @ (self.eigval * alpha)
        return _host(_as_float_np(src) + rgb)


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel grayscale (reference
    `image.py:RandomGrayAug`)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.full((3, 3), 1.0, dtype=np.float32) * _GRAY_COEF[None, :]

    def __call__(self, src):
        if _rng().random() < self.p:
            return _host(_as_float_np(src) @ self.mat.T)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference
    `image.py:CreateAugmenter`)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


_CROPS = (ResizeAug, ForceResizeAug, RandomCropAug, RandomSizedCropAug,
          CenterCropAug)


def _device_tail(auglist):
    """``(host augmenters, flip probability or None, mean, std)`` when the
    list is crops and resizes (uint8 in, uint8 out) followed by the
    standard tail, which the device then runs batched; else None."""
    augs = list(auglist)
    mean = std = None
    if augs and type(augs[-1]) is ColorNormalizeAug:
        mean, std = augs[-1].mean, augs[-1].std
        augs.pop()
    if not augs or type(augs[-1]) is not CastAug or \
            np.dtype(augs[-1].typ) != np.float32:
        return None
    augs.pop()
    p = None
    if augs and type(augs[-1]) is HorizontalFlipAug:
        p = augs.pop().p
    if not all(type(a) in _CROPS for a in augs):
        return None
    mean = np.zeros((1,), np.float32) if mean is None else mean.reshape(-1)
    std = np.ones((1,), np.float32) if std is None else std.reshape(-1)
    return augs, p, mean, std


class ImageIter:
    """Batches of augmented images from a RecordIO file or an image list
    (reference `mxnet.image.ImageIter`), on the current context of the
    construction."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 num_parts=1, part_index=0, seed=None, seed_aug=None,
                 **kwargs):
        from .config import get_env
        from .io import _Stager, _partition
        # `seed` fixes the shuffle order, `seed_aug` the augmentation
        # draws of every epoch (reference iter_image_recordio_2.cc)
        self._seed_aug = seed_aug
        self._shuffle_rng = (_pyrandom.Random(seed) if seed is not None
                             else _pyrandom)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_resize",
                                                    "rand_mirror", "mean",
                                                    "std", "brightness",
                                                    "contrast", "saturation",
                                                    "hue", "pca_noise",
                                                    "rand_gray",
                                                    "inter_method")})
        self.ctx = default_context("ImageIter")
        self._tail = _device_tail(self.auglist)
        self._stager = _Stager(self.ctx.device,
                               int(get_env("MXTPU_PREFETCH_DEPTH")) + 1)
        self._records = []
        if path_imgrec:
            from .recordio import MXIndexedRecordIO, scan_record_offsets
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
            if not self._rec.keys:
                # no .idx: the offsets from one scan of the headers
                for k, offset in enumerate(scan_record_offsets(path_imgrec)):
                    self._rec.idx[k] = offset
                    self._rec.keys.append(k)
            self._records = list(self._rec.keys)
            self._mode = "rec"
        elif imglist is not None or path_imglist:
            if path_imglist:
                imglist = []
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        # index, label..., path: the whole label vector
                        label = np.array(parts[1:-1], dtype=np.float32)
                        imglist.append((label if label.size > 1
                                        else float(label[0]), parts[-1]))
            self._imglist = imglist
            self._root = path_root or "."
            self._records = list(range(len(imglist)))
            self._mode = "list"
        else:
            raise MXNetError("either path_imgrec, path_imglist or imglist "
                             "is required")
        self._records = list(_partition(self._records, num_parts,
                                        part_index))
        self._cursor = 0
        self.reset()

    @property
    def provide_data(self):
        from .io import DataDesc
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from .io import DataDesc
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0
        # a generator of this iterator's own, made anew each epoch
        self._aug_rng = (_pyrandom.Random(self._seed_aug)
                         if self._seed_aug is not None else None)
        if self._shuffle:
            self._shuffle_rng.shuffle(self._records)

    def _load(self, key):
        """``(decoded image, label)`` of a record or list entry."""
        if self._mode == "rec":
            from .recordio import unpack
            header, buf = unpack(self._rec.read_idx(key))
            return imdecode(buf), header.label
        label, path = self._imglist[key]
        return imread(os.path.join(self._root, path)), label

    def _read_sample(self, key):
        img, label = self._load(key)
        for aug in self.auglist:
            img = aug(img)
        arr = img.asnumpy()
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)  # HWC to CHW
        return arr, label

    def _staged_next(self):
        # this iterator's augmentation stream on the calling thread (the
        # prefetch worker's, when wrapped) for the batch
        _set_thread_rng(self._aug_rng)
        try:
            return self._next_impl()
        finally:
            _set_thread_rng(None)

    def next(self):
        from .io import _hand_over
        return _hand_over(self._staged_next())

    def _label_row(self, label):
        return np.asarray(label, np.float32).reshape(-1)[:self.label_width]

    def _next_impl(self):
        if self._cursor >= len(self._records):
            raise StopIteration
        keys = self._records[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        if self._tail is not None:
            return self._next_on_device(keys)
        from .io import DataBatch
        datas, labels = [], []
        for k in keys:
            d, l = self._read_sample(k)
            datas.append(d)
            labels.append(self._label_row(l))
        pad = self.batch_size - len(keys)
        datas += [np.zeros_like(datas[0])] * pad
        labels += [np.zeros_like(labels[0])] * pad
        data = array(np.stack(datas).astype(np.float32), ctx=self.ctx)
        lab = np.stack(labels)
        label = array(lab.squeeze(-1) if self.label_width == 1 else lab,
                      ctx=self.ctx)
        return DataBatch(data=[data], label=[label], pad=pad)

    def _next_on_device(self, keys):
        """The host augmenters per image into a staging slot, each image's
        mirror flag drawn where `HorizontalFlipAug` draws it; the tail on
        the device."""
        from .io import _staged_batch
        host_augs, p, mean, std = self._tail
        c, h, w = self.data_shape
        slot = self._stager.slot(self.batch_size, (h, w, c), self.label_width)
        for i, k in enumerate(keys):
            img, label = self._load(k)
            for aug in host_augs:
                img = aug(img)
            slot.data[i] = img.asnumpy()
            slot.flip[i] = p is not None and _rng().random() < p
            slot.label[i] = self._label_row(label)
        pad = self.batch_size - len(keys)
        slot.data[len(keys):] = 0
        slot.flip[len(keys):] = False
        slot.label[len(keys):] = 0
        return _staged_batch(self._stager, slot, pad, mean, std,
                             self.label_width, zero_pad=True)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


# the detection pipeline, under `image` as in the reference's
# `python/mxnet/image/__init__.py`
from .image_detection import (DetAugmenter, DetBorrowAug,  # noqa: E402
                              DetRandomSelectAug, DetHorizontalFlipAug,
                              DetRandomCropAug, DetRandomPadAug,
                              CreateMultiRandCropAugmenter,
                              CreateDetAugmenter, ImageDetIter)

__all__ += ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
            "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
            "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
            "ImageDetIter"]
