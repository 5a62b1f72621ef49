"""The object-detection data pipeline: detection augmenters and
`ImageDetIter` (the counterpart of `mxnet_tpu/image_detection.py`;
reference `python/mxnet/image/detection.py`).

Augmentation runs on the host in numpy (object counts and crop sizes vary
per image); only the padded, fixed-shape batch goes to the device.

Label wire format matches the reference: a flat vector
``[header_width, obj_width, <header...>, id, xmin, ymin, xmax, ymax, ...]``
with coordinates normalized to [0, 1] (`detection.py:_parse_label`).
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import image as _img
from .base import MXNetError
from .image import _host, _rng
from .ndarray.ndarray import NDArray, array

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Base detection augmenter: transforms (image, label) jointly
    (reference `detection.py:DetAugmenter`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline
    (reference `detection.py:DetBorrowAug`)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, _img.Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__()
        self.augmenter = augmenter

    def dumps(self):
        return [type(self).__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one child augmenter per sample, or skip entirely with
    probability `skip_prob` (reference `detection.py:DetRandomSelectAug`)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def dumps(self):
        return [type(self).__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if not self.aug_list or _rng().random() < self.skip_prob:
            return src, label
        return _rng().choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and box x-coordinates with probability p (reference
    `detection.py:DetHorizontalFlipAug`)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rng().random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
            src = _host(arr[:, ::-1, :])
            label = label.copy()
            xmin = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - label[:, 1]
            label[:, 1] = xmin
        return src, label


def _box_areas(label):
    return np.maximum(0.0, label[:, 3] - label[:, 1]) * \
        np.maximum(0.0, label[:, 4] - label[:, 2])


def _intersect_areas(label, x0, y0, x1, y1):
    ix = np.maximum(0.0, np.minimum(label[:, 3], x1) -
                    np.maximum(label[:, 1], x0))
    iy = np.maximum(0.0, np.minimum(label[:, 4], y1) -
                    np.maximum(label[:, 2], y0))
    return ix * iy


def _update_labels(label, box, min_eject_coverage):
    """Re-express labels in the coordinate frame of `box` = (x0, y0, w, h)
    in normalized units; drop objects with < min_eject_coverage of their
    area inside (reference `detection.py:DetRandomCropAug._update_labels`)."""
    x0, y0, w, h = box
    areas = _box_areas(label)
    inter = _intersect_areas(label, x0, y0, x0 + w, y0 + h)
    coverage = np.where(areas > 0, inter / np.maximum(areas, 1e-12), 0.0)
    keep = coverage >= min_eject_coverage
    if not np.any(keep):
        return None
    out = label[keep].copy()
    out[:, 1] = (np.clip(out[:, 1], x0, x0 + w) - x0) / w
    out[:, 2] = (np.clip(out[:, 2], y0, y0 + h) - y0) / h
    out[:, 3] = (np.clip(out[:, 3], x0, x0 + w) - x0) / w
    out[:, 4] = (np.clip(out[:, 4], y0, y0 + h) - y0) / h
    return out


class DetRandomCropAug(DetAugmenter):
    """SSD-style constrained random crop (reference
    `detection.py:DetRandomCropAug`): sample crops until one covers at
    least `min_object_covered` of some object, then drop objects with
    < `min_eject_coverage` of their area inside the crop."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        if not 0 <= min_object_covered <= 1:
            raise ValueError("min_object_covered must be in [0, 1]")
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = (min(area_range[0], 1.0), min(area_range[1], 1.0))
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = self.area_range[1] > self.area_range[0] or \
            self.area_range[0] < 1.0

    def _propose(self, label):
        for _ in range(self.max_attempts):
            area = _rng().uniform(*self.area_range)
            ratio = _rng().uniform(*self.aspect_ratio_range)
            h = min(1.0, np.sqrt(area / ratio))
            w = min(1.0, ratio * h)
            x0 = _rng().uniform(0.0, 1.0 - w)
            y0 = _rng().uniform(0.0, 1.0 - h)
            areas = _box_areas(label)
            inter = _intersect_areas(label, x0, y0, x0 + w, y0 + h)
            cov = np.where(areas > 0, inter / np.maximum(areas, 1e-12), 0.0)
            if np.any(cov >= self.min_object_covered):
                new = _update_labels(label, (x0, y0, w, h),
                                     self.min_eject_coverage)
                if new is not None:
                    return (x0, y0, w, h), new
        return None, None

    def __call__(self, src, label):
        if not self.enabled:
            return src, label
        box, new_label = self._propose(label)
        if box is None:
            return src, label
        h, w = src.shape[0], src.shape[1]
        x0 = int(round(box[0] * w))
        y0 = int(round(box[1] * h))
        cw = max(1, int(round(box[2] * w)))
        ch = max(1, int(round(box[3] * h)))
        cw = min(cw, w - x0)
        ch = min(ch, h - y0)
        return _img.fixed_crop(src, x0, y0, cw, ch), new_label


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad ("zoom out") with label rescale (reference
    `detection.py:DetRandomPadAug`)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = (max(1.0, area_range[0]), max(1.0, area_range[1]))
        self.max_attempts = max_attempts
        self.pad_val = pad_val
        self.enabled = self.area_range[1] > 1.0

    def _propose(self, h, w):
        for _ in range(self.max_attempts):
            scale = _rng().uniform(*self.area_range)
            ratio = _rng().uniform(*self.aspect_ratio_range) * (w / h)
            nh = int(round(np.sqrt(scale * h * w / ratio)))
            nw = int(round(nh * ratio))
            if nh >= h and nw >= w:
                x0 = _rng().randint(0, nw - w)
                y0 = _rng().randint(0, nh - h)
                return x0, y0, nw, nh
        return None

    def __call__(self, src, label):
        if not self.enabled:
            return src, label
        h, w = src.shape[0], src.shape[1]
        prop = self._propose(h, w)
        if prop is None:
            return src, label
        x0, y0, nw, nh = prop
        arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
        canvas = np.empty((nh, nw, arr.shape[2]), dtype=arr.dtype)
        canvas[...] = np.asarray(self.pad_val, dtype=arr.dtype)
        canvas[y0:y0 + h, x0:x0 + w, :] = arr
        new = label.copy()
        new[:, 1] = (new[:, 1] * w + x0) / nw
        new[:, 2] = (new[:, 2] * h + y0) / nh
        new[:, 3] = (new[:, 3] * w + x0) / nw
        new[:, 4] = (new[:, 4] * h + y0) / nh
        return _host(canvas), new


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """One DetRandomCropAug per parameter tuple, wrapped in a random
    selector (reference `detection.py:CreateMultiRandCropAugmenter`)."""
    covered = min_object_covered if isinstance(min_object_covered, list) \
        else [min_object_covered]
    ratios = aspect_ratio_range if isinstance(aspect_ratio_range, list) \
        else [aspect_ratio_range]
    areas = area_range if isinstance(area_range, list) else [area_range]
    ejects = min_eject_coverage if isinstance(min_eject_coverage, list) \
        else [min_eject_coverage]
    attempts = max_attempts if isinstance(max_attempts, list) \
        else [max_attempts]
    n = max(len(covered), len(ratios), len(areas), len(ejects), len(attempts))

    def _cycle(lst, i):
        return lst[i % len(lst)]

    augs = [DetRandomCropAug(min_object_covered=_cycle(covered, i),
                             aspect_ratio_range=_cycle(ratios, i),
                             area_range=_cycle(areas, i),
                             min_eject_coverage=_cycle(ejects, i),
                             max_attempts=_cycle(attempts, i))
            for i in range(n)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard SSD training augmentation list (reference
    `detection.py:CreateDetAugmenter`)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop_augs = CreateMultiRandCropAugmenter(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0), min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts, skip_prob=1 - rand_crop)
        auglist.append(crop_augs)
    if rand_mirror > 0:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range,
                             (1.0, max(1.0, area_range[1])),
                             max_attempts, pad_val)],
            skip_prob=1 - rand_pad))
    # force resize to the network input
    auglist.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(_img.CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            _img.ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(_img.HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(_img.LightingAug(pca_noise, eigval,
                                                     eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_img.RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(_img.ImageIter):
    """Detection iterator: variable-object labels parsed from the flat wire
    format, padded to a fixed (max_objects, obj_width) label batch with -1
    rows (reference `detection.py:ImageDetIter`)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_pad", "rand_gray",
                         "rand_mirror", "mean", "std", "brightness",
                         "contrast", "saturation", "pca_noise", "hue",
                         "inter_method", "min_object_covered",
                         "aspect_ratio_range", "area_range",
                         "min_eject_coverage", "max_attempts", "pad_val")})
        self.detaug = aug_list
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         label_width=1, path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         num_parts=kwargs.get("num_parts", 1),
                         part_index=kwargs.get("part_index", 0),
                         seed=kwargs.get("seed"),
                         seed_aug=kwargs.get("seed_aug"))
        self.label_shape = self._estimate_label_shape()

    # -- label plumbing ----------------------------------------------------
    @staticmethod
    def _parse_label(label):
        """Flat wire vector -> (n_obj, obj_width) array (reference
        `detection.py:_parse_label`)."""
        if isinstance(label, NDArray):
            label = label.asnumpy()
        label = np.asarray(label, dtype=np.float32)
        if label.ndim == 2:
            return label
        raw = label.ravel()
        if raw.size < 7:
            raise MXNetError("Label shape is invalid: %s" % (raw.shape,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if (raw.size - header_width) % obj_width != 0:
            raise MXNetError("Label shape %s inconsistent with annotation "
                             "width %d." % (raw.shape, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        if not np.any(valid):
            raise MXNetError("Encounter sample with no valid label.")
        return out[valid]

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        for key in self._records:
            raw = self._raw_label(key)
            lab = self._parse_label(raw)
            max_count = max(max_count, lab.shape[0])
            width = lab.shape[1]
        return (max_count, width)

    def _raw_label(self, key):
        if self._mode == "rec":
            from .recordio import unpack
            header, _ = unpack(self._rec.read_idx(key))
            return np.asarray(header.label)
        return np.asarray(self._imglist[key][0])

    @property
    def provide_label(self):
        from .io import DataDesc
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self.label_shape)]

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.label_shape = tuple(label_shape)

    def check_label_shape(self, label_shape):
        if len(label_shape) != 2:
            raise MXNetError("label_shape must be (max_objects, width)")
        if label_shape[1] < self.label_shape[1]:
            raise MXNetError(
                "label_shape width %d smaller than dataset width %d"
                % (label_shape[1], self.label_shape[1]))

    def sync_label_shape(self, it, verbose=False):
        """Take the elementwise-max label shape with another ImageDetIter so
        train/val batches agree (reference `detection.py:sync_label_shape`)."""
        assert isinstance(it, ImageDetIter)
        sync = (max(self.label_shape[0], it.label_shape[0]),
                max(self.label_shape[1], it.label_shape[1]))
        self.reshape(label_shape=sync)
        it.reshape(label_shape=sync)
        return it

    def augmentation_transform(self, data, label):
        for aug in self.detaug:
            data, label = aug(data, label)
        return data, label

    # -- iteration ---------------------------------------------------------
    def _read_sample(self, key):
        if self._mode == "rec":
            from .recordio import unpack
            header, buf = unpack(self._rec.read_idx(key))
            img = _img.imdecode(buf)
            raw = np.asarray(header.label)
        else:
            raw, path = self._imglist[key]
            img = _img.imread(os.path.join(self._root, path))
            raw = np.asarray(raw)
        label = self._parse_label(raw)
        img, label = self.augmentation_transform(img, label)
        arr = img.asnumpy()
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        return arr, label

    def _next_impl(self):
        from .io import DataBatch
        if self._cursor >= len(self._records):
            raise StopIteration
        n_obj, width = self.label_shape
        datas = []
        labels = np.full((self.batch_size, n_obj, width), -1.0,
                         dtype=np.float32)
        pad = 0
        for i in range(self.batch_size):
            if self._cursor + i < len(self._records):
                d, lab = self._read_sample(self._records[self._cursor + i])
                datas.append(d)
                k = min(lab.shape[0], n_obj)
                labels[i, :k, :lab.shape[1]] = lab[:k]
            else:
                datas.append(np.zeros_like(datas[0]))
                pad += 1
        self._cursor += self.batch_size
        data = array(np.stack(datas).astype(np.float32), ctx=self.ctx)
        return DataBatch(data=[data], label=[array(labels, ctx=self.ctx)],
                         pad=pad)
