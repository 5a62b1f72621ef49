"""Vision datasets (the counterpart of
`mxnet_tpu/gluon/data/vision/datasets.py`; reference
`python/mxnet/gluon/data/vision/datasets.py`).

The standard files are read where they exist under ``root``; nothing is
downloaded.  Otherwise each dataset holds the JAX package's deterministic
synthetic samples (numpy from fixed seeds, the real shapes and label
counts, bit-equal to the JAX package's).  Samples are numpy HWC uint8
images and int32 labels.  `ImageFolderDataset` and `ImageRecordDataset`
decode their images with `image.imdecode` into CPU NDArrays.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def synthetic_mnist_arrays():
    """The synthetic MNIST as (n, 1, 28, 28) float32 in [0, 1] and float32
    labels (the JAX package's recipe for `io.MNISTIter`)."""
    img, lbl = _synthetic((28, 28, 1), 10, 8192, seed=42)
    img = (img[:, :, :, 0].astype(np.float32) / 255.0)[:, None, :, :]
    return img, lbl.astype(np.float32)


def _synthetic(shape, num_classes, n, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    # each class's images are shifted by its own offset, so that a short
    # training run can separate them
    for c in range(num_classes):
        mask = label == c
        data[mask] = np.clip(
            data[mask].astype(np.int32) + (c - num_classes // 2) * 8,
            0, 255).astype(np.uint8)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST (reference `datasets.py:MNIST`, idx-ubyte file format)."""

    _shape = (28, 28, 1)
    _classes = 10
    _files = {True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
              False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        image_file, label_file = (os.path.join(self._root, f)
                                  for f in self._files[self._train])
        if os.path.exists(image_file) and os.path.exists(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(image_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        else:
            data, label = _synthetic(self._shape, self._classes,
                                     8192 if self._train else 1024, seed=42)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (reference `datasets.py:CIFAR10`, binary batch format)."""

    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3072 + 1)
        return (rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                rec[:, 0].astype(np.int32))

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            parts = [self._read_batch(f) for f in files]
            self._data = np.concatenate([p[0] for p in parts])
            self._label = np.concatenate([p[1] for p in parts])
        else:
            self._data, self._label = _synthetic(
                self._shape, self._classes,
                8192 if self._train else 1024, seed=7)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        f = os.path.join(self._root, "train.bin" if self._train else "test.bin")
        if os.path.exists(f):
            with open(f, "rb") as fin:
                raw = np.frombuffer(fin.read(), dtype=np.uint8)
            rec = raw.reshape(-1, 3072 + 2)
            self._data = rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            self._label = rec[:, 1 if self._fine_label else 0].astype(np.int32)
        else:
            self._data, self._label = _synthetic(
                self._shape, 100 if self._fine_label else 20,
                8192 if self._train else 1024, seed=11)


class ImageFolderDataset(Dataset):
    """The images of ``root/<class>/*.jpg|jpeg|png``, labelled by their
    folder's position in sorted order (reference
    `datasets.py:ImageFolderDataset`)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """``(image, label)`` of each record of a RecordIO file of packed
    images (reference `datasets.py:ImageRecordDataset`)."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image import imdecode
        from ....recordio import unpack
        header, img = unpack(self._record.read_idx(self._record.keys[idx]))
        img = imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label

    def __len__(self):
        return len(self._record.keys)
