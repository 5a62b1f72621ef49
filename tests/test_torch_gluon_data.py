"""The port's `gluon.data` against the JAX package's, on the CPU.

Datasets (`ArrayDataset`, `SimpleDataset`, `transform`,
`transform_first`, `filter`, `take`), samplers and `DataLoader`: the same
batches in the same order as the JAX package's under one numpy seed, for
``num_workers`` 0 and 2, every ``last_batch`` mode and a
``batch_sampler``; `pin_memory` batches on the host.  Every transform of
`vision.transforms` on the same image at 1e-5 (the random ones under one
numpy seed, which both packages draw from), and the synthetic MNIST,
FashionMNIST, CIFAR10 and CIFAR100 bit-equal to the JAX package's.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx

TOL = 1e-5
PKGS = {"jax": jx, "torch": tx}


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    return batch.asnumpy()


def _dataset(pkg, n=23):
    rng = np.random.RandomState(0)
    images = (rng.rand(n, 6, 5, 3) * 255).astype(np.uint8)
    labels = np.arange(n, dtype=np.int32)
    return pkg.gluon.data.ArrayDataset(images, labels)


def _epochs(pkg, workers, epochs=2, **kw):
    """Every batch of ``epochs`` passes, with the numpy seed fixed first."""
    tr = pkg.gluon.data.vision.transforms
    data = _dataset(pkg).transform_first(tr.Compose(
        [tr.ToTensor(), tr.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))]))
    loader = pkg.gluon.data.DataLoader(data, num_workers=workers, **kw)
    np.random.seed(7)
    return [_np(b) for _ in range(epochs) for b in loader], len(loader)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            assert gf.shape == wf.shape and gf.dtype == wf.dtype
            np.testing.assert_allclose(gf, wf, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_loader_matches_reference(workers, last_batch):
    """Shuffled batches of 5 of 23 samples over two epochs: the port with
    0 and 2 workers gives the JAX package's batches, in its order."""
    want, n_want = _epochs(jx, 0, batch_size=5, shuffle=True,
                           last_batch=last_batch)
    got, n_got = _epochs(tx, workers, batch_size=5, shuffle=True,
                         last_batch=last_batch)
    assert n_got == n_want
    _same(got, want)
    sizes = [len(b[1]) for b in got]
    assert {"keep": [5, 5, 5, 5, 3] * 2, "discard": [5] * 8,
            "rollover": [5] * 9}[last_batch] == sizes


def test_loader_takes_a_batch_sampler():
    def make(pkg):
        d = pkg.gluon.data
        return d.BatchSampler(d.SequentialSampler(10), 4, "keep")
    for workers in (0, 2):
        want, _ = _epochs(jx, 0, 1, batch_sampler=make(jx))
        got, _ = _epochs(tx, workers, 1, batch_sampler=make(tx))
        _same(got, want)
    with pytest.raises(ValueError):
        tx.gluon.data.DataLoader(_dataset(tx), batch_size=2,
                                 batch_sampler=make(tx))
    with pytest.raises(ValueError):
        tx.gluon.data.DataLoader(_dataset(tx))


def test_batches_live_on_the_host():
    """Samples and batches are host NDArrays (the training loop moves them
    to the card); ``pin_memory`` keeps them there, pinned where a CUDA
    device exists."""
    loader = tx.gluon.data.DataLoader(_dataset(tx), batch_size=4,
                                      pin_memory=True, num_workers=2)
    x, y = next(iter(loader))
    assert x.context == tx.cpu() and y.context == tx.cpu()
    assert x.dtype == tx.nd.array([1.0], ctx=tx.cpu()).dtype
    assert str(y.dtype) == "int32"


def test_workers_overlap_and_stop_early():
    """Two workers fetch two batches at once; a consumer that stops after
    one batch leaves no thread behind."""
    active, peak, lock = [0], [0], threading.Lock()

    class Slow(tx.gluon.data.Dataset):
        def __len__(self):
            return 40

        def __getitem__(self, i):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.02)
            with lock:
                active[0] -= 1
            return np.float32(i)

    before = threading.active_count()
    loader = tx.gluon.data.DataLoader(Slow(), batch_size=2, num_workers=2)
    it = iter(loader)
    np.testing.assert_array_equal(next(it).asnumpy(), [0, 1])
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    assert peak[0] >= 2


def test_worker_errors_reach_the_consumer():
    class Bad(tx.gluon.data.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("sample 3")
            return np.float32(i)

    loader = tx.gluon.data.DataLoader(Bad(), batch_size=2, num_workers=2)
    with pytest.raises(KeyError, match="sample 3"):
        list(loader)


def test_dataset_helpers_match_reference():
    out = {}
    for name, pkg in PKGS.items():
        d = _dataset(pkg, 9)
        odd = d.filter(lambda s: s[1] % 2 == 1)
        first = d.take(3)
        doubled = d.transform(lambda img, lbl: (img * 2, lbl + 100),
                              lazy=False)
        simple = pkg.gluon.data.SimpleDataset(list(range(5)))
        out[name] = ([int(s[1]) for s in odd], len(first),
                     _np(doubled[4][0]), int(doubled[4][1]), simple[3],
                     len(simple))
    assert out["torch"][:2] == out["jax"][:2]
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
    assert out["torch"][3:] == out["jax"][3:]


def _img(dtype=np.uint8, shape=(12, 10, 3), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 255).astype(dtype)


def _transforms(tr):
    return {
        "cast": tr.Cast("float16"),
        "to_tensor": tr.ToTensor(),
        "normalize": tr.Compose([tr.ToTensor(),
                                 tr.Normalize((0.1, 0.2, 0.3),
                                              (0.5, 0.6, 0.7))]),
        "resize": tr.Resize((7, 5)),
        "resize_keep_ratio": tr.Resize(6, keep_ratio=True),
        "center_crop": tr.CenterCrop(6),
        "center_crop_resize": tr.CenterCrop((14, 11)),
        "random_resized_crop": tr.RandomResizedCrop(8),
        "flip_left_right": tr.RandomFlipLeftRight(),
        "flip_top_bottom": tr.RandomFlipTopBottom(),
        "brightness": tr.RandomBrightness(0.4),
        "contrast": tr.RandomContrast(0.4),
        "saturation": tr.RandomSaturation(0.4),
        "hue": tr.RandomHue(0.2),
        "color_jitter": tr.RandomColorJitter(0.3, 0.3, 0.3, 0.1),
        "lighting": tr.RandomLighting(0.1),
    }


RESIZING = {"resize", "resize_keep_ratio", "center_crop_resize",
            "random_resized_crop"}


@pytest.mark.parametrize("name", sorted(_transforms(
    tx.gluon.data.vision.transforms)))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_transform_matches_reference(name, dtype):
    """Three draws of each transform under one numpy seed, on an image
    given as numpy (which both packages read as float32, as `nd.array`
    does) and as an NDArray of its own dtype, at 1e-5 (of 255 for images
in [0, 255]); a resized uint8 image within one step at under 1 % of its
values, where the float product lies at a rounding tie."""
    got = {}
    for key, pkg in PKGS.items():
        t = _transforms(pkg.gluon.data.vision.transforms)[name]
        np.random.seed(3)
        src = _img(dtype)
        arr = tx.nd.array(src, ctx=tx.cpu(), dtype=dtype) if pkg is tx \
            else jx.nd.array(src, dtype=dtype)
        got[key] = [t(src).asnumpy() for _ in range(3)] + \
            [t(arr).asnumpy() for _ in range(3)]
    for g, w in zip(got["torch"], got["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.uint8 and name in RESIZING:
            # a resized value at a rounding tie (x.5 within float
            # rounding) may round either way: one step, rarely
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * 255)


@pytest.mark.parametrize("name,kw", [("MNIST", {}), ("FashionMNIST", {}),
                                     ("CIFAR10", {}),
                                     ("CIFAR100", {}),
                                     ("CIFAR100", {"fine_label": True})])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_datasets_are_bit_equal(name, kw, train, tmp_path):
    """With no files under ``root``, each dataset holds the JAX package's
    synthetic samples, bit for bit; a transform applies to each sample."""
    make = {k: getattr(p.gluon.data.vision, name) for k, p in PKGS.items()}
    root = str(tmp_path / "none")
    j = make["jax"](root=root, train=train, **kw)
    t = make["torch"](root=root, train=train, **kw)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    assert t._data.dtype == j._data.dtype
    img, lbl = t[5]
    assert img.shape == j[5][0].shape and lbl == j[5][1]
    tt = make["torch"](root=root, train=train,
                       transform=lambda d, l: (d.astype(np.float32), l + 1),
                       **kw)
    assert tt[5][1] == lbl + 1


def test_mnist_reads_the_standard_files(tmp_path):
    """The idx-ubyte files under ``root`` are read as the JAX package
    reads them."""
    import gzip
    import struct
    rng = np.random.RandomState(0)
    images = (rng.rand(7, 28, 28) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + images.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labels.tobytes())
    t = tx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)
    j = jx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    assert len(t) == 7
