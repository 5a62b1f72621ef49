"""Vision transforms (the counterpart of
`mxnet_tpu/gluon/data/vision/transforms.py`; reference
`python/mxnet/gluon/data/vision/transforms.py`).

Transforms are Blocks over single samples (HWC images); they run on the
host, inside the DataLoader's workers, through the registered image ops
(`ops/image_ops.py`).  The random ones draw from numpy's global
generator, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np

from ....context import cpu
from ....ndarray.ndarray import NDArray, array
from ....ndarray.register import invoke
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


def _as_nd(x):
    return x if isinstance(x, NDArray) else array(x, ctx=cpu())


class Compose(Sequential):
    """Transforms applied in turn (reference `transforms.py:Compose`)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.register_child(t)

    def forward(self, x):
        for child in self._children.values():
            x = child(x)
        return x


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _as_nd(x).astype(self._dtype)


class ToTensor(Block):
    """HWC [0, 255] to CHW float32 [0, 1] (reference `ToTensor`)."""

    def forward(self, x):
        x = _as_nd(x)
        return invoke("_image_to_tensor", x)


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def forward(self, x):
        return invoke("_image_normalize", _as_nd(x), mean=self._mean,
                      std=self._std)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        return invoke("_image_resize", _as_nd(x), size=self._size,
                      keep_ratio=self._keep)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)

    def forward(self, x):
        x = _as_nd(x)
        h, w = x.shape[0], x.shape[1]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        out = x[y0:y0 + ch, x0:x0 + cw, :]
        if out.shape[0] != ch or out.shape[1] != cw:
            out = invoke("_image_resize", out, size=self._size)
        return out


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _as_nd(x)
        h, w = x.shape[0], x.shape[1]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.exp(np.random.uniform(np.log(self._ratio[0]),
                                              np.log(self._ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = np.random.randint(0, w - cw + 1)
                y0 = np.random.randint(0, h - ch + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw, :]
                return invoke("_image_resize", crop, size=self._size)
        return CenterCrop(self._size)(x)


class _RandomApply(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p


class RandomFlipLeftRight(_RandomApply):
    def forward(self, x):
        x = _as_nd(x)
        if np.random.rand() < self._p:
            return invoke("_image_flip_left_right", x)
        return x


class RandomFlipTopBottom(_RandomApply):
    def forward(self, x):
        x = _as_nd(x)
        if np.random.rand() < self._p:
            return invoke("_image_flip_top_bottom", x)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return invoke("_image_adjust_lighting_scale", _as_nd(x), alpha=alpha)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return invoke("_image_adjust_contrast", _as_nd(x), alpha=alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return invoke("_image_adjust_saturation", _as_nd(x), alpha=alpha)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._args = (-hue, hue)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return invoke("_image_adjust_hue", _as_nd(x), alpha=alpha)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i](x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise (reference
    `transforms.py:RandomLighting`)."""

    _eigval = np.array([55.46, 4.794, 1.148])
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha_std=0.05):
        super().__init__()
        self._alpha_std = alpha_std

    def forward(self, x):
        x = _as_nd(x)
        alpha = np.random.normal(0, self._alpha_std, 3)
        rgb = (self._eigvec * alpha) @ self._eigval
        return x + array(rgb.astype(np.float32), ctx=x.context)
