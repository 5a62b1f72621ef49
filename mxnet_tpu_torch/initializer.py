"""Weight initializers (the counterpart of `mxnet_tpu/initializer.py`;
reference `python/mxnet/initializer.py`): `InitDesc`, the name-suffix
dispatch of `Initializer`, and `Zero`, `One`, `Constant`, `Uniform`,
`Normal`, `Orthogonal`, `Xavier`, `MSRAPrelu`, `Bilinear`, `LSTMBias` and
`Mixed`.

Random draws come from the generator of the array's device
(`mxnet_tpu_torch.random`), so `random.seed` makes initialization
repeatable; the numbers differ from the JAX package's for the same seed.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

from . import random as _random
from . import registry as _registry_mod
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

_INIT_REGISTRY: Dict[str, type] = {}
# the reference's string aliases
_NAME_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    # also listed by `registry.get_registry(Initializer)`, as in the JAX
    # package
    _registry_mod.get_register_func(Initializer, "initializer")(klass)
    return klass


def create(name, **kwargs):
    """An initializer from its name (an instance passes through; no name
    gives `Uniform`); a name registered through
    `registry.get_register_func(Initializer, ...)` resolves too."""
    if isinstance(name, Initializer):
        return name
    if not name:
        return Uniform()
    if isinstance(name, str) and name.startswith(("[", "{")):
        # the JSON spellings (`Initializer.dumps` writes the list one)
        return _registry_mod.get_create_func(Initializer, "initializer")(
            name, **kwargs)
    key = _NAME_ALIASES.get(str(name).lower(), str(name).lower())
    if key in _INIT_REGISTRY:
        return _INIT_REGISTRY[key](**kwargs)
    shared = _registry_mod.get_registry(Initializer)
    if key in shared:
        return shared[key](**kwargs)
    raise MXNetError(f"unknown initializer {name!r}")


class InitDesc(str):
    """A variable's name carrying its symbol attrs and the global
    initializer (reference `initializer.py:34-53`)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix
    (reference `initializer.py:98`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``'["name", {kwargs}]'``, which `create` reads back (reference
        `initializer.py:97-120`)."""
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr: NDArray):
        """A ``__init__`` attr on an `InitDesc` routes to that
        initializer's weight rule; otherwise the suffix decides."""
        if isinstance(name, InitDesc):
            if name.global_init is None:
                name.global_init = self
            init_attr = name.attrs.get("__init__", "")
            if init_attr:
                create(init_attr)._init_weight(str(name), arr)
                return
        self.init_weight_by_name(name, arr)

    def init_weight_by_name(self, name, arr):
        name = name.lower()
        if name.endswith(("bias", "beta")) or "running_mean" in name \
                or "moving_mean" in name:
            self._init_zero(arr)
        elif name.endswith("gamma") or "running_var" in name \
                or "moving_var" in name:
            self._init_one(arr)
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    @staticmethod
    @torch.no_grad()
    def _write(arr: NDArray, value: torch.Tensor):
        arr.data.copy_(value)

    def _init_zero(self, arr):
        self._write(arr, torch.zeros((), device=arr.data.device))

    def _init_one(self, arr):
        self._write(arr, torch.ones((), device=arr.data.device))

    @staticmethod
    def _uniform(arr, low, high, shape=None):
        t = torch.empty(shape or arr.shape, device=arr.data.device)
        return t.uniform_(low, high,
                          generator=_random.generator(arr.data.device))

    @staticmethod
    def _normal(arr, sigma, shape=None):
        t = torch.empty(shape or arr.shape, device=arr.data.device)
        return t.normal_(0.0, sigma,
                         generator=_random.generator(arr.data.device))

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def init_weight_by_name(self, name, arr):
        # an explicit Constant overrides the name-suffix rules
        self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        self._write(arr, torch.as_tensor(self.value, dtype=torch.float32,
                                         device=arr.data.device))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._write(arr, self._uniform(arr, -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._write(arr, self._normal(arr, self.sigma))


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix (Saxe et al.; reference `initializer.py`
    Orthogonal): the SVD factor of a uniform or gaussian draw of shape
    (rows, the product of the other dims) whose shape matches it,
    factorized in float64."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        if self.rand_type == "uniform":
            tmp = self._uniform(arr, -1.0, 1.0, (nout, nin))
        else:
            tmp = self._normal(arr, 1.0, (nout, nin))
        # the factorization in float64: a float32 SVD leaves the factor
        # orthonormal only to about 4e-4 at ResNet-50's shapes
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._write(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Reference `Xavier` (`initializer.py:540`): uniform or gaussian with
    variance magnitude / fan, the fan averaged, in or out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            self._write(arr, self._uniform(arr, -scale, scale))
        else:
            self._write(arr, self._normal(arr, scale))


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: gaussian Xavier with
    magnitude 2 / (1 + slope²) (reference `initializer.py` MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel in every (out, in) slice of a 4-d
    deconvolution weight (reference `initializer.py` Bilinear)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = np.arange(shape[3])
        y = np.arange(shape[2])
        kern = np.outer(1 - np.abs(y / f - c), 1 - np.abs(x / f - c))
        self._write(arr, torch.from_numpy(np.broadcast_to(
            kern.astype(np.float32), shape).copy()).to(arr.data.device))


@register
class LSTMBias(Initializer):
    """An LSTM's 4-gate bias: the forget gate's quarter ``forget_bias``,
    the rest 0 (reference `initializer.py` LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, device=arr.data.device)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        self._write(arr, b)


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)
    initializes it (reference `initializer.py` Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), init) for p, init in
                    zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")
