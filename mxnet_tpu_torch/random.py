"""Random streams (the counterpart of `mxnet_tpu/random.py`).

MXNet seeds one generator per device (`mx.random.seed`); here each device
has one `torch.Generator`, created at first use from the current seed.
Ops that draw random numbers (Dropout's masks, the initializers) take the
generator of the device they run on.  The streams are torch's Philox and
Mersenne Twister, not JAX's threefry: the same seed gives other numbers
than the JAX package, so stochastic ops are compared by their
statistics.

`get_state` / `set_state` snapshot and restore the seed and every
device's generator (a CUDA generator's state is its seed and Philox
offset, which each replay of a captured graph advances), as JSON for a
checkpoint manifest.  A state is this package's own: the JAX package's
(a threefry key) is refused.
"""
from __future__ import annotations

import base64
import threading
from typing import Dict, Optional, Union

import torch

from .base import MXNetError
from .context import Context

__all__ = ["seed", "current_seed", "generator", "get_state", "set_state"]

#: the key under which `get_state` keeps the generators' states
_STATE_KEY = "torch_generators"


class _Streams:
    """The seed and the per-device generators, guarded by one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seed = 0
        self.generators: Dict[torch.device, torch.Generator] = {}


_STREAMS = _Streams()


def _device(ctx: Union[Context, torch.device, str]) -> torch.device:
    if isinstance(ctx, Context):
        return ctx.device
    device = torch.device(ctx)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state: int, ctx: Union[str, Context] = "all") -> None:
    """Reseed the generators (reference `mx.random.seed`): every device's
    with ``ctx="all"``, else only the one of ``ctx``."""
    seed_state = int(seed_state)
    with _STREAMS.lock:
        if ctx == "all":
            _STREAMS.seed = seed_state
            for gen in _STREAMS.generators.values():
                gen.manual_seed(seed_state)
        else:
            device = _device(ctx)
            gen = _STREAMS.generators.get(device)
            if gen is None:
                gen = _STREAMS.generators[device] = torch.Generator(
                    device=device)
            gen.manual_seed(seed_state)
    # the resource manager's streams follow (reference
    # `ResourceManager::SeedRandom`)
    from . import resource
    resource.seed(seed_state, ctx=None if ctx == "all" else ctx)


def current_seed() -> int:
    return _STREAMS.seed


def generator(device: Optional[Union[Context, torch.device, str]] = None
              ) -> torch.Generator:
    """The generator of ``device`` (the CPU when none is given)."""
    device = _device(device if device is not None else "cpu")
    with _STREAMS.lock:
        gen = _STREAMS.generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_STREAMS.seed)
            _STREAMS.generators[device] = gen
        return gen


def get_state() -> dict:
    """The seed and each device generator's state, JSON-serializable."""
    with _STREAMS.lock:
        gens = {str(dev): base64.b64encode(
            gen.get_state().numpy().tobytes()).decode("ascii")
            for dev, gen in _STREAMS.generators.items()}
        return {"seed": int(_STREAMS.seed), _STATE_KEY: gens}


def set_state(state: dict) -> None:
    """Restore a `get_state` snapshot: the saved devices' generators
    continue where they were, the others start over from the seed (as
    they would have started in the saved run)."""
    if _STATE_KEY not in state:
        raise MXNetError("random.set_state: not a state of this package "
                         "(the JAX package's threefry key cannot drive "
                         "torch's generators)")
    saved = state[_STATE_KEY]
    with _STREAMS.lock:
        _STREAMS.seed = int(state.get("seed", 0))
        for dev, gen in _STREAMS.generators.items():
            if str(dev) not in saved:
                gen.manual_seed(_STREAMS.seed)
        for dev_str, raw in saved.items():
            device = _device(dev_str)
            gen = _STREAMS.generators.get(device)
            if gen is None:
                gen = _STREAMS.generators[device] = torch.Generator(
                    device=device)
            gen.set_state(torch.frombuffer(bytearray(base64.b64decode(raw)),
                                           dtype=torch.uint8))


def _delegate(name):
    def f(*args, **kwargs):
        from .ndarray import random as _ndr
        return getattr(_ndr, name)(*args, **kwargs)
    f.__name__ = name
    f.__doc__ = f"`nd.random.{name}`."
    return f


# the samplers of `nd.random` at the top of the package (`mx.random.normal`)
for _name in ("uniform", "normal", "randn", "randint", "poisson",
              "exponential", "gamma", "multinomial", "shuffle",
              "negative_binomial", "generalized_negative_binomial"):
    globals()[_name] = _delegate(_name)
    __all__.append(_name)
del _name
