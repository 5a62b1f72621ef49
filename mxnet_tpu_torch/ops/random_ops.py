"""Random sampling ops (the counterpart of `mxnet_tpu/ops/random_ops.py`;
reference `src/operator/random/sample_op.cc`, `multisample_op.cc`,
`sample_multinomial_op.cc`, `shuffle_op.cc`).

Every draw comes from the `torch.Generator` the caller hands the op (the
registry's ``needs_rng``): `nd` passes the generator of the device the op
runs on (`random.generator`), an executor its context's, so
``random.seed(s)`` makes a rerun bit-equal on the same device.  The
samplers are torch's own on that device (``normal_``, ``uniform_``,
``exponential_``, ``randint``, ``torch.poisson``, ``torch._standard_gamma``,
``torch.multinomial``, ``randperm``): nothing goes through the host.

The distributions and their parameters are the JAX package's: ``gamma``
with shape ``alpha`` and scale ``beta``; ``exponential`` with rate
``lam``; ``negative_binomial(k, p)`` and
``generalized_negative_binomial(mu, alpha)`` as gamma-Poisson mixtures;
``randint`` on the half-open [low, high), int32 by default; the
``*_like`` forms shaped and typed like their input; the ``sample_*``
forms with per-element parameter arrays, whose output shape is the
parameters' shape followed by ``shape``.  The streams are torch's Philox
(CUDA) and Mersenne Twister (CPU), not JAX's threefry, so the two packages
agree in distribution, not in values.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import DEVICE, alias, register


def _shape(attrs):
    return tuple(int(s) for s in (attrs.get_tuple("shape", ()) or ()))


def _where(attrs, default=torch.float32):
    return dict(device=attrs.get(DEVICE),
                dtype=attrs.get_dtype("dtype", default))


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def _gamma(alpha, gen):
    """Standard gamma draws of the shape tensor ``alpha`` (float32 or
    wider)."""
    if alpha.device.type == "meta":
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha.contiguous(), generator=gen)


def _poisson(lam, gen):
    if lam.device.type == "meta":
        return torch.empty_like(lam)
    return torch.poisson(lam.contiguous(), generator=gen)


def _negbin(gen, k, p):
    """Negative binomial(k, p) as Poisson(Gamma(k) (1 - p) / p), of the
    broadcast parameter tensors."""
    return _poisson(_gamma(k, gen) * (1.0 - p) / p, gen)


def _gen_negbin(gen, mu, alpha):
    """Mean ``mu``, dispersion ``alpha``: Poisson(Gamma(1/alpha) mu
    alpha)."""
    return _poisson(_gamma(1.0 / alpha, gen) * (mu * alpha), gen)


def _full(value, shape, device, dtype=torch.float32):
    return torch.full(shape, float(value), device=device, dtype=dtype)


# -- parameter checks (reference sample_op.h CHECKs) -------------------------

def _check(ok, msg):
    if not ok:
        raise MXNetError(msg)


def _uniform_draw(gen, shape, where, low, high):
    out = torch.empty(shape, **where)
    return out if _meta(out.device) else out.uniform_(low, high,
                                                      generator=gen)


def _normal_draw(gen, shape, where, loc, scale):
    _check(scale > 0, f"normal: scale (standard deviation) must be "
           f"positive, got {scale}")
    out = torch.empty(shape, **where)
    return out if _meta(out.device) else out.normal_(loc, scale,
                                                     generator=gen)


def _exponential_draw(gen, shape, where, lam):
    _check(lam > 0, "exponential: lam must be positive")
    out = torch.empty(shape, **where)
    return out if _meta(out.device) else out.exponential_(lam,
                                                          generator=gen)


def _gamma_draw(gen, shape, where, alpha, beta):
    _check(alpha > 0 and beta > 0, "gamma: alpha and beta must be positive")
    a = _full(alpha, shape, where["device"])
    return (beta * _gamma(a, gen)).to(where["dtype"])


def _poisson_draw(gen, shape, where, lam):
    _check(lam >= 0, "poisson: lam must be non-negative")
    return _poisson(_full(lam, shape, where["device"]), gen).to(
        where["dtype"])


def _negbin_draw(gen, shape, where, k, p):
    _check(k > 0 and 0.0 < p <= 1.0,
           "negative_binomial: need k > 0 and 0 < p <= 1")
    dev = where["device"]
    return _negbin(gen, _full(k, shape, dev), _full(p, shape, dev)).to(
        where["dtype"])


def _gen_negbin_draw(gen, shape, where, mu, alpha):
    dev = where["device"]
    return _gen_negbin(gen, _full(mu, shape, dev),
                       _full(alpha, shape, dev)).to(where["dtype"])


# the draws by distribution: (attr names with defaults, draw)
_DISTS = {
    "uniform": ((("low", 0.0), ("high", 1.0)), _uniform_draw),
    "normal": ((("loc", 0.0), ("scale", 1.0)), _normal_draw),
    "gamma": ((("alpha", 1.0), ("beta", 1.0)), _gamma_draw),
    "exponential": ((("lam", 1.0),), _exponential_draw),
    "poisson": ((("lam", 1.0),), _poisson_draw),
    "negative_binomial": ((("k", 1), ("p", 1.0)), _negbin_draw),
    "generalized_negative_binomial": ((("mu", 1.0), ("alpha", 1.0)),
                                      _gen_negbin_draw),
}


def _params(attrs, names):
    return [attrs.get_int(n, d) if isinstance(d, int) else
            attrs.get_float(n, d) for n, d in names]


def _sampler(dist):
    names, draw = _DISTS[dist]

    def compute(attrs, gen, _names=names, _draw=draw):
        return _draw(gen, _shape(attrs), _where(attrs),
                     *_params(attrs, _names))
    compute.__doc__ = (f"Samples of the {dist} distribution "
                       f"({', '.join(n for n, _ in names)}) of ``shape``.")
    register(f"_random_{dist}", num_inputs=0, needs_rng=True,
             attr_names=[n for n, _ in names] + ["shape", "dtype"])(compute)

    def like(attrs, gen, data, _names=names, _draw=draw):
        return _draw(gen, tuple(data.shape),
                     dict(device=data.device, dtype=data.dtype),
                     *_params(attrs, _names))
    like.__doc__ = (f"Samples of the {dist} distribution shaped and typed "
                    "like ``data``.")
    # uniform and normal register their _like form under the short name,
    # as the JAX package does (the others under the ``_random_`` one)
    like_name = f"{dist}_like" if dist in ("uniform", "normal") \
        else f"_random_{dist}_like"
    register(like_name, num_inputs=1, input_names=["data"],
             needs_rng=True)(like)


for _dist in _DISTS:
    _sampler(_dist)


@register("_random_randint", num_inputs=0, needs_rng=True,
          attr_names=["low", "high", "shape", "dtype"])
def _randint(attrs, gen):
    """Integers uniform on [low, high), int32 unless ``dtype`` says
    otherwise."""
    where = _where(attrs, torch.int32)
    shape = _shape(attrs)
    if _meta(where["device"]):
        return torch.empty(shape, **where)
    return torch.randint(attrs.get_int("low", 0), attrs.get_int("high"),
                         shape, generator=gen, **where)


alias("_random_uniform", "uniform", "random_uniform")
alias("_random_normal", "normal", "random_normal")
alias("_random_gamma", "random_gamma")
alias("_random_exponential", "random_exponential")
alias("_random_poisson", "random_poisson")
alias("_random_randint", "randint", "random_randint")
alias("_random_negative_binomial", "negative_binomial",
      "random_negative_binomial")
alias("_random_generalized_negative_binomial",
      "generalized_negative_binomial",
      "random_generalized_negative_binomial")
alias("uniform_like", "_random_uniform_like")
alias("normal_like", "_random_normal_like")
alias("_random_exponential_like", "exponential_like")
alias("_random_gamma_like", "gamma_like")
alias("_random_poisson_like", "poisson_like")
alias("_random_negative_binomial_like", "negative_binomial_like")
alias("_random_generalized_negative_binomial_like",
      "generalized_negative_binomial_like")


@register("_sample_multinomial", num_inputs=1, input_names=["data"],
          needs_rng=True,
          num_outputs=lambda a: 2 if a.get_bool("get_prob", False) else 1)
def _multinomial(attrs, gen, data):
    """Draws from the categorical distribution of each row of ``data``
    (probabilities on the last axis): ``shape`` draws per row, the output
    ``data.shape[:-1] + shape`` (int32 by default).  With ``get_prob`` a
    second output holds each draw's log-probability, in the input's dtype
    and differentiable with respect to ``data`` (the REINFORCE path,
    reference `sample_multinomial_op.h`)."""
    shape = _shape(attrs)
    n = max(math.prod(shape), 1)
    dtype = attrs.get_dtype("dtype", torch.int32)
    rows = data.reshape(-1, data.shape[-1])
    if data.device.type == "meta":
        flat = torch.empty((rows.shape[0], n), dtype=torch.int64,
                           device="meta")
    else:
        flat = torch.multinomial(rows.detach().float(), n, replacement=True,
                                 generator=gen)

    def final(x):
        return x.reshape(tuple(data.shape[:-1]) + shape)

    out = final(flat).to(dtype)
    if not attrs.get_bool("get_prob", False):
        return out
    logp = torch.log(torch.clamp_min(rows, 1e-37)).gather(1, flat)
    return out, final(logp).to(data.dtype)


alias("_sample_multinomial", "sample_multinomial", "multinomial")


@register("_shuffle", num_inputs=1, input_names=["data"], needs_rng=True)
def _shuffle(attrs, gen, data):
    """``data`` with its first axis in a random order."""
    if data.device.type == "meta" or data.dim() == 0:
        return data.clone()
    return data[torch.randperm(data.shape[0], generator=gen,
                               device=data.device)]


alias("_shuffle", "shuffle")


# ---------------------------------------------------------------------------
# per-element parameterised samplers (`multisample_op.cc`)
# ---------------------------------------------------------------------------

def _multisample(dist, nin, draw):
    def compute(attrs, gen, *params, _draw=draw):
        shape = _shape(attrs)
        out_shape = tuple(params[0].shape) + shape
        grown = [p.to(torch.float32).reshape(
            tuple(p.shape) + (1,) * len(shape)).expand(out_shape)
            for p in params]
        out = _draw(gen, out_shape, *grown)
        return out.to(attrs.get_dtype("dtype", torch.float32))
    compute.__doc__ = (f"The {dist} distribution with one parameter set "
                       "per element of the parameter arrays; the output "
                       "is their shape followed by ``shape``.")
    register(f"sample_{dist}", num_inputs=nin, needs_rng=True)(compute)


def _unit(gen, shape, like, method):
    """Standard draws (``uniform_``, ``normal_`` or ``exponential_`` at
    their defaults) of ``shape`` on ``like``'s device."""
    out = torch.empty(shape, dtype=torch.float32, device=like.device)
    return out if out.device.type == "meta" else \
        getattr(out, method)(generator=gen)


_multisample("uniform", 2, lambda g, s, lo, hi:
             lo + _unit(g, s, lo, "uniform_") * (hi - lo))
_multisample("normal", 2, lambda g, s, mu, sig:
             mu + sig * _unit(g, s, mu, "normal_"))
_multisample("gamma", 2, lambda g, s, a, b: b * _gamma(a, g))
_multisample("exponential", 1, lambda g, s, lam:
             _unit(g, s, lam, "exponential_") / lam)
_multisample("poisson", 1, lambda g, s, lam: _poisson(lam, g))
_multisample("negative_binomial", 2, lambda g, s, k, p: _negbin(g, k, p))
_multisample("generalized_negative_binomial", 2,
             lambda g, s, mu, alpha: _gen_negbin(g, mu, alpha))
