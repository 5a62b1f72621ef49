"""The random frontends' hand-written wrappers, shared by `nd.random` and
`sym.random` so that the two cannot drift (the counterpart of
`mxnet_tpu/_random_common.py`): ``exponential`` takes the scale and
passes its inverse as the op's rate, ``randn`` takes its shape
positionally, ``shuffle`` permutes the first axis."""
import numbers

__all__ = ["attach_random_wrappers"]


def attach_random_wrappers(target_globals, invoke_fn, target_all=None):
    """Install ``exponential``, ``shuffle`` and ``randn`` bound to
    ``invoke_fn`` into ``target_globals``."""

    def exponential(scale=1.0, shape=None, dtype=None, **kwargs):
        """Samples of the exponential distribution of mean ``scale``
        (rate 1 / scale); a per-element scale is `sample_exponential`."""
        if not isinstance(scale, numbers.Number):
            raise NotImplementedError(
                "exponential with tensor scale: use sample_exponential "
                "(per-element lam) instead")
        kw = {"lam": 1.0 / float(scale), **kwargs}
        if shape is not None:
            kw["shape"] = shape
        if dtype is not None:
            kw["dtype"] = dtype
        return invoke_fn("_random_exponential", **kw)

    def shuffle(data, **kwargs):
        """``data`` with its first axis in a random order."""
        return invoke_fn("_shuffle", data, **kwargs)

    def randn(*shape, loc=0.0, scale=1.0, dtype=None, **kwargs):
        """Normal samples, the shape given positionally."""
        kw = {"loc": loc, "scale": scale, **kwargs}
        if shape:
            kw["shape"] = tuple(shape)
        if dtype is not None:
            kw["dtype"] = dtype
        return invoke_fn("_random_normal", **kw)

    for name, fn in (("exponential", exponential), ("shuffle", shuffle),
                     ("randn", randn)):
        target_globals[name] = fn
        if target_all is not None:
            target_all.append(name)
