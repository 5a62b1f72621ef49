"""gluon.contrib.nn (the counterpart of `mxnet_tpu/gluon/contrib/nn.py`;
reference `python/mxnet/gluon/contrib/nn/basic_layers.py`):
Concurrent/HybridConcurrent containers, Identity, SparseEmbedding,
SyncBatchNorm, PixelShuffle1D/2D/3D."""
from __future__ import annotations

from ..block import Block, HybridBlock
from ..nn.basic_layers import BatchNorm, Embedding

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Block):
    """Parallel branches, outputs concatenated (reference
    `contrib/nn:Concurrent`)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        out = [child(x) for child in self._children.values()]
        from ...ndarray import concat_nd
        return concat_nd(out, axis=self.axis)


class HybridConcurrent(HybridBlock):
    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        outs = [child(x) for child in self._children.values()]
        return F.Concat(*outs, dim=self.axis, num_args=len(outs))

    # children manage their own params; forward dispatch needs overriding
    def forward(self, x):
        from ...symbol.symbol import Symbol
        if isinstance(x, Symbol):
            from ... import symbol as F
            return self.hybrid_forward(F, x)
        from ... import ndarray as F
        return self.hybrid_forward(F, x)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x

    def forward(self, x):
        return x


class SparseEmbedding(Block):
    """Embedding for large vocabularies (reference
    `contrib/nn:SparseEmbedding`, whose gradient is row_sparse): the
    lookup and its gradient are dense here, as in the JAX package; the
    gradient is nonzero only on the rows the batch touched, so a lazy
    optimizer update and a dense one agree there."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._inner = Embedding(input_dim, output_dim, dtype=dtype,
                                weight_initializer=weight_initializer)
        self.register_child(self._inner)

    def forward(self, x):
        return self._inner(x)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference `contrib/sync_batch_norm.cc`), on
    the `_contrib_SyncBatchNorm` op: in training, inside a map over the
    data-parallel axis ``dp`` (`parallel.shard_map`) the batch moments are
    averaged over it; under `SPMDTrainer` they are the whole batch's, as
    a BatchNorm's; elsewhere they are the local batch's.
    ``num_devices``, ``ndev`` and ``key`` are accepted for the reference's
    signature.
    """

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        kwargs.pop("ndev", None)
        kwargs.pop("key", None)
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.contrib.SyncBatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis_name="dp")


class PixelShuffle1D(HybridBlock):
    """Sub-pixel upsampling on (N, C*f, W) -> (N, C, W*f) (reference
    `contrib/nn:PixelShuffle1D`)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        x = F.reshape(x, shape=(0, -4, -1, f, 0))   # N, C, f, W
        x = F.transpose(x, axes=(0, 1, 3, 2))       # N, C, W, f
        x = F.reshape(x, shape=(0, 0, -3))          # N, C, W*f
        return x

    def __repr__(self):
        return f"{self.__class__.__name__}({self._factor})"


class PixelShuffle2D(HybridBlock):
    """Sub-pixel upsampling (reference `contrib/nn:PixelShuffle2D`)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factor
        # shape-free magic-reshape spec (works for Symbol too): split C into
        # (C/(f1*f2), f1, f2), interleave with H/W, merge back
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))      # B,C',f1f2,H,W
        x = F.reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))        # B,C',f1,f2,H,W
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))             # B,C',H,f1,W,f2
        x = F.reshape(x, shape=(0, 0, -3, -3))                  # B,C',H*f1,W*f2
        return x


class PixelShuffle3D(HybridBlock):
    """Sub-pixel upsampling on (N, C*f1*f2*f3, D, H, W) ->
    (N, C, D*f1, H*f2, W*f3) (reference `contrib/nn:PixelShuffle3D`).
    One split, one 8-D transpose and one merge instead of the
    reference's swapaxes chain."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factors = ((int(factor),) * 3 if isinstance(factor, int)
                         else tuple(int(f) for f in factor))

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2 * f3, 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f1, f2 * f3, 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, 0, -4, f2, f3, 0, 0, 0))
        # (N, C, f1, f2, f3, D, H, W) -> (N, C, D, f1, H, f2, W, f3)
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        x = F.reshape(x, shape=(0, 0, -3, -3, -3))
        return x

    def __repr__(self):
        return f"{self.__class__.__name__}({self._factors})"
