"""The port's `DeviceFeed` (`mxnet_tpu_torch.parallel.feed`) against the
JAX package's (`tests/test_device_feed.py`): batches placed ahead on a
feeder thread (on a side stream on the card), epochs rolling through
StopIteration and reset, errors re-raised at the consumer, and training
through the feed equal to placing inline, and to the JAX package's feed
on the same weights."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jgloss

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.parallel.sharding import ShardedTensor

import torch_spmd_worker as W

CPU = mt.cpu()
WEIGHTS = W.mlp_weights(5, 9, widths=(16, 3))


def _trainer():
    net = W.gluon_mlp(mt, WEIGHTS, prefix="dfmlp_", ctx=CPU)
    return par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.1),
                           gloss.SoftmaxCrossEntropyLoss())


def test_device_feed_trains_and_rolls_epochs():
    rng = np.random.RandomState(0)
    X = rng.randn(40, 5).astype(np.float32)
    y = (np.arange(40) % 3).astype(np.float32)
    with CPU:
        it = mt.io.NDArrayIter(X, y, batch_size=8)
        tr = _trainer()
        feed = par.DeviceFeed(it, tr, depth=2)
        steps, losses = 0, []
        for _ in range(3):
            for xd, yd in feed:
                losses.append(tr.step(xd, yd))
                steps += 1
    assert steps == 15
    assert np.isfinite(float(losses[-1]))
    # staged inputs are placed blocks on the mesh's device
    assert isinstance(xd, ShardedTensor) and not isinstance(xd,
                                                            mt.nd.NDArray)
    assert xd.local.device.type == "cpu" and xd.shape == (8, 5)


def test_device_feed_equals_direct_steps():
    """Training through the feed equals placing inline bit for bit, and
    follows the JAX package's feed on the same weights and batches."""
    rng = np.random.RandomState(1)
    X = rng.randn(24, 5).astype(np.float32)
    y = (np.arange(24) % 3).astype(np.float32)
    with CPU:
        tr1 = _trainer()
        for i in range(0, 24, 8):
            tr1.step(*tr1.place_inputs(X[i:i + 8], y[i:i + 8]))
        tr2 = _trainer()
        for xd, yd in par.DeviceFeed(mt.io.NDArrayIter(X, y, batch_size=8),
                                     tr2):
            tr2.step(xd, yd)
    for k in tr1.params:
        np.testing.assert_array_equal(np.asarray(tr1.params[k]),
                                      np.asarray(tr2.params[k]), err_msg=k)
    jnet = W.gluon_mlp(mx, WEIGHTS, prefix="dfmlp_")
    jtr = jpar.SPMDTrainer(jnet, mx.optimizer.SGD(learning_rate=0.1),
                           jgloss.SoftmaxCrossEntropyLoss())
    for xd, yd in jpar.DeviceFeed(mx.io.NDArrayIter(X, y, batch_size=8),
                                  jtr):
        jtr.step(xd, yd)
    for k in tr2.params:
        np.testing.assert_allclose(np.asarray(tr2.params[k]),
                                   np.asarray(jtr.params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_device_feed_propagates_errors():
    class Boom:
        def reset(self):
            pass

        def __next__(self):
            raise RuntimeError("decode exploded")

    with CPU:
        feed = par.DeviceFeed(Boom(), _trainer())
        with pytest.raises(RuntimeError, match="decode exploded"):
            next(feed)
