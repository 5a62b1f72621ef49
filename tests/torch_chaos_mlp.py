"""The MLP fit the port's preemption and checkpoint chaos workers share:
`example/image-classification/train_mnist.py`'s ``mlp()`` on its
synthetic digits (the generator copied here, so the workers import
neither JAX nor the JAX package), on the host."""
import numpy as np

import mxnet_tpu_torch as mt


def synthetic_mnist(n=4000, seed=0):
    """train_mnist.py's digit prototypes: 10 fixed random prototypes plus
    per-sample noise and shifts."""
    rs = np.random.RandomState(seed)
    protos = (rs.rand(10, 28, 28) > 0.75).astype(np.float32)
    X = np.zeros((n, 1, 28, 28), np.float32)
    Y = np.zeros((n,), np.float32)
    for i in range(n):
        c = i % 10
        img = protos[c].copy()
        dy, dx = rs.randint(-2, 3, 2)
        img = np.roll(np.roll(img, dy, 0), dx, 1)
        img += rs.randn(28, 28) * 0.35
        X[i, 0] = img
        Y[i] = c
    order = rs.permutation(n)
    return X[order], Y[order]


def mlp():
    sym = mt.sym
    fl = sym.Flatten(sym.var("data"), name="flatten")
    f1 = sym.FullyConnected(fl, num_hidden=128, name="fc1")
    a1 = sym.Activation(f1, act_type="relu", name="relu1")
    f2 = sym.FullyConnected(a1, num_hidden=64, name="fc2")
    a2 = sym.Activation(f2, act_type="relu", name="relu2")
    f3 = sym.FullyConnected(a2, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(f3, sym.var("softmax_label"), name="softmax")


def fit(epochs, **fit_kw):
    """The chaos lanes' deterministic fit on the host; the module."""
    mt.random.seed(42)
    X, Y = synthetic_mnist(200, seed=5)
    it = mt.io.NDArrayIter(X, Y, 50, shuffle=False)
    mod = mt.mod.Module(mlp(), data_names=("data",),
                        label_names=("softmax_label",), context=mt.cpu())
    with mt.cpu():
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier(), **fit_kw)
    return mod
