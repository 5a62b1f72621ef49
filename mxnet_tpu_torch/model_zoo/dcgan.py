"""MXNet's DCGAN as two symbol graphs, following the reference's
``example/gan/dcgan.py`` (apache/incubator-mxnet v1.3, ``make_dcgan_sym``).

`dcgan` returns ``(generator, discriminator)``:

* the generator maps noise ``rand`` (batch, Z, 1, 1) to images (batch, nc,
  64, 64): a 4x4 ``Deconvolution`` to ngf·8 maps at 4x4, then three
  stride-2 4x4 deconvolutions (pad 1) to ngf·4, ngf·2 and ngf maps, each
  followed by ``BatchNorm`` and ReLU, and a last stride-2 deconvolution
  to ``nc`` maps under ``tanh``;
* the discriminator maps images ``data`` to the probability that they are
  real: four stride-2 4x4 ``Convolution``s (pad 1) to ndf, ndf·2, ndf·4
  and ndf·8 maps, each but the first followed by ``BatchNorm``, each by
  ``LeakyReLU`` of slope 0.2, then a 4x4 convolution to one map,
  ``Flatten`` and ``LogisticRegressionOutput`` against ``label`` (batch,).

Every layer takes ``no_bias=True``; the BatchNorms take
``fix_gamma=True`` and ``eps = 1e-5 + 1e-12``, as the reference's.
`DCGAN` holds the example's widths (Z = 100, ngf = ndf = 64, nc = 3) and
its optimizer: Adam with lr 0.0002 and beta1 0.5 over
``init.Normal(0.02)`` weights.  The function takes the ``sym`` namespace
it builds with.
"""
from __future__ import annotations

__all__ = ["DCGAN", "dcgan"]

DCGAN = dict(Z=100, ngf=64, ndf=64, nc=3, image=64, batch=64, lr=0.0002,
             beta1=0.5, sigma=0.02)


def dcgan(sym, ngf=64, ndf=64, nc=3):
    """``(generator, discriminator)`` symbols of the reference's
    ``make_dcgan_sym``."""
    def bn(x, name):
        return sym.BatchNorm(x, name=name, fix_gamma=True, eps=1e-5 + 1e-12)

    rand = sym.Variable("rand")
    g = sym.Deconvolution(rand, name="g1", kernel=(4, 4),
                          num_filter=ngf * 8, no_bias=True)
    g = sym.Activation(bn(g, "gbn1"), name="gact1", act_type="relu")
    for i, mult in ((2, 4), (3, 2), (4, 1)):
        g = sym.Deconvolution(g, name=f"g{i}", kernel=(4, 4), stride=(2, 2),
                              pad=(1, 1), num_filter=ngf * mult,
                              no_bias=True)
        g = sym.Activation(bn(g, f"gbn{i}"), name=f"gact{i}",
                           act_type="relu")
    g = sym.Deconvolution(g, name="g5", kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=nc, no_bias=True)
    gout = sym.Activation(g, name="gact5", act_type="tanh")

    data = sym.Variable("data")
    label = sym.Variable("label")
    d = sym.Convolution(data, name="d1", kernel=(4, 4), stride=(2, 2),
                        pad=(1, 1), num_filter=ndf, no_bias=True)
    d = sym.LeakyReLU(d, name="dact1", act_type="leaky", slope=0.2)
    for i, mult in ((2, 2), (3, 4), (4, 8)):
        d = sym.Convolution(d, name=f"d{i}", kernel=(4, 4), stride=(2, 2),
                            pad=(1, 1), num_filter=ndf * mult,
                            no_bias=True)
        d = sym.LeakyReLU(bn(d, f"dbn{i}"), name=f"dact{i}",
                          act_type="leaky", slope=0.2)
    d = sym.Convolution(d, name="d5", kernel=(4, 4), num_filter=1,
                        no_bias=True)
    d = sym.Flatten(d)
    dloss = sym.LogisticRegressionOutput(data=d, label=label, name="dloss")
    return gout, dloss
