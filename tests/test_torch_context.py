"""``with ctx:`` in the port against the JAX package (`mxnet_tpu/context.py`):
nested scopes restore the outer context, `current_context` returns the
open scope, and arrays and a bound Module made inside ``with mt.cpu():``
without a context land on the CPU with the JAX package's values."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def test_nested_scopes_restore_the_outer_context():
    with mx.cpu(1), mt.cpu(1):
        assert mx.current_context() == mx.cpu(1)
        assert mt.current_context() == mt.cpu(1)
        with mx.cpu(2), mt.cpu(2):
            assert mx.current_context() == mx.cpu(2)
            assert mt.current_context() == mt.cpu(2)
        assert mx.current_context() == mx.cpu(1)
        assert mt.current_context() == mt.cpu(1)


def test_current_context_is_the_scope():
    with mt.cpu() as ctx:
        assert mt.current_context() is ctx
        assert mt.context.default_context("test") is ctx
    with mt.cpu_pinned(0):
        assert mt.current_context() == mt.cpu_pinned(0)
        assert mt.current_context().device == torch.device("cpu")
    assert mt.cpu_shared(0) != mt.cpu(0)
    assert mt.num_gpus() == torch.cuda.device_count()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_without_a_scope_the_card_is_required():
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.current_context()
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))


def test_arrays_made_in_a_scope_land_on_its_device():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    with mt.cpu():
        a = mt.nd.array(x)
        z = mt.nd.zeros((2, 3))
        r = mt.nd.random.uniform(shape=(5,))
        e = mt.nd.eye(3)
    for arr in (a, z, r, e):
        assert arr.context == mt.cpu()
        assert arr.data.device == torch.device("cpu")
    with mx.cpu():
        ja = mx.nd.array(x)
    np.testing.assert_array_equal(a.asnumpy(), ja.asnumpy())
    np.testing.assert_array_equal(e.asnumpy(), mx.nd.eye(3).asnumpy())


def test_module_bound_in_a_scope_runs_on_its_device():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 5).astype(np.float32)
    w = rs.randn(3, 5).astype(np.float32)
    b = rs.randn(3).astype(np.float32)

    def forward(pkg):
        data = pkg.sym.var("data")
        net = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
        mod = pkg.mod.Module(net, data_names=("data",), label_names=None)
        mod.bind(data_shapes=[("data", (4, 5))], for_training=False)
        mod.init_params(arg_params={"fc_weight": pkg.nd.array(w),
                                    "fc_bias": pkg.nd.array(b)})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=False)
        return mod, mod.get_outputs()[0]

    with mt.cpu():
        tmod, tout = forward(mt)
    with mx.cpu():
        _, jout = forward(mx)
    assert tmod._exec.arg_dict["fc_weight"].context == mt.cpu()
    assert tout.context == mt.cpu()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-6)
