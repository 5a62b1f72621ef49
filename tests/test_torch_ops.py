"""Each op of the port's encoder path against the JAX package's
`registry.apply_op` on the same inputs, at 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg

from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-5


def _randn(*shape):
    return ("randn", shape)


def _ids(high, *shape):
    return ("ids", high, shape)


# (op, inputs, attrs); attrs are given as the strings Symbol JSON carries
# where the spelling matters to the parser
CASES = {
    "fc_flatten": ("FullyConnected",
                   [_randn(4, 3, 5), _randn(6, 15), _randn(6)],
                   {"num_hidden": 6}),
    "fc_no_flatten": ("FullyConnected",
                      [_randn(4, 3, 5), _randn(6, 5), _randn(6)],
                      {"num_hidden": 6, "flatten": "False"}),
    "fc_no_bias": ("FullyConnected", [_randn(4, 5), _randn(6, 5)],
                   {"num_hidden": 6, "no_bias": True}),
    "act_relu": ("Activation", [_randn(3, 4)], {"act_type": "relu"}),
    "act_sigmoid": ("Activation", [_randn(3, 4)], {"act_type": "sigmoid"}),
    "act_tanh": ("Activation", [_randn(3, 4)], {"act_type": "tanh"}),
    "act_softrelu": ("Activation", [_randn(3, 4)], {"act_type": "softrelu"}),
    "act_softsign": ("Activation", [_randn(3, 4)], {"act_type": "softsign"}),
    "leaky": ("LeakyReLU", [_randn(2, 4, 3)],
              {"act_type": "leaky", "slope": 0.1}),
    "leaky_elu": ("LeakyReLU", [_randn(2, 4, 3)], {"act_type": "elu"}),
    "leaky_selu": ("LeakyReLU", [_randn(2, 4, 3)], {"act_type": "selu"}),
    "leaky_gelu": ("LeakyReLU", [_randn(2, 4, 3)], {"act_type": "gelu"}),
    "leaky_prelu": ("LeakyReLU", [_randn(2, 4, 3), _randn(4)],
                    {"act_type": "prelu"}),
    "leaky_rrelu": ("LeakyReLU", [_randn(2, 4, 3)], {"act_type": "rrelu"}),
    "softmax_last": ("softmax", [_randn(2, 3, 7)], {"axis": -1}),
    "softmax_axis1": ("softmax", [_randn(2, 3, 7)], {"axis": "1"}),
    "softmax_temperature": ("softmax", [_randn(2, 7)],
                            {"temperature": 2.0}),
    "layernorm_eps12": ("LayerNorm", [_randn(2, 5, 8), _randn(8), _randn(8)],
                        {"eps": 1e-12}),
    "layernorm_axis1": ("LayerNorm", [_randn(2, 5, 8), _randn(5), _randn(5)],
                        {"axis": 1}),
    "layernorm_mean_var": ("LayerNorm",
                           [_randn(2, 5, 8), _randn(8), _randn(8)],
                           {"output_mean_var": True}),
    "dropout_inference": ("Dropout", [_randn(3, 4)], {"p": 0.1}),
    "batch_dot": ("batch_dot", [_randn(3, 4, 5), _randn(3, 5, 6)], {}),
    "batch_dot_ta": ("batch_dot", [_randn(3, 5, 4), _randn(3, 5, 6)],
                     {"transpose_a": True}),
    "batch_dot_tb": ("batch_dot", [_randn(3, 4, 5), _randn(3, 6, 5)],
                     {"transpose_b": "1"}),
    "batch_dot_4d": ("batch_dot", [_randn(2, 3, 4, 5), _randn(2, 3, 5, 6)],
                     {}),
    "transpose_axes": ("transpose", [_randn(2, 3, 4, 5)],
                       {"axes": "(0, 2, 1, 3)"}),
    "transpose_reverse": ("transpose", [_randn(2, 3, 4)], {}),
    "reshape_split_heads": ("reshape", [_randn(2, 6, 8)],
                            {"shape": (0, 0, 4, 2)}),
    "reshape_infer": ("reshape", [_randn(2, 6, 8)], {"shape": "(0, -1)"}),
    "reshape_merge": ("reshape", [_randn(2, 3, 4, 5)],
                      {"shape": (-3, 0, 0)}),
    "reshape_split": ("reshape", [_randn(6, 4, 5)],
                      {"shape": (-4, -1, 3, 0, 0)}),
    "reshape_copy_rest": ("reshape", [_randn(2, 3, 4, 5)],
                          {"shape": (-3, -2)}),
    "reshape_reverse": ("reshape", [_randn(2, 3, 4)],
                        {"shape": (-1, 0), "reverse": True}),
    "embedding": ("Embedding", [_ids(12, 2, 5), _randn(10, 4)],
                  {"input_dim": 10, "output_dim": 4}),
    "mul_scalar": ("_mul_scalar", [_randn(3, 4)], {"scalar": 0.125}),
    "broadcast_add": ("broadcast_add", [_randn(2, 1, 4), _randn(1, 3, 4)],
                      {}),
    "elemwise_add": ("elemwise_add", [_randn(2, 3), _randn(2, 3)], {}),
    "plus": ("_plus", [_randn(2, 3), _randn(2, 3)], {}),
    "Plus": ("_Plus", [_randn(2, 3), _randn(2, 3)], {}),
    "add": ("_add", [_randn(2, 3), _randn(2, 3)], {}),
    # the LSTM path: unary ops, scalar sugar, broadcasts, sequence plumbing
    "sigmoid": ("sigmoid", [_randn(3, 4)], {}),
    "tanh": ("tanh", [_randn(3, 4)], {}),
    "negative": ("negative", [_randn(3, 4)], {}),
    "np_negative": ("_np_negative", [_randn(3, 4)], {}),
    "plus_scalar": ("_plus_scalar", [_randn(3, 4)], {"scalar": 1.5}),
    "PlusScalar": ("_PlusScalar", [_randn(3, 4)], {"scalar": "-2.0"}),
    "minus_scalar": ("_minus_scalar", [_randn(3, 4)], {"scalar": 0.5}),
    "MinusScalar": ("_MinusScalar", [_randn(3, 4)], {"scalar": 3}),
    "rminus_scalar": ("_rminus_scalar", [_randn(3, 4)], {"scalar": 2.0}),
    "MulScalar": ("_MulScalar", [_randn(3, 4)], {"scalar": "0.0"}),
    "div_scalar": ("_div_scalar", [_randn(3, 4)], {"scalar": 3.0}),
    "DivScalar": ("_DivScalar", [_randn(3, 4)], {"scalar": 0.7}),
    "rdiv_scalar": ("_rdiv_scalar", [_randn(3, 4)], {"scalar": 2.5}),
    "broadcast_sub": ("broadcast_sub", [_randn(2, 1, 4), _randn(3, 1)], {}),
    "elemwise_sub": ("elemwise_sub", [_randn(2, 3), _randn(2, 3)], {}),
    "minus": ("_minus", [_randn(2, 3), _randn(2, 3)], {}),
    "Minus": ("_Minus", [_randn(2, 3), _randn(2, 3)], {}),
    "sub": ("_sub", [_randn(2, 3), _randn(2, 3)], {}),
    "broadcast_mul": ("broadcast_mul", [_randn(4, 1), _randn(1, 5)], {}),
    "elemwise_mul": ("elemwise_mul", [_randn(2, 3), _randn(2, 3)], {}),
    "mul": ("_mul", [_randn(2, 3), _randn(2, 3)], {}),
    "Mul": ("_Mul", [_randn(2, 3), _randn(2, 3)], {}),
    "broadcast_div": ("broadcast_div", [_randn(2, 3), _randn(1, 3)], {}),
    "elemwise_div": ("elemwise_div", [_randn(2, 3), _randn(2, 3)], {}),
    "div": ("_div", [_randn(2, 3), _randn(2, 3)], {}),
    "Div": ("_Div", [_randn(2, 3), _randn(2, 3)], {}),
    "broadcast_axis": ("broadcast_axis", [_randn(3, 1)],
                       {"axis": 1, "size": 5}),
    "broadcast_axes_tuple": ("broadcast_axes", [_randn(1, 4, 1)],
                             {"axis": "(0, 2)", "size": (2, 3)}),
    "expand_dims": ("expand_dims", [_randn(3, 4)], {"axis": 1}),
    "expand_dims_last": ("expand_dims", [_randn(3, 4)], {"axis": "-1"}),
    "slice_axis": ("slice_axis", [_randn(3, 5)],
                   {"axis": -1, "begin": 0, "end": 1}),
    "slice_axis_open": ("slice_axis", [_randn(4, 5, 2)],
                        {"axis": "1", "begin": "2", "end": "None"}),
    "concat": ("concat", [_randn(3, 1, 4), _randn(3, 1, 4),
                          _randn(3, 2, 4)], {"dim": 1}),
    "Concat_dim0": ("Concat", [_randn(2, 4), _randn(3, 4)], {"dim": "0"}),
    "slice_channel_4": ("SliceChannel", [_randn(3, 32)],
                        {"num_outputs": 4}),
    "slice_channel_last": ("SliceChannel", [_randn(3, 2, 8)],
                           {"num_outputs": "2", "axis": "-1"}),
    "split_squeeze_60": ("split", [_randn(2, 60, 3)],
                         {"num_outputs": 60, "axis": 1,
                          "squeeze_axis": True}),
}


def _make(spec, rng):
    if spec[0] == "randn":
        return rng.randn(*spec[1]).astype(np.float32)
    # float ids past both ends of the table, fractional parts truncated
    return (rng.uniform(-2, spec[1], spec[2])).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    op, specs, attrs = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    arrays = [_make(s, rng) for s in specs]
    key = jax.random.PRNGKey(0) if jreg.get_op(op).needs_rng else None
    want = jreg.apply_op(op, [jnp.asarray(a) for a in arrays], dict(attrs),
                         rng_key=key)
    got = treg.apply_op(op, [torch.from_numpy(a) for a in arrays],
                        dict(attrs))
    assert len(got) >= jreg.get_op(op).num_outputs(jreg.Attrs(attrs))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_port_ops_are_reference_ops():
    """Every op name the port registers means the same op in the JAX
    package."""
    for name in treg.list_ops():
        assert jreg.get_op(name).name == treg.get_op(name).name


@pytest.mark.parametrize("case", ["fc_flatten", "layernorm_mean_var",
                                  "reshape_split", "embedding",
                                  "broadcast_axes_tuple", "concat",
                                  "slice_axis_open", "split_squeeze_60"])
def test_shape_inference_on_meta_matches_reference(case):
    op, specs, attrs = CASES[case]
    shapes = [s[1] if s[0] == "randn" else s[2] for s in specs]
    want, _ = jreg.eval_shape_op(op, shapes, [jnp.float32] * len(shapes),
                                 dict(attrs))
    got, _ = treg.eval_shape_op(op, shapes, [torch.float32] * len(shapes),
                                dict(attrs))
    assert got == [tuple(w) for w in want]
