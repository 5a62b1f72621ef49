"""Each op of the port's encoder path, and of the graph passes (the
zero-input constructors, identity/_copy, BlockGrad, swapaxes, rsqrt,
BatchNorm), against the JAX package's `registry.apply_op` on the same
inputs, at 1e-5; and the train-mode ops (rrelu's sampled slopes,
BatchNorm's moving statistics) through both packages' executors."""
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


def _pos(*shape):
    return ("pos", shape)


def _lens(high, *shape):
    """Sequence lengths in 1..high, as floats."""
    return ("lens", high, shape)


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
    "softmax_length": ("softmax", [_randn(2, 3, 7), _lens(7, 2, 3)], {}),
    "softmax_length_axis1": ("softmax", [_randn(2, 5, 3), _lens(5, 2, 3)],
                             {"axis": 1}),
    "softmax_length_temperature": ("softmax",
                                   [_randn(4, 6), _lens(6, 4)],
                                   {"temperature": 0.5}),
    "softmin": ("softmin", [_randn(2, 3, 7)], {}),
    "softmin_axis0": ("softmin", [_randn(4, 3)], {"axis": 0}),
    # the sequence ops of the recurrent cells: (T, N, C) data, or (N, T, C)
    # with axis 1, and per-sample lengths
    "sequence_mask": ("SequenceMask", [_randn(6, 4, 3), _lens(6, 4)],
                      {"use_sequence_length": True}),
    "sequence_mask_axis1_value": ("SequenceMask",
                                  [_randn(4, 6, 3), _lens(6, 4)],
                                  {"use_sequence_length": "True",
                                   "axis": 1, "value": -1.5}),
    "sequence_mask_off": ("SequenceMask", [_randn(6, 4, 3)], {}),
    "sequence_last": ("SequenceLast", [_randn(6, 4, 3), _lens(6, 4)],
                      {"use_sequence_length": True}),
    "sequence_last_axis1": ("SequenceLast", [_randn(4, 6, 3), _lens(6, 4)],
                            {"use_sequence_length": True, "axis": 1}),
    "sequence_last_2d": ("SequenceLast", [_randn(6, 4), _lens(6, 4)],
                         {"use_sequence_length": True}),
    "sequence_last_off": ("SequenceLast", [_randn(6, 4, 3)], {}),
    "sequence_reverse": ("SequenceReverse", [_randn(6, 4, 3), _lens(6, 4)],
                         {"use_sequence_length": True}),
    "sequence_reverse_off": ("SequenceReverse", [_randn(6, 4, 3)], {}),
    "squeeze_all": ("squeeze", [_randn(1, 3, 1, 4)], {}),
    "squeeze_axis": ("squeeze", [_randn(1, 3, 1, 4)], {"axis": 2}),
    "squeeze_axes": ("squeeze", [_randn(1, 3, 1, 4)], {"axis": "(0, 2)"}),
    "stack": ("stack", [_randn(3, 4), _randn(3, 4), _randn(3, 4)], {}),
    "stack_axis2": ("stack", [_randn(3, 4), _randn(3, 4)], {"axis": 2}),
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
    # what the graph passes fold, forward and emit
    "zeros": ("_zeros", [], {"shape": "(2, 3)"}),
    "ones": ("_ones", [], {"shape": (4,), "dtype": "float32"}),
    "full": ("_full", [], {"shape": "(2, 2)", "value": "0.75"}),
    "arange": ("_arange", [], {"start": 1.0, "stop": "7", "step": 1.5}),
    "arange_repeat": ("_arange", [], {"start": 4, "repeat": 2}),
    "eye": ("_eye", [], {"N": 4}),
    "eye_k": ("_eye", [], {"N": "3", "M": "5", "k": "1"}),
    "identity": ("identity", [_randn(3, 4)], {}),
    "copy": ("_copy", [_randn(3, 4)], {}),
    "block_grad": ("BlockGrad", [_randn(3, 4)], {}),
    "stop_gradient": ("stop_gradient", [_randn(3, 4)], {}),
    "swapaxes": ("swapaxes", [_randn(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "SwapAxis": ("SwapAxis", [_randn(2, 3, 4)], {"dim1": "1", "dim2": "2"}),
    "rsqrt": ("rsqrt", [_pos(3, 4)], {}),
    "batchnorm_eval": ("BatchNorm", [_randn(4, 3, 5), _randn(3), _randn(3),
                                     _randn(3), _pos(3)],
                       {"fix_gamma": "False", "eps": 1e-3}),
    "batchnorm_eval_fix_gamma": ("BatchNorm",
                                 [_randn(4, 3), _randn(3), _randn(3),
                                  _randn(3), _pos(3)], {}),
    "batchnorm_train": ("BatchNorm", [_randn(4, 3, 5), _randn(3), _randn(3),
                                      _randn(3), _pos(3)],
                        {"fix_gamma": False, "momentum": 0.8,
                         "__train": True}),
    "batchnorm_train_axis": ("BatchNorm", [_randn(4, 5, 3), _randn(3),
                                           _randn(3), _randn(3), _pos(3)],
                             {"axis": -1, "__train": True}),
    "batchnorm_global_stats": ("BatchNorm", [_randn(4, 3), _randn(3),
                                             _randn(3), _randn(3), _pos(3)],
                               {"use_global_stats": True, "__train": True}),
    "batchnorm_mean_var": ("BatchNorm", [_randn(4, 3, 2), _randn(3),
                                         _randn(3), _randn(3), _pos(3)],
                           {"output_mean_var": True, "__train": True}),
    # the Gluon path: convolutions, pooling, norms, reductions and the
    # elementwise ops the layers and losses call
    "conv2d": ("Convolution", [_randn(2, 4, 9, 8), _randn(6, 4, 3, 3),
                               _randn(6)],
               {"kernel": "(3, 3)", "num_filter": 6, "pad": (1, 1)}),
    "conv2d_stride_dilate_nobias": ("Convolution",
                                    [_randn(2, 4, 11, 10),
                                     _randn(6, 4, 3, 2)],
                                    {"kernel": (3, 2), "num_filter": 6,
                                     "stride": (2, 1), "dilate": (2, 1),
                                     "pad": (2, 0), "no_bias": True}),
    "conv2d_groups": ("Convolution", [_randn(2, 6, 7, 7),
                                      _randn(9, 2, 3, 3), _randn(9)],
                      {"kernel": (3, 3), "num_filter": 9, "num_group": 3}),
    "conv2d_nhwc": ("Convolution", [_randn(2, 9, 8, 4), _randn(6, 3, 3, 4),
                                    _randn(6)],
                    {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1),
                     "stride": (2, 1), "layout": "NHWC"}),
    "conv2d_nhwc_1x1_nobias": ("Convolution", [_randn(2, 5, 5, 8),
                                               _randn(4, 1, 1, 8)],
                               {"kernel": (1, 1), "num_filter": 4,
                                "no_bias": True, "layout": "NHWC"}),
    "conv1d": ("Convolution", [_randn(2, 3, 12), _randn(5, 3, 3),
                               _randn(5)],
               {"kernel": (3,), "num_filter": 5, "stride": (2,),
                "pad": (1,)}),
    "conv1d_nwc": ("Convolution", [_randn(2, 12, 3), _randn(5, 3, 3),
                                   _randn(5)],
                   {"kernel": (3,), "num_filter": 5, "layout": "NWC"}),
    "conv3d": ("Convolution", [_randn(1, 2, 5, 6, 4), _randn(3, 2, 3, 3, 3),
                               _randn(3)],
               {"kernel": (3, 3, 3), "num_filter": 3, "pad": (1, 1, 0)}),
    "conv3d_ndhwc": ("Convolution", [_randn(1, 5, 6, 4, 2),
                                     _randn(3, 3, 3, 3, 2)],
                     {"kernel": (3, 3, 3), "num_filter": 3, "no_bias": True,
                      "layout": "NDHWC"}),
    "deconv2d": ("Deconvolution", [_randn(2, 4, 5, 6), _randn(4, 3, 3, 3),
                                   _randn(3)],
                 {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2),
                  "pad": (1, 1), "adj": (1, 0), "no_bias": False}),
    "deconv2d_groups_dilate": ("Deconvolution",
                               [_randn(2, 4, 5, 5), _randn(4, 3, 3, 3)],
                               {"kernel": (3, 3), "num_filter": 6,
                                "num_group": 2, "dilate": (2, 1)}),
    "deconv2d_target_shape": ("Deconvolution",
                              [_randn(1, 2, 4, 4), _randn(2, 3, 4, 4)],
                              {"kernel": (4, 4), "num_filter": 3,
                               "stride": (2, 2), "target_shape": (8, 9)}),
    "deconv1d": ("Deconvolution", [_randn(2, 3, 7), _randn(3, 2, 3),
                                   _randn(2)],
                 {"kernel": (3,), "num_filter": 2, "stride": (3,),
                  "no_bias": False}),
    "pool_max": ("Pooling", [_randn(2, 3, 9, 8)],
                 {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                  "pool_type": "max"}),
    "pool_max_full": ("Pooling", [_randn(2, 3, 10, 9)],
                      {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                       "pool_type": "max", "pooling_convention": "full"}),
    "pool_max_pad_over_half": ("Pooling", [_randn(1, 2, 7, 7)],
                               {"kernel": (2, 2), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "max"}),
    "pool_avg": ("Pooling", [_randn(2, 3, 8, 8)],
                 {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"}),
    "pool_avg_full_pad_include": ("Pooling", [_randn(2, 3, 10, 9)],
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "avg",
                                   "pooling_convention": "full",
                                   "count_include_pad": True}),
    "pool_avg_full_pad_exclude": ("Pooling", [_randn(2, 3, 10, 9)],
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "avg",
                                   "pooling_convention": "full",
                                   "count_include_pad": False}),
    "pool_avg_pad_exclude": ("Pooling", [_randn(2, 3, 7, 7)],
                             {"kernel": (3, 3), "stride": (1, 1),
                              "pad": (1, 1), "pool_type": "avg",
                              "count_include_pad": "False"}),
    "pool_sum_full": ("Pooling", [_randn(2, 3, 7, 6)],
                      {"kernel": (2, 2), "stride": (2, 2),
                       "pool_type": "sum", "pooling_convention": "full"}),
    "pool_max_same_1d": ("Pooling", [_randn(2, 3, 11)],
                         {"kernel": (3,), "stride": (2,), "pool_type": "max",
                          "pooling_convention": "same"}),
    "pool_avg_1d": ("Pooling", [_randn(2, 3, 11)],
                    {"kernel": (3,), "stride": (2,), "pad": (1,),
                     "pool_type": "avg"}),
    "pool_avg_3d_full": ("Pooling", [_randn(1, 2, 5, 6, 7)],
                         {"kernel": (2, 2, 2), "stride": (2, 2, 2),
                          "pad": (1, 0, 1), "pool_type": "avg",
                          "pooling_convention": "full"}),
    "pool_lp": ("Pooling", [_randn(2, 2, 6, 6)],
                {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
                 "p_value": 2}),
    "pool_max_nhwc": ("Pooling", [_randn(2, 9, 8, 3)],
                      {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                       "pool_type": "max", "layout": "NHWC"}),
    "pool_avg_nhwc_full": ("Pooling", [_randn(2, 9, 8, 3)],
                           {"kernel": (3, 3), "stride": (2, 2),
                            "pad": (1, 1), "pool_type": "avg",
                            "pooling_convention": "full",
                            "layout": "NHWC"}),
    "pool_global_avg": ("Pooling", [_randn(2, 3, 7, 5)],
                        {"kernel": (1, 1), "global_pool": True,
                         "pool_type": "avg"}),
    "pool_global_max_nhwc": ("Pooling", [_randn(2, 7, 5, 3)],
                             {"kernel": (1, 1), "global_pool": "True",
                              "pool_type": "max", "layout": "NHWC"}),
    "pool_global_sum": ("Pooling", [_randn(2, 3, 4)],
                        {"kernel": (1,), "global_pool": True,
                         "pool_type": "sum"}),
    "instance_norm": ("InstanceNorm", [_randn(2, 3, 4, 5), _randn(3),
                                       _randn(3)], {"eps": 1e-5}),
    "log_softmax": ("log_softmax", [_randn(3, 7)], {}),
    "log_softmax_axis1_t": ("log_softmax", [_randn(2, 5, 3)],
                            {"axis": 1, "temperature": 2.0}),
    "Flatten": ("Flatten", [_randn(2, 3, 4, 5)], {}),
    "flatten": ("flatten", [_randn(4, 3, 2)], {}),
    "pad_constant": ("pad", [_randn(2, 3, 4, 5)],
                     {"mode": "constant", "constant_value": 1.5,
                      "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "pad_edge": ("Pad", [_randn(2, 3, 4, 5)],
                 {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "pad_reflect": ("pad", [_randn(2, 3, 4, 5)],
                    {"mode": "reflect",
                     "pad_width": "(0, 0, 0, 0, 2, 1, 3, 3)"}),
    "where": ("where", [_ids(2, 3, 4), _randn(3, 4), _randn(3, 4)], {}),
    "where_rows": ("where", [_ids(2, 3), _randn(3, 4), _randn(3, 4)], {}),
    "ones_like": ("ones_like", [_randn(2, 3)], {}),
    "zeros_like": ("zeros_like", [_randn(2, 3)], {}),
    "pick": ("pick", [_randn(4, 5), _ids(7, 4)], {"axis": -1}),
    "pick_keepdims_axis0": ("pick", [_randn(4, 5), _ids(5, 5)],
                            {"axis": 0, "keepdims": True}),
    "pick_wrap": ("pick", [_randn(4, 5), _ids(9, 4)],
                  {"axis": 1, "mode": "wrap"}),
    "sum_all": ("sum", [_randn(3, 4)], {}),
    "sum_axis_keepdims": ("sum", [_randn(3, 4, 5)],
                          {"axis": 1, "keepdims": True}),
    "sum_exclude": ("sum", [_randn(3, 4, 5)],
                    {"axis": 0, "exclude": True}),
    "sum_axis_tuple": ("sum_axis", [_randn(3, 4, 5)], {"axis": (0, 2)}),
    "mean_axis": ("mean", [_randn(3, 4, 5)], {"axis": "(1, 2)"}),
    "mean_empty_axis": ("mean", [_randn(3, 4)], {"axis": ()}),
    "mean_exclude_keepdims": ("mean", [_randn(3, 4, 5)],
                              {"axis": (1,), "exclude": True,
                               "keepdims": True}),
    "max_axis": ("max", [_randn(3, 4)], {"axis": 1}),
    "min_axis": ("min", [_randn(3, 4)], {"axis": 0, "keepdims": True}),
    "prod_axis": ("prod", [_pos(3, 4, 2)], {"axis": (0, 2)}),
    "broadcast_greater": ("broadcast_greater", [_randn(3, 4), _randn(1, 4)],
                          {}),
    "broadcast_equal": ("broadcast_equal", [_ids(2, 3, 4), _ids(2, 3, 1)],
                        {}),
    "broadcast_lesser_equal": ("broadcast_lesser_equal",
                               [_randn(3, 4), _randn(3, 1)], {}),
    "broadcast_maximum": ("broadcast_maximum", [_randn(3, 4), _randn(4)],
                          {}),
    "broadcast_minimum": ("broadcast_minimum", [_randn(3, 4), _randn(4)],
                          {}),
    "broadcast_power": ("broadcast_power", [_pos(3, 4), _randn(3, 4)], {}),
    "greater_scalar": ("_greater_scalar", [_randn(3, 4)], {"scalar": 0.1}),
    "lesser_scalar": ("_lesser_scalar", [_randn(3, 4)], {"scalar": -0.1}),
    "equal_scalar": ("_equal_scalar", [_ids(3, 3, 4)], {"scalar": 1}),
    "not_equal_scalar": ("_not_equal_scalar", [_ids(3, 3, 4)],
                         {"scalar": 1}),
    "greater_equal_scalar": ("_greater_equal_scalar", [_randn(3, 4)],
                             {"scalar": 0.0}),
    "lesser_equal_scalar": ("_lesser_equal_scalar", [_randn(3, 4)],
                            {"scalar": 0.0}),
    "power_scalar": ("_power_scalar", [_pos(3, 4)], {"scalar": 2.5}),
    "rpower_scalar": ("_rpower_scalar", [_randn(3, 4)], {"scalar": 2.0}),
    "maximum_scalar": ("_maximum_scalar", [_randn(3, 4)], {"scalar": 0.2}),
    "minimum_scalar": ("_minimum_scalar", [_randn(3, 4)], {"scalar": 0.2}),
    "mod_scalar": ("_mod_scalar", [_randn(3, 4)], {"scalar": 0.7}),
    "relu": ("relu", [_randn(3, 4)], {}),
    "abs": ("abs", [_randn(3, 4)], {}),
    "sign": ("sign", [_randn(3, 4)], {}),
    "square": ("square", [_randn(3, 4)], {}),
    "sqrt": ("sqrt", [_pos(3, 4)], {}),
    "exp": ("exp", [_randn(3, 4)], {}),
    "log": ("log", [_pos(3, 4)], {}),
    "log2": ("log2", [_pos(3, 4)], {}),
    "log10": ("log10", [_pos(3, 4)], {}),
    "log1p": ("log1p", [_pos(3, 4)], {}),
    "expm1": ("expm1", [_randn(3, 4)], {}),
    "floor": ("floor", [_randn(3, 4)], {}),
    "ceil": ("ceil", [_randn(3, 4)], {}),
    "trunc": ("trunc", [_randn(3, 4)], {}),
    "sin": ("sin", [_randn(3, 4)], {}),
    "cos": ("cos", [_randn(3, 4)], {}),
    "erf": ("erf", [_randn(3, 4)], {}),
    "softsign": ("softsign", [_randn(3, 4)], {}),
    "reciprocal": ("reciprocal", [_pos(3, 4)], {}),
    "cast_f64": ("cast", [_randn(3, 4)], {"dtype": "float64"}),
    "Cast_i32": ("Cast", [_randn(3, 4)], {"dtype": "int32"}),
    "multi_sgd_update": ("multi_sgd_update",
                         [_randn(3, 4), _randn(3, 4), _randn(5), _randn(5)],
                         {"num_weights": 2, "lrs": (0.1, 0.2),
                          "wds": (0.01, 0.0), "rescale_grad": 0.5,
                          "clip_gradient": 0.4}),
    "multi_sgd_mom_update": ("multi_sgd_mom_update",
                             [_randn(3, 4), _randn(3, 4), _randn(3, 4),
                              _randn(5), _randn(5), _randn(5)],
                             {"num_weights": 2, "lrs": (0.1, 0.1),
                              "wds": (0.01, 0.01), "momentum": 0.9}),
}


def _make(spec, rng):
    if spec[0] == "randn":
        return rng.randn(*spec[1]).astype(np.float32)
    if spec[0] == "pos":
        return rng.uniform(0.5, 2.0, spec[1]).astype(np.float32)
    if spec[0] == "lens":
        return rng.randint(1, spec[1] + 1, spec[2]).astype(np.float32)
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
                                  "reshape_split", "embedding", "eye_k",
                                  "arange_repeat", "batchnorm_mean_var",
                                  "broadcast_axes_tuple", "concat",
                                  "slice_axis_open", "split_squeeze_60",
                                  "conv2d_nhwc", "conv3d", "deconv2d",
                                  "deconv2d_target_shape", "pool_max_full",
                                  "pool_avg_nhwc_full", "pool_max_same_1d",
                                  "pool_global_avg", "pick_keepdims_axis0",
                                  "sum_exclude", "pad_reflect",
                                  "softmax_length", "sequence_last_axis1",
                                  "sequence_reverse", "squeeze_axes",
                                  "stack_axis2"])
def test_shape_inference_on_meta_matches_reference(case):
    op, specs, attrs = CASES[case]
    shapes = [s[1] if s[0] in ("randn", "pos") else s[2] for s in specs]
    want, _ = jreg.eval_shape_op(op, shapes, [jnp.float32] * len(shapes),
                                 dict(attrs))
    got, _ = treg.eval_shape_op(op, shapes, [torch.float32] * len(shapes),
                                dict(attrs))
    assert got == [tuple(w) for w in want]


def _leaky(pkg, x, train, ctx):
    """rrelu's output through ``pkg``'s executor, in train mode or not."""
    data = pkg.sym.var("data")
    net = pkg.sym.LeakyReLU(data, act_type="rrelu", lower_bound=0.1,
                            upper_bound=0.4)
    arr = pkg.nd.array(x) if ctx is None else pkg.nd.array(x, ctx=ctx)
    exe = net.bind(ctx or pkg.cpu(), args={"data": arr})
    return exe.forward(is_train=train)[0].asnumpy()


@pytest.mark.parametrize("pkg_name", ["mxnet_tpu", "mxnet_tpu_torch"])
def test_rrelu_samples_its_slopes_in_training(pkg_name):
    """One slope per element, uniform in [lower_bound, upper_bound], in
    training; the mean slope at inference.  The two packages' streams
    differ, so each is held to the uniform law: the slopes' mean and
    standard deviation within 4 sigma of their sampling spread."""
    import importlib
    pkg = importlib.import_module(pkg_name)
    ctx = pkg.cpu() if pkg_name == "mxnet_tpu_torch" else None
    lo, hi, n = 0.1, 0.4, 20000
    x = -np.random.RandomState(3).uniform(0.5, 2.0, n).astype(np.float32)
    slopes = _leaky(pkg, x, True, ctx) / x
    assert slopes.min() >= lo - 1e-6 and slopes.max() <= hi + 1e-6
    mean, sd = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
    assert abs(slopes.mean() - mean) < 4 * sd / np.sqrt(n)
    # the sample sd's spread: sd·sqrt((kurtosis - 1) / 4n), kurtosis 1.8
    assert abs(slopes.std() - sd) < 4 * sd * np.sqrt(0.8 / (4 * n))
    assert len(np.unique(slopes.round(6))) > n // 10
    np.testing.assert_allclose(_leaky(pkg, x, False, ctx) / x, mean,
                               rtol=1e-6)


def test_batchnorm_train_forward_moves_the_aux_states_like_the_reference():
    """A train-mode forward through each package's executor writes the
    moving mean and variance back into ``aux_dict``."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    rng = np.random.RandomState(8)
    x = rng.randn(6, 4).astype(np.float32)
    g, b = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    mm = rng.randn(4).astype(np.float32)
    mv = rng.uniform(0.5, 2, 4).astype(np.float32)
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        net = pkg.sym.BatchNorm(pkg.sym.var("data"), fix_gamma=False,
                                momentum=0.7, name="bn")
        arr = (lambda v: pkg.nd.array(v)) if pkg is mx else \
            (lambda v: pkg.nd.array(v, ctx=ctx))
        exe = net.bind(ctx, args={"data": arr(x), "bn_gamma": arr(g),
                                  "bn_beta": arr(b)},
                       aux_states={"bn_moving_mean": arr(mm),
                                   "bn_moving_var": arr(mv)})
        y = exe.forward(is_train=True)[0].asnumpy()
        out.append((y, exe.aux_dict["bn_moving_mean"].asnumpy(),
                    exe.aux_dict["bn_moving_var"].asnumpy()))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert not np.allclose(out[1][1], mm)


def test_block_grad_passes_no_gradient():
    import mxnet_tpu_torch as mt
    a = mt.sym.var("a")
    net = mt.sym.broadcast_add(mt.sym.BlockGrad(a * 3.0), a)
    x = mt.nd.array(np.ones((2, 2), np.float32), ctx=mt.cpu())
    g = mt.nd.zeros((2, 2), ctx=mt.cpu())
    exe = net.bind(mt.cpu(), args={"a": x}, args_grad={"a": g})
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_array_equal(g.asnumpy(), np.ones((2, 2)))


# ---------------------------------------------------------------------------
# nd.invoke's contract: out=, and the update ops' untouched weight
# ---------------------------------------------------------------------------

def _pkgs():
    import mxnet_tpu as jx
    import mxnet_tpu_torch as tx
    return ((jx, lambda a: jx.nd.array(a)),
            (tx, lambda a: tx.nd.array(a, ctx=tx.cpu())))


def test_out_argument_matches_reference():
    """``out=`` receives the result and is what the call returns, for one
    output and a list of them; a mutated input (BatchNorm's moving mean in
    training) is written back into the caller's array."""
    rng = np.random.RandomState(21)
    x = rng.randn(4, 6).astype(np.float32)
    bn = [rng.randn(4, 3, 2).astype(np.float32)] + \
        [rng.randn(3).astype(np.float32) for _ in range(3)] + \
        [rng.uniform(0.5, 2, 3).astype(np.float32)]
    got = {}
    for pkg, arr in _pkgs():
        y = arr(np.zeros((4, 6), np.float32))
        r = pkg.nd.Activation(arr(x), act_type="relu", out=y)
        assert r is y
        parts = [arr(np.zeros((4, 3), np.float32)) for _ in range(2)]
        r2 = pkg.nd.split(arr(x), num_outputs=2, axis=1, out=parts)
        assert r2 is parts
        mm, mv = arr(bn[3]), arr(bn[4])
        with pkg.autograd.train_mode():
            pkg.nd.BatchNorm(*[arr(a) for a in bn[:3]], mm, mv,
                             fix_gamma=False, momentum=0.7)
        got[pkg.__name__] = [y.asnumpy()] + [p.asnumpy() for p in parts] \
            + [mm.asnumpy(), mv.asnumpy()]
    want = got["mxnet_tpu"]
    np.testing.assert_array_equal(want[0], np.maximum(x, 0))
    assert not np.allclose(want[3], bn[3])
    for g, w in zip(got["mxnet_tpu_torch"], want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "adam_update"])
def test_update_ops_leave_weight_untouched(op):
    """An update op returns the new weight and leaves its weight input as
    it was; its state inputs (momentum, mean, var) are updated in place,
    as in the reference (MXNet's FMutateInputs)."""
    rng = np.random.RandomState(22)
    w = np.ones((2, 3), np.float32)
    g = np.full((2, 3), 2.0, np.float32)
    states = {"sgd_update": [],
              "sgd_mom_update": [rng.randn(2, 3).astype(np.float32)],
              "adam_update": [rng.randn(2, 3).astype(np.float32),
                              rng.uniform(0.1, 1, (2, 3)).astype(
                                  np.float32)]}[op]
    attrs = dict(lr=0.1, wd=0.01, momentum=0.9) if op != "adam_update" \
        else dict(lr=0.1, wd=0.01)
    if op == "sgd_update":
        attrs.pop("momentum")
    got = {}
    for pkg, arr in _pkgs():
        W, S = arr(w), [arr(s) for s in states]
        new = getattr(pkg.nd, op)(W, arr(g), *S, **attrs)
        got[pkg.__name__] = (W.asnumpy(), new.asnumpy(),
                             [s.asnumpy() for s in S])
    (jw, jnew, js), (tw, tnew, ts) = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    np.testing.assert_array_equal(jw, w)
    np.testing.assert_array_equal(tw, w)
    if op == "sgd_update":
        np.testing.assert_allclose(tnew, 1 - 0.1 * (2 + 0.01), rtol=1e-6)
    np.testing.assert_allclose(tnew, jnew, rtol=TOL, atol=TOL)
    for t, j, s0 in zip(ts, js, states):
        assert not np.allclose(j, s0)
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# clip, add_n, the image ops and CTCLoss
# ---------------------------------------------------------------------------

def _vjp_both(op, arrays, attrs, cotangent_seed=0):
    """Outputs and input gradients of ``op`` in both packages for one
    seeded cotangent of the first output (the gradient of the first
    input only)."""
    x0 = jnp.asarray(arrays[0])
    rest = [jnp.asarray(a) for a in arrays[1:]]

    def f(x):
        return jreg.apply_op(op, [x] + rest, dict(attrs))[0]
    want, vjp = jax.vjp(f, x0)
    ct = np.random.RandomState(cotangent_seed).randn(
        *want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    tx0 = torch.from_numpy(arrays[0]).requires_grad_(True)
    got = treg.apply_op(op, [tx0] + [torch.from_numpy(a)
                                     for a in arrays[1:]], dict(attrs))[0]
    (got_g,) = torch.autograd.grad(got, tx0, torch.from_numpy(ct))
    return (got.detach().numpy(), np.asarray(want),
            got_g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("attrs", [{"a_min": 0, "a_max": 6},
                                   {"a_min": "0.0", "a_max": "6.0"},
                                   {"a_max": 6}, {"a_min": 0}])
def test_clip_and_its_gradient_at_the_bounds_match_reference(attrs):
    """Inputs lie exactly on 0 and 6, beside and between them: the
    gradient passes on the closed interval, as the JAX package's does."""
    x = np.array([[-2.0, -1e-7, 0.0, 1e-7, 3.0],
                  [6.0 - 4e-7, 6.0, 6.0 + 5e-7, 7.0, -0.0]], np.float32)
    got, want, got_g, want_g = _vjp_both("clip", [x], attrs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)


def test_clip_takes_its_bounds_positionally():
    import mxnet_tpu as jx
    import mxnet_tpu_torch as tx
    x = np.array([-1.0, 2.0, 9.0], np.float32)
    want = jx.nd.clip(jx.nd.array(x), 0, 6).asnumpy()
    got = tx.nd.clip(tx.nd.array(x, ctx=tx.cpu()), 0, 6).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert tx.sym.clip(tx.sym.var("x"), 0, 6).attr_dict()["clip0"] == \
        {"a_min": "0", "a_max": "6"}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_add_n_matches_reference(n):
    rng = np.random.RandomState(n)
    arrays = [rng.randn(3, 4).astype(np.float32) for _ in range(n)]
    want = jreg.apply_op("add_n", [jnp.asarray(a) for a in arrays], {})[0]
    got = treg.apply_op("ElementWiseSum",
                        [torch.from_numpy(a) for a in arrays], {})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _image(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "u8":
        return (rng.rand(*shape) * 255).astype(np.uint8)
    return (rng.rand(*shape) * 255).astype(np.float32)


# (op, image kind, shape, attrs)
IMAGE_CASES = {
    "to_tensor_hwc": ("_image_to_tensor", "u8", (5, 7, 3), {}),
    "to_tensor_nhwc": ("_image_to_tensor", "u8", (2, 5, 7, 3), {}),
    "normalize_chw": ("_image_normalize", "f32", (3, 5, 7),
                      {"mean": (0.4, 0.5, 0.6), "std": (0.2, 0.3, 0.4)}),
    "normalize_nchw_one": ("_image_normalize", "f32", (2, 1, 5, 7),
                           {"mean": 0.5, "std": 2.0}),
    "resize_down_f32": ("_image_resize", "f32", (13, 17, 3),
                        {"size": (8, 6)}),
    "resize_down_u8": ("_image_resize", "u8", (13, 17, 3), {"size": (8, 6)}),
    "resize_up_u8": ("_image_resize", "u8", (13, 17, 3), {"size": (30, 20)}),
    "resize_square": ("_image_resize", "f32", (13, 17, 3), {"size": 5}),
    "resize_keep_ratio": ("_image_resize", "u8", (13, 17, 3),
                          {"size": (10, 10), "keep_ratio": True}),
    "resize_batch": ("_image_resize", "f32", (2, 7, 9, 3), {"size": (4, 5)}),
    "crop": ("_image_crop", "u8", (9, 8, 3),
             {"x": 2, "y": 3, "width": 5, "height": 4}),
    "crop_batch": ("_image_crop", "f32", (2, 9, 8, 3),
                   {"x": 1, "y": 0, "width": 3, "height": 6}),
    "flip_left_right": ("_image_flip_left_right", "u8", (4, 5, 3), {}),
    "flip_top_bottom": ("_image_flip_top_bottom", "f32", (2, 4, 5, 3), {}),
    "brightness_u8": ("_image_adjust_lighting_scale", "u8", (6, 5, 3),
                      {"alpha": 1.3}),
    "brightness_alias": ("_image_random_brightness_scale", "f32", (6, 5, 3),
                         {"alpha": 0.7}),
    "contrast_u8": ("_image_adjust_contrast", "u8", (6, 5, 3),
                    {"alpha": 0.6}),
    "contrast_f32": ("_image_adjust_contrast", "f32", (6, 5, 3),
                     {"alpha": 1.5}),
    "saturation_u8": ("_image_adjust_saturation", "u8", (6, 5, 3),
                      {"alpha": 1.4}),
    "saturation_f32": ("_image_adjust_saturation", "f32", (6, 5, 3),
                       {"alpha": 0.3}),
    "hue_u8": ("_image_adjust_hue", "u8", (6, 5, 3), {"alpha": 0.3}),
    "hue_f32": ("_image_adjust_hue", "f32", (6, 5, 3), {"alpha": -0.45}),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_op_matches_reference(case):
    """Each image op on the same image; uint8 results (rounded half to
    even and clipped, as the reference does) are held equal, float ones
    within 1e-5 relative."""
    op, kind, shape, attrs = IMAGE_CASES[case]
    x = _image(kind, shape, sorted(IMAGE_CASES).index(case))
    want = np.asarray(jreg.apply_op(op, [jnp.asarray(x)], dict(attrs))[0])
    got = treg.apply_op(op, [torch.from_numpy(x)], dict(attrs))[0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


@pytest.mark.parametrize("op,axis", [("_image_random_flip_left_right", 1),
                                     ("_image_random_flip_top_bottom", 0)])
def test_random_flip_draws_both_ways(op, axis):
    """The random flips give the image or its flip, each about half the
    time over 400 draws (the packages' streams differ, so the law is
    held, not the draws)."""
    x = _image("u8", (4, 5, 3), 0)
    gen = torch.Generator().manual_seed(0)
    flipped = 0
    for _ in range(400):
        got = treg.get_op(op).fn(treg.Attrs(), gen, torch.from_numpy(x))
        if np.array_equal(got.numpy(), np.flip(x, axis)):
            flipped += 1
        else:
            np.testing.assert_array_equal(got.numpy(), x)
    assert 200 - 4 * 10 < flipped < 200 + 4 * 10


def _ctc_inputs(blank, T=7, N=5, C=6, L=4, seed=0):
    """Activations, labels padded by the blank's convention (0 for
    "first", -1 for "last"), input and label lengths; sequence 0's label
    is longer than its input allows (infeasible), sequence 1 repeats a
    label, sequence 2 has an empty label."""
    rng = np.random.RandomState(seed)
    data = rng.randn(T, N, C).astype(np.float32)
    lo, hi = (1, C) if blank == "first" else (0, C - 1)
    pad = 0 if blank == "first" else -1
    lengths = [L, 3, 0, 2, 4]
    label = np.full((N, L), pad, np.float32)
    for n, k in enumerate(lengths):
        label[n, :k] = rng.randint(lo, hi, k)
    label[1, :3] = [lo, lo, lo + 1]
    data_len = np.array([2, T, T, 3, T - 1], np.float32)
    return data, label, data_len, np.array(lengths, np.float32)


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("lengths", ["none", "data", "both"])
def test_ctc_loss_and_gradient_match_reference(blank, lengths):
    """The loss and its gradient with respect to the activations, against
    the JAX op, at 1e-5: blank first or last, labels delimited by padding
    or by label_lengths, sequences cut by data_lengths; an infeasible
    alignment gives 1e30, as the reference's floor does."""
    data, label, data_len, label_len = _ctc_inputs(blank)
    arrays = [data, label] + {"none": [], "data": [data_len],
                              "both": [data_len, label_len]}[lengths]
    got, want, got_g, want_g = _vjp_both("CTCLoss", arrays,
                                         {"blank_label": blank})
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_g, want_g, rtol=TOL, atol=TOL)
    if lengths != "none":
        assert got[0] == np.float32(1e30)


def test_ctc_loss_in_float64_agrees_with_float32():
    """The port computes a float64 input in float64 (the card's check
    holds its float32 loss against it)."""
    data, label, data_len, label_len = _ctc_inputs("last", seed=3)
    arrays = [torch.from_numpy(a) for a in (label, data_len, label_len)]
    lo = treg.apply_op("CTCLoss", [torch.from_numpy(data)] + arrays,
                       {"blank_label": "last"})[0]
    hi = treg.apply_op("CTCLoss", [torch.from_numpy(data).double()] + arrays,
                       {"blank_label": "last"})[0]
    assert hi.dtype == torch.float64
    feasible = lo < 1e29
    np.testing.assert_allclose(lo[feasible].numpy(),
                               hi[feasible].numpy(), rtol=1e-5)
