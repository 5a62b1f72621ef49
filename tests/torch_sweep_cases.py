"""The op sweep's cases without the JAX package: `SPECS` is the spec table
of `tests/test_op_sweep.py` (its source between the "spec table" and
"exemptions" headers, run with numpy alone, so the inputs are the same
arrays), and `CASES` the cases past it that the port's sweep adds.  Both
`tests/test_torch_op_sweep.py` (against the JAX package on the CPU, which
also checks that `SPECS` equals the imported table) and ``chip_smoke.py``
phase 12a (the port on the card against itself in float64 on the CPU)
read this file.

`run_case` drives one case through the port: the forward outputs, and
the gradients of a fixed random projection of the float outputs with
respect to the ``wrt`` inputs."""
import inspect
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "test_op_sweep.py")


def _spec_table():
    with open(_SRC) as f:
        src = f.read()
    start = src.index("# spec table")
    stop = src.index("# exemptions: ops that cannot")
    body = src[src.rindex("\n", 0, start) + 1:src.rindex("\n", 0, stop)]
    scope = {"np": np, "_rs": lambda seed=0: np.random.RandomState(seed)}
    exec(compile(body, _SRC, "exec"), scope)
    return scope


_SCOPE = _spec_table()
SPECS = _SCOPE["SPECS"]


def _run_spec_signature(name, inputs, attrs=None, wrt=None, oracle=None,
                        rtol=1e-2, atol=1e-3, eps=1e-3, fwd_only=False):
    """The signature of `tests/test_op_sweep.py:run_spec` (which the card,
    without JAX, cannot import); `tests/test_torch_op_sweep.py` binds every
    spec through both and holds them equal."""


def spec_case(name, run_spec=_run_spec_signature):
    """``(op name, inputs, attrs, wrt, unprojected outputs)`` of a spec,
    its arguments bound as ``run_spec`` binds them."""
    args, kw = SPECS[name]
    bound = inspect.signature(run_spec).bind(name, *args, **kw)
    bound.apply_defaults()
    a = bound.arguments
    inputs = a["inputs"]
    wrt = list(range(len(inputs))) if a["wrt"] is None else list(a["wrt"])
    return (name, inputs, dict(a["attrs"] or {}), _float_wrt(inputs, wrt),
            SIGN_FREE_ROWS.get(name, ()))


def _float_wrt(inputs, wrt):
    return [i for i in wrt
            if np.issubdtype(np.asarray(inputs[i]).dtype, np.floating)]


IMG, S23, T23, U11 = (_SCOPE[k] for k in ("IMG", "S23", "T23", "U11"))
_R = np.random.RandomState(42)
_TIES = np.array([[3, 1, 3, 2, 1], [0, 0, 5, 5, 0]], np.float32)
_M = _R.randn(3, 4).astype(np.float32)
_B = _R.randn(2, 3, 4).astype(np.float32)
_SPD = (lambda m: (m @ np.swapaxes(m, -1, -2) + 3 * np.eye(3))
        .astype(np.float32))(_R.randn(2, 3, 3))
_TRI = (np.tril(_R.randn(2, 3, 3)) + 2 * np.eye(3)).astype(np.float32)

# cases past the spec table: the attrs and inputs where two
# implementations could part (ties, out-of-range indices, repeated
# indices, return types, batched matrices): name -> (op, inputs, attrs,
# wrt or None for every float input)
CASES = {
    "take_clip": ("take", [_M, np.array([-2, 1, 7], np.float32)],
                  {"axis": 1, "mode": "clip"}, [0]),
    "take_wrap": ("take", [_M, np.array([[-2, 1], [7, 0]], np.float32)],
                  {"axis": 0, "mode": "wrap"}, [0]),
    "topk_value": ("topk", [_TIES], {"k": 3, "ret_typ": "value"}, None),
    "topk_indices_ascend": ("topk", [_TIES], {"k": 3, "is_ascend": True},
                            None),
    "topk_mask": ("topk", [_TIES], {"k": 2, "ret_typ": "mask"}, None),
    "topk_both_axis0": ("topk", [_TIES], {"k": 1, "ret_typ": "both",
                                          "axis": 0, "dtype": "int32"},
                        None),
    "topk_flat": ("topk", [_TIES], {"k": 4, "axis": None}, None),
    "sort_desc_ties": ("sort", [_TIES], {"is_ascend": False}, None),
    "argsort_ties": ("argsort", [_TIES], {}, None),
    "argsort_desc_ties": ("argsort", [_TIES], {"is_ascend": False,
                                               "dtype": "int32"}, None),
    "argmax_ties": ("argmax", [_TIES], {"axis": 1, "keepdims": True}, None),
    "argmin_flat": ("argmin", [_TIES], {}, None),
    "one_hot_on_off": ("one_hot", [np.array([[0, 3], [5, -1]], np.float32)],
                       {"depth": 4, "on_value": 2.5, "off_value": -1.0,
                        "dtype": "int32"}, None),
    "gather_nd_repeats": ("gather_nd", [_M, np.array([[0, 0, 2], [1, 1, 3]],
                                                     np.float32)], {}, [0]),
    "slice_negative_step": ("slice", [_B], {"begin": (None, 2, 3),
                                            "end": (None, None, 0),
                                            "step": (1, -1, -2)}, None),
    "repeat_flat": ("repeat", [_M], {"repeats": 2}, None),
    "tile_prepend": ("tile", [_M], {"reps": (2, 1, 2)}, None),
    "norm_l1_axis": ("norm", [_B], {"ord": 1, "axis": (0, 2),
                                    "keepdims": True}, None),
    "broadcast_to_zero": ("broadcast_to", [_M[:1]], {"shape": (0, 4)},
                          None),
    "diag_offset_3d": ("diag", [_B], {"k": 1, "axis1": 1, "axis2": 2},
                       None),
    "gemm_attrs": ("linalg_gemm", [_B, _B,
                                   _R.randn(2, 3, 3).astype(np.float32)],
                   {"alpha": 0.5, "beta": -2.0, "transpose_b": True,
                    "transpose_a": False}, None),
    "gemm2_transpose_a": ("linalg_gemm2", [_B, _B],
                          {"alpha": 1.5, "transpose_a": True}, None),
    "potrf_batched": ("linalg_potrf", [_SPD], {}, None),
    "potri_batched": ("linalg_potri", [_TRI], {}, None),
    "trsm_right_transpose": ("linalg_trsm",
                             [_TRI, _R.randn(2, 4, 3).astype(np.float32)],
                             {"rightside": True, "transpose": True,
                              "alpha": 2.0}, None),
    "trsm_upper": ("linalg_trsm", [np.swapaxes(_TRI, 1, 2).copy(),
                                   _R.randn(2, 3, 2).astype(np.float32)],
                   {"lower": False}, None),
    "trmm_right": ("linalg_trmm", [_TRI, _R.randn(2, 4, 3)
                                   .astype(np.float32)],
                   {"rightside": True, "alpha": -1.0}, None),
    "syrk_transpose": ("linalg_syrk", [_B], {"transpose": True,
                                             "alpha": 0.5}, None),
    "syevd_batched": ("linalg_syevd", [_SPD], {}, None),
    "gelqf_batched": ("linalg_gelqf", [_B], {}, None),
    "maketrian_upper_offset": ("linalg_maketrian",
                               [_R.randn(2, 3).astype(np.float32)],
                               {"lower": False, "offset": 1}, None),
    "extracttrian_offset": ("linalg_extracttrian", [_SPD],
                            {"offset": -1}, None),
    "makediag_offset": ("linalg_makediag", [_R.randn(2, 3)
                                            .astype(np.float32)],
                        {"offset": -1}, None),
    "upsampling_bilinear": ("UpSampling", [IMG],
                            {"scale": 2, "sample_type": "bilinear",
                             "num_args": 1}, None),
    "upsampling_nearest_two": ("UpSampling", [IMG, IMG[:, :, :5, :5]],
                               {"scale": 2, "num_args": 2}, None),
    "l2norm_channel": ("L2Normalization", [IMG], {"mode": "channel"}, None),
    "l2norm_spatial": ("L2Normalization", [IMG], {"mode": "spatial"}, None),
    "svm_linear": ("SVMOutput", [S23, np.array([0, 2], np.float32)],
                   {"use_linear": True, "margin": 0.5}, [0]),
    "mae_grad_scale": ("MAERegressionOutput", [S23, T23],
                       {"grad_scale": 3.0}, [0]),
    "logistic_grad_scale": ("LogisticRegressionOutput", [S23, U11],
                            {"grad_scale": 2.0}, [0]),
    "softmax_activation_channel": ("SoftmaxActivation", [IMG],
                                   {"mode": "channel"}, None),
    "hard_sigmoid_attrs": ("hard_sigmoid", [S23],
                           {"alpha": 0.3, "beta": 0.4}, None),
    "smooth_l1_sigma": ("smooth_l1", [S23], {"scalar": 2.0}, None),
    "round_halves": ("round", [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
                                        np.float32)], {}, None),
    "crop_like_center": ("Crop", [IMG, np.zeros((1, 1, 3, 2), np.float32)],
                         {"center_crop": True, "num_args": 2}, [0]),
}

# outputs defined up to the sign of each row (an eigenvector's): held with
# their signs aligned, and kept out of the projected loss
SIGN_FREE_ROWS = {"syevd_batched": (0,), "linalg_syevd": (0,)}


def extra_case(case):
    """``(op name, inputs, attrs, wrt, unprojected outputs)`` of a case."""
    name, inputs, attrs, wrt = CASES[case]
    wrt = range(len(inputs)) if wrt is None else wrt
    return (name, inputs, dict(attrs), _float_wrt(inputs, wrt),
            SIGN_FREE_ROWS.get(case, ()))


def align_rows(got, ref):
    """``got`` with each matrix row's sign flipped to agree with ``ref``."""
    dots = np.sum(np.asarray(got, np.float64) * ref, axis=-1, keepdims=True)
    return got * np.where(dots < 0, -1, 1).astype(got.dtype)


def run_case(pkg, name, inputs, attrs, wrt, unprojected=(), make=None):
    """Forward outputs and the gradients of the projected loss as numpy,
    through ``pkg`` (`mxnet_tpu` or `mxnet_tpu_torch`).  ``make`` turns a
    numpy input into an NDArray (default ``pkg.nd.array``)."""
    nd = pkg.nd
    make = make or nd.array
    fn = getattr(nd, name)
    outs = fn(*[make(np.asarray(x)) for x in inputs], **attrs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    outs_np = [o.asnumpy() for o in outs]
    projs = [np.asarray(np.random.RandomState(1).randn(*o.shape))
             * (k not in unprojected) for k, o in enumerate(outs_np)]
    if not wrt or not any(np.issubdtype(o.dtype, np.floating)
                          for o in outs_np):
        return outs_np, []
    arrs = [make(np.asarray(x)) for x in inputs]
    for i in wrt:
        arrs[i].attach_grad()
    with pkg.autograd.record():
        gouts = fn(*arrs, **attrs)
        gouts = list(gouts) if isinstance(gouts, (list, tuple)) else [gouts]
        head = None
        for o, p in zip(gouts, projs):
            if not np.issubdtype(o.asnumpy().dtype, np.floating):
                continue
            term = (o * make(p.astype(o.asnumpy().dtype))).sum()
            head = term if head is None else head + term
    head.backward()
    return outs_np, [arrs[i].grad.asnumpy() for i in wrt]
