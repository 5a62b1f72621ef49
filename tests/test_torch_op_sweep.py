"""The port's op surface against the JAX package, one case per op name:
every entry of `tests/test_op_sweep.py`'s ``SPECS`` that the port
registers runs through both packages on the same numpy inputs (the
sweep's own), forward and gradient (a fixed random projection of the
float outputs, backpropagated through each package's autograd to the
spec's ``wrt`` inputs), and the cases past the table that
`tests/torch_sweep_cases.py` adds (ties, out-of-range and repeated
indices, return types, batched matrices).

Tolerance: an output or gradient agrees when its largest difference is
within ``TOL`` = 1e-5 of the reference's largest magnitude (integer
outputs exactly), the linear-algebra ops included: on the CPU both
packages' factorizations are LAPACK's.

A completeness test holds that every op name the port registers is swept
here (under its own name or an alias) or exempt with a reason; the
samplers are exempt here and held by their statistics in
`tests/test_torch_random.py`.
"""
import inspect

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

import test_op_sweep as jsweep
import torch_sweep_cases as cases

TOL = 1e-5

SWEPT = sorted(n for n in jsweep.SPECS if n in set(treg.list_ops()))

# the port's names that the sweep above cannot take, each with the test
# that holds it instead
EXEMPT = {
    **{n: "sampler: tests/test_torch_random.py" for n in treg.list_ops()
       if n.startswith(("_random_", "random_", "_sample_", "sample_"))
       or n in jsweep.EXEMPT_RANDOM - {"Dropout"} or n == "_shuffle"},
    "Dropout": "random masks: tests/test_torch_ops.py",
    "RNN": "tests/test_torch_rnn_op.py",
    "BatchNorm": "aux states: tests/test_torch_ops.py",
    "CTCLoss": "tests/test_torch_gluon.py (CTC against the JAX package)",
    "_sample_unique_zipfian": "sampler: tests/test_torch_sparse.py",
    "_fused_attention": "kernel: tests/test_torch_kernels.py",
    "_fused_lstm_gates": "kernel: tests/test_torch_kernels.py",
    "_image_random_flip_left_right": "random flip: "
                                     "tests/test_torch_gluon_data.py",
    "_image_random_flip_top_bottom": "random flip: "
                                     "tests/test_torch_gluon_data.py",
    "_scatter_set_nd": "tests/test_torch_surface.py (index assignment)",
    **{n: "optimizer update: tests/test_torch_optimizer*.py and "
          "tests/test_torch_fit.py" for n in treg.list_ops()
       if n.endswith("_update")},
    "multi_sum_sq": "tests/test_torch_optimizers.py",
    "_image_normalize_mirror_batch": "uint8 NHWC batches: "
                                     "tests/test_torch_io.py",
    "_foreach": "body graphs: tests/test_torch_control_flow.py",
    "_while_loop": "body graphs: tests/test_torch_control_flow.py",
    "_cond": "branch graphs: tests/test_torch_control_flow.py",
    "Custom": "user ops: tests/test_torch_custom_op.py",
    "_subgraph_op": "inner graphs: tests/test_torch_subgraph.py",
    # the contrib ops the sweep's table leaves out: detection heads,
    # ROI ops, samplers, int8 payloads and SyncBatchNorm's mesh axis
    **{n: "tests/test_torch_contrib_ops.py" for n in treg.list_ops()
       if treg.get_op(n).fn.__module__.rsplit(".", 1)[-1]
       in ("contrib_ops", "contrib_extra", "quantized_ops")
       and n not in jsweep.SPECS},
}


def _close(got, ref, tol, what):
    assert got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}"
    if not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    err = np.abs(got[fin] - ref[fin]).max() if fin.any() else 0.0
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max error {err} against largest magnitude {scale}"


def _both(case):
    name, inputs, attrs, wrt, free = case
    j_out, j_grad = cases.run_case(mx, name, inputs, attrs, wrt, free)
    with mt.cpu():
        t_out, t_grad = cases.run_case(mt, name, inputs, attrs, wrt, free)
    assert len(t_out) == len(j_out)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        if k in free:
            t = cases.align_rows(t, j)
        _close(t, j, TOL, f"{name} output {k}")
    for i, t, j in zip(wrt, t_grad, j_grad):
        _close(t, j, TOL, f"{name} gradient wrt input {i}")


def test_shared_spec_table_is_the_sweeps():
    """`torch_sweep_cases.SPECS` (what the card's sweep runs) is
    `test_op_sweep.SPECS`, input for input, each bound through the card's
    copy of `run_spec`'s signature on one side and through `run_spec`
    itself on the other."""
    assert sorted(cases.SPECS) == sorted(jsweep.SPECS)
    assert inspect.signature(cases._run_spec_signature) == \
        inspect.signature(jsweep.run_spec)
    for name in jsweep.SPECS:
        mine = cases.spec_case(name)
        saved, cases.SPECS = cases.SPECS, jsweep.SPECS
        try:
            theirs = cases.spec_case(name, run_spec=jsweep.run_spec)
        finally:
            cases.SPECS = saved
        assert mine[0] == theirs[0] and mine[2:] == theirs[2:], name
        assert len(mine[1]) == len(theirs[1])
        for x, y in zip(mine[1], theirs[1]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", SWEPT)
def test_op_matches_reference(name):
    _both(cases.spec_case(name))


def test_sweep_covers_every_ported_op():
    covered = set(SWEPT) | set(EXEMPT)
    missing = []
    for n in treg.list_ops():
        op = treg.get_op(n)
        if not ({op.name} | set(op.aliases)) & covered:
            missing.append(n)
    assert not missing, f"ops neither swept nor exempt: {missing}"


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_op_case_matches_reference(case):
    _both(cases.extra_case(case))
