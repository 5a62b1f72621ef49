"""The contrib op tail of the port (`mxnet_tpu_torch/ops/contrib_ops.py`,
`contrib_extra.py`, `quantized_ops.py`) against the JAX package's.

* Every case of `tests/torch_contrib_cases.py` (each of the 57 names,
  aliases included) runs through both packages on the same numpy inputs:
  outputs, and for the ``wrt`` inputs the gradient of a fixed random
  projection, within ``TOL`` = 1e-5 of the reference's largest magnitude
  (the op sweep's rule), integer outputs exactly.
* The reference's own cases for these ops (`tests/test_op_reference_
  cases2.py`, `cases3`, `cases6`, `tests/test_op_extra.py` and
  `test_sparse_ndarray_cases.py::test_getnnz`) run on the port with their
  oracles and tolerances, the module's ``mx``/``nd``/``autograd`` swapped
  for the port's.
* The DGL samplers draw from each package's own stream: both are held to
  the structure a sample must have, and the port's pick frequencies to
  the sampling distribution.
* ``SyncBatchNorm`` over 4 gloo ranks inside `parallel.shard_map` against
  the JAX package's op in ``shard_map`` over 4 virtual devices (each
  rank's moments averaged over ``dp``).
* The registries hold the same 485 names.
"""
import contextlib
import importlib
import inspect

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch import test_utils as ttu

import torch_contrib_cases as cc
import torch_sweep_cases as sweep
from torch_spmd_launch import run_suite

TOL = 1e-5
CONTRIB = ("contrib_ops", "contrib_extra", "quantized_ops")


def _close(got, ref, what):
    assert got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}"
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} vs {ref.dtype}"
    if not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    err = np.abs(got[fin] - ref[fin]).max() if fin.any() else 0.0
    assert err <= TOL * max(scale, 1e-30), \
        f"{what}: max error {err} against largest magnitude {scale}"


def test_registries_hold_the_same_names():
    assert set(treg.list_ops()) == set(jreg.list_ops())
    assert len(treg.list_ops()) == 485


def test_cases_cover_every_contrib_name():
    names = {n for n in jreg.list_ops()
             if jreg.get_op(n).fn.__module__.rsplit(".", 1)[-1] in CONTRIB}
    assert len(names) == 57
    covered = {c[0] for c in cc.CASES.values()} | \
        {c[0] for c in cc.SAMPLERS.values()}
    assert names == covered, sorted(names ^ covered)


@pytest.mark.parametrize("case", sorted(cc.CASES))
def test_case_matches_reference(case):
    name, inputs, attrs, wrt = cc.CASES[case]
    j_out, j_grad = sweep.run_case(mx, name, inputs, attrs, wrt,
                                   make=cc.maker(mx))
    with mt.cpu():
        t_out, t_grad = sweep.run_case(mt, name, inputs, attrs, wrt,
                                       make=cc.maker(mt))
    assert len(t_out) == len(j_out)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        _close(t, j, f"{case} output {k}")
    for i, t, j in zip(wrt, t_grad, j_grad):
        _close(t, j, f"{case} gradient wrt input {i}")


# -- the reference's own cases, on the port ---------------------------------

REFERENCE = [
    ("test_op_reference_cases2", n) for n in (
        "test_grid_generator_affine_identity",
        "test_grid_generator_affine_translation_scale",
        "test_grid_generator_warp_zero_flow_is_identity_grid",
        "test_grid_generator_warp_flow_shifts",
        "test_bilinear_sampler_identity_grid",
        "test_bilinear_sampler_half_pixel_interpolates",
        "test_bilinear_sampler_out_of_bounds_zero",
        "test_bilinear_sampler_grad_flows_to_data",
        "test_spatial_transformer_identity_theta",
        "test_spatial_transformer_equals_grid_plus_sampler")] + [
    ("test_op_reference_cases3", n) for n in (
        "test_upsampling_bilinear_matches_torch",
        "test_box_iou_corner_format",
        "test_box_nms_suppresses_overlap")] + [
    ("test_op_reference_cases6", n) for n in (
        "test_div_sqrt_dim", "test_index_copy_forward_and_grads",
        "test_adaptive_avg_pool_matches_manual",
        "test_bilinear_resize_corners")] + [
    ("test_op_extra", n) for n in (
        "test_deformable_conv_zero_offset_equals_conv",
        "test_deformable_conv_integer_shift",
        "test_psroi_pooling_whole_roi_mean",
        "test_deformable_psroi_no_trans_matches_psroi",
        "test_proposal_shapes_and_bounds",
        "test_bipartite_matching_reference_example",
        "test_count_sketch", "test_dgl_sampling_ops",
        "test_sync_batch_norm_matches_bn_single_device")]


def _on_the_port(monkeypatch, module):
    m = importlib.import_module(module)
    swaps = {"mx": mt, "nd": mt.nd, "autograd": mt.autograd,
             "assert_almost_equal": ttu.assert_almost_equal}
    for attr, val in swaps.items():
        if hasattr(m, attr):
            monkeypatch.setattr(m, attr, val)
    return m


@pytest.mark.parametrize("module,name", REFERENCE,
                         ids=[f"{m}-{n}" for m, n in REFERENCE])
def test_reference_case_on_the_port(monkeypatch, module, name):
    m = _on_the_port(monkeypatch, module)
    fn = getattr(m, name)
    assert not inspect.signature(fn).parameters, name
    with mt.cpu():
        fn()


@pytest.mark.parametrize("density", [0.1, 0.5])
def test_getnnz_on_the_port(monkeypatch, density):
    """`test_sparse_ndarray_cases.py::test_getnnz` on the port."""
    m = _on_the_port(monkeypatch, "test_sparse_ndarray_cases")
    with mt.cpu():
        m.test_getnnz(density)


# -- the samplers ------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(cc.SAMPLERS))
def test_sampler_structure_in_both_packages(case):
    name, inputs, attrs = cc.SAMPLERS[case]
    seeds = inputs[-1]
    for pkg in (mx, mt):
        with (mt.cpu() if pkg is mt else contextlib.nullcontext()):
            arrs = [cc.maker(pkg)(x) for x in inputs]
            verts, neigh = getattr(pkg.nd, name)(*arrs, **attrs)
        assert verts.asnumpy().dtype == neigh.asnumpy().dtype == np.int32
        cc.sampler_structure(inputs[0], seeds, verts.asnumpy(),
                             neigh.asnumpy(), attrs["num_neighbor"],
                             attrs["max_num_vertices"])


def test_sampler_frequencies_follow_the_weights():
    """Over many draws, the port's picks of a seed follow its edge weights
    (uniform over neighbors, or the given probabilities) within 5 standard
    errors."""
    name, inputs, attrs = cc.SAMPLERS["dgl_non_uniform"]
    adj, prob = inputs[0], inputs[1]
    seed = 3
    nbrs = np.flatnonzero(adj[seed])
    want = prob[nbrs] / prob[nbrs].sum()
    mt.random.seed(0)
    counts = np.zeros(len(adj))
    draws = 0
    with mt.cpu():
        for _ in range(300):
            _, neigh = mt.nd._contrib_dgl_csr_neighbor_non_uniform_sample(
                mt.nd.array(adj), mt.nd.array(prob),
                mt.nd.array(np.array([seed], np.float32)), num_neighbor=8,
                max_num_vertices=8)
            picks = neigh.asnumpy().reshape(-1)
            picks = picks[picks >= 0]
            np.add.at(counts, picks, 1)
            draws += len(picks)
    freq = counts[nbrs] / draws
    se = np.sqrt(want * (1 - want) / draws)
    assert (np.abs(freq - want) <= 5 * se + 1e-9).all(), (freq, want)
    assert counts[[i for i in range(len(adj)) if i not in nbrs]].sum() == 0


# -- SyncBatchNorm across ranks ---------------------------------------------

N = 4


@pytest.fixture(scope="module")
def sync_bn_ranks():
    return run_suite("sync_bn", N)


def _jax_sync_bn(x, gamma, beta, mm, mv):
    """The JAX package's op inside shard_map over dp = 4 virtual devices,
    each device its quarter of the batch, in training."""
    import jax
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.ops.registry import Attrs, canonical_attrs
    from mxnet_tpu.parallel import collectives as jc
    from mxnet_tpu.parallel.mesh import make_mesh
    fn = jreg.get_op("_contrib_SyncBatchNorm").fn
    attrs = Attrs(canonical_attrs(dict(axis_name="dp", fix_gamma=False,
                                       __train=True)))
    mesh = make_mesh({"dp": N}, devices=jax.devices()[:N])

    def body(xb, g, b, m, v):
        out, nm, nv = fn(attrs, xb, g, b, m, v)
        return out, nm[None], nv[None]

    run = jc.shard_map(body, mesh=mesh,
                       in_specs=(P("dp"), P(), P(), P(), P()),
                       out_specs=(P("dp"), P("dp"), P("dp")))
    out, nm, nv = run(x, gamma, beta, mm, mv)
    return np.asarray(out), np.asarray(nm)[0], np.asarray(nv)[0]


def test_sync_batch_norm_over_four_ranks(sync_bn_ranks):
    """Each rank normalizes its rows with the dp mean of the per-rank
    means and of the per-rank variances, as the JAX package's ``pmean``s
    do; without a mapped axis the op is BatchNorm."""
    import torch_spmd_worker as W
    x, gamma, beta, mm, mv = W.sync_bn_inputs()
    out, nm, nv = _jax_sync_bn(x, gamma, beta, mm, mv)
    rows = x.shape[0] // N
    for r, res in enumerate(sync_bn_ranks):
        _close(res["out"], out[r * rows:(r + 1) * rows], f"rank {r} out")
        _close(res["moving_mean"], nm, f"rank {r} moving mean")
        _close(res["moving_var"], nv, f"rank {r} moving var")
    # the mean of the variances is not the whole batch's variance
    whole = x.var(axis=(0, 2, 3))
    assert not np.allclose(nv, 0.9 * mv + 0.1 * whole, rtol=1e-4)
