"""Legacy top-level nn ops (the counterpart of `mxnet_tpu/ops/nn_legacy.py`;
reference `src/operator/ctc_loss.cc`, `correlation.cc`, `svm_output.cc`,
`crop.cc`, `softmax_activation.cc`, `identity_attach_KL_sparse_reg.cc`,
`plugin/warpctc`): ``CTCLoss``, ``WarpCTC``, ``Correlation``,
``SVMOutput``, ``Crop``, ``SoftmaxActivation`` and
``IdentityAttachKLSparseReg``.  The output layers (``WarpCTC``,
``SVMOutput``) and the regularizer write their defined gradients
(`torch.autograd.Function`), as the JAX package's ``custom_vjp``s do.

The loss is the JAX package's log-domain forward (alpha) recursion over
the blank-extended label, taken over the whole batch at once, one step per
time step, with torch's autograd for the gradient; each step's alphas are
shifted by their largest entry, the shifts summed into the loss.  Its
conventions are the reference's: data ``[T, N, C]`` of unnormalized
activations (a log-softmax is taken over C); the blank is class 0 (``blank_label=
"first"``, labels 1..C-1, padding 0) or class C-1 (``"last"``, padding
-1); without ``label_lengths`` a label's length is its count of non-padding
entries; without ``data_lengths`` every sequence has all T steps.  An
alignment that cannot exist (a label longer than its input allows) keeps
the recursion's floor of -1e30 and so gives a loss of 1e30.  The sum of
two log-probabilities differentiates as JAX's ``logaddexp`` does (each
term weighted by exp(term - sum)), so the gradient agrees with the JAX
op's at those alignments too.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..base import MXNetError
from .registry import Attrs, alias, register

_NINF = -1e30


def _replace_inf(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)), with JAX's derivative."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b,
                          torch.maximum(a, b)
                          + torch.log1p(torch.exp(-delta.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _replace_inf(out)
        return (g * torch.exp(_replace_inf(a) - o),
                g * torch.exp(_replace_inf(b) - o))


def _logaddexp(a, b):
    return _LogAddExp.apply(a, b)


@register("CTCLoss", num_inputs=None,
          input_names=["data", "label", "data_lengths", "label_lengths"])
def _ctc_loss(attrs, data, label, data_lengths=None, label_lengths=None):
    """Per-sequence negative log-likelihood ``[N]`` of ``label`` ``[N, L]``
    under ``data`` ``[T, N, C]``."""
    T, N, C = data.shape
    dev = data.device
    dtype = torch.float64 if data.dtype == torch.float64 else torch.float32
    log_probs = torch.log_softmax(data.to(dtype), dim=-1)
    labels = label.to(torch.int64)
    if attrs.get_str("blank_label", "first") == "first":
        blank, pad_val = 0, 0
    else:
        blank, pad_val = C - 1, -1
    if label_lengths is not None:
        lab_len = label_lengths.to(torch.int64).reshape(-1)
    else:
        lab_len = (labels != pad_val).sum(1)
    if data_lengths is not None:
        in_len = data_lengths.to(torch.int64).reshape(-1)
    else:
        in_len = torch.full((N,), T, dtype=torch.int64, device=dev)
    lab = labels.clamp_min(0)
    S = 2 * lab.shape[1] + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    prev2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                  device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != prev2)
    pos = torch.arange(S, device=dev)
    valid = pos[None, :] < (2 * lab_len + 1)[:, None]
    ninf = torch.full((), _NINF, dtype=dtype, device=dev)
    # [T, N, S]: each step's log-probability of each extended symbol
    lp = log_probs.gather(2, ext[None].expand(T, N, S))
    alpha = torch.where(pos[None, :] == 0, lp[0], ninf)
    alpha = torch.where((pos[None, :] == 1) & (lab_len > 0)[:, None],
                        lp[0], alpha)
    alpha, total = _rescale(alpha)
    pad1 = ninf.expand(N, 1)
    pad2 = ninf.expand(N, 2)
    for t in range(1, T):
        s1 = torch.cat([pad1, alpha[:, :-1]], 1)
        s2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                         ninf)
        new = _logaddexp(_logaddexp(alpha, s1), s2) + lp[t]
        new, shift = _rescale(torch.where(valid, new, ninf))
        live = t < in_len
        alpha = torch.where(live[:, None], new, alpha)
        total = total + torch.where(live, shift, torch.zeros_like(shift))
    end = 2 * lab_len
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_prev = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    ll = _logaddexp(a_end, torch.where(lab_len > 0, a_prev, ninf)) + total
    return (-ll).to(data.dtype)


def _rescale(alpha):
    """``alpha`` less its largest entry per sequence, and that entry.  The
    shift is a constant to autograd: subtracting a constant changes no
    derivative, and it keeps the kept log-probabilities near 0, where
    float32 resolves them finely (at T = 80 the unshifted sums reach -200,
    and the gradient lost 1e-4 of its largest magnitude against
    float64)."""
    shift = alpha.max(1).values.detach()
    return alpha - shift[:, None], shift


alias("CTCLoss", "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss")


# ---------------------------------------------------------------------------
# WarpCTC (`plugin/warpctc/warpctc-inl.h`)
# ---------------------------------------------------------------------------

class _WarpCTC(torch.autograd.Function):
    """Softmax forward over the flattened (T·N, C) activations; backward
    the gradient of the summed CTC loss (blank 0, labels padded with 0),
    whatever gradient comes in."""

    @staticmethod
    def forward(ctx, data, label, T):
        ctx.save_for_backward(data, label)
        ctx.T = T
        return torch.softmax(data, dim=-1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        T, C = ctx.T, data.shape[-1]
        with torch.enable_grad():
            d = data.detach().requires_grad_(True)
            loss = _ctc_loss(Attrs(), d.reshape(T, -1, C), label).sum()
            (grad,) = torch.autograd.grad(loss, d)
        return grad, None, None


@register("WarpCTC", num_inputs=2, input_names=["data", "label"],
          attr_names=["label_length", "input_length"])
def _warpctc(attrs, data, label):
    """Reference `WarpCTC`, an output layer: data (input_length·batch,
    alphabet), label (batch·label_length) with blank 0."""
    T = attrs.get_int("input_length", 0)
    L = attrs.get_int("label_length", 0)
    if T <= 0 or data.shape[0] % T != 0:
        raise MXNetError(f"WarpCTC: input_length {T} must divide data rows "
                         f"{data.shape[0]}")
    N = data.shape[0] // T
    if L <= 0 or label.numel() != N * L:
        raise MXNetError(f"WarpCTC: label size {label.numel()} must equal "
                         f"batch {N} x label_length {L}")
    lab = label.detach().to(torch.int64).reshape(N, L)
    return _WarpCTC.apply(data, lab, T)


# ---------------------------------------------------------------------------
# Correlation (`src/operator/correlation.cc:40-82`)
# ---------------------------------------------------------------------------

@register("Correlation", num_inputs=2, input_names=["data1", "data2"])
def _correlation(attrs, data1, data2):
    """The FlowNet cost volume: for each displacement on a ``stride2``
    grid within ``max_displacement``, the mean over a ``kernel_size``
    window (anchored at its top-left corner, as the reference's) and the
    channels of data1 · shifted data2 (|data1 - shifted data2| without
    ``is_multiply``); the shift wraps around the padded map, as the JAX
    package's ``jnp.roll``."""
    k = attrs.get_int("kernel_size", 1)
    max_disp = attrs.get_int("max_displacement", 1)
    stride1 = attrs.get_int("stride1", 1)
    stride2 = attrs.get_int("stride2", 1)
    pad = attrs.get_int("pad_size", 0)
    is_multiply = attrs.get_bool("is_multiply", True)
    n, c, h, w = data1.shape
    border = max_disp + (k - 1) // 2
    ph, pw = h + 2 * pad, w + 2 * pad
    top_h = -(-(ph - 2 * border) // stride1)
    top_w = -(-(pw - 2 * border) // stride1)
    grid_r = max_disp // stride2
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    ones = data1.new_ones((1, 1, k, k))
    outs = []
    for dy in range(-grid_r, grid_r + 1):
        for dx in range(-grid_r, grid_r + 1):
            shifted = torch.roll(p2, shifts=(-dy * stride2, -dx * stride2),
                                 dims=(2, 3))
            prod = p1 * shifted if is_multiply else torch.abs(p1 - shifted)
            csum = prod.sum(1, keepdim=True)
            win = csum if k == 1 else F.conv2d(csum, ones)
            win = win[:, :, max_disp:max_disp + top_h * stride1:stride1,
                      max_disp:max_disp + top_w * stride1:stride1]
            outs.append(win / (k * k * c))
    return torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# SVMOutput (`src/operator/svm_output-inl.h:102-115`)
# ---------------------------------------------------------------------------

class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the L1 (``use_linear``) or L2 hinge
    loss's gradient, whatever gradient comes in."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.opts = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.opts
        hot = label.to(torch.int64)[..., None] == torch.arange(
            data.shape[-1], device=data.device)
        signed = torch.where(hot, data, -data)
        viol = (signed < margin).to(data.dtype)
        if use_linear:
            grad = torch.where(hot, -viol, viol) * reg
        else:
            mdiff = (margin - signed) * viol * 2 * reg
            grad = torch.where(hot, -mdiff, mdiff)
        return grad, None, None, None, None


@register("SVMOutput", num_inputs=2, input_names=["data", "label"])
def _svm_output(attrs, data, label):
    return _SVMOutput.apply(
        data, label.detach(), attrs.get_float("margin", 1.0),
        attrs.get_float("regularization_coefficient", 1.0),
        attrs.get_bool("use_linear", False))


# ---------------------------------------------------------------------------
# Crop (`src/operator/crop-inl.h:48-90`), SoftmaxActivation
# ---------------------------------------------------------------------------

@register("Crop", num_inputs=None, input_names=["data", "crop_like"])
def _crop(attrs, data, crop_like=None):
    """NCHW ``data`` cut to ``h_w`` (or to ``crop_like``'s H and W), at
    ``offset`` or centred (``center_crop``)."""
    h, w = data.shape[2], data.shape[3]
    if crop_like is not None:
        th, tw = int(crop_like.shape[2]), int(crop_like.shape[3])
    else:
        th, tw = (int(v) for v in attrs.get_tuple("h_w", (0, 0)))
    if attrs.get_bool("center_crop", False):
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = (int(v) for v in attrs.get_tuple("offset", (0, 0)))
    return data[:, :, oy:oy + th, ox:ox + tw]


@register("SoftmaxActivation", num_inputs=1, input_names=["data"])
def _softmax_activation(attrs, data):
    """Softmax over the flattened non-batch axes (``mode='instance'``) or
    over axis 1 (``'channel'``)."""
    if attrs.get_str("mode", "instance") == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg (`identity_attach_KL_sparse_reg.cc`)
# ---------------------------------------------------------------------------

class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparseness penalty's
    gradient penalty·(-rho/rho_hat + (1-rho)/(1-rho_hat)), rho_hat the
    batch mean of sigmoid(data)."""

    @staticmethod
    def forward(ctx, data, rho, penalty):
        ctx.save_for_backward(data)
        ctx.opts = (rho, penalty)
        return data.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        rho, penalty = ctx.opts
        rho_hat = torch.sigmoid(data).mean(0, keepdim=True)
        kl = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl * torch.ones_like(data), None, None


@register("IdentityAttachKLSparseReg", num_inputs=1, input_names=["data"])
def _identity_attach_kl_sparse_reg(attrs, data):
    return _KLSparseReg.apply(data,
                              attrs.get_float("sparseness_target", 0.1),
                              attrs.get_float("penalty", 0.001))
