"""Legacy top-level nn ops (the counterpart of `mxnet_tpu/ops/nn_legacy.py`;
reference `src/operator/ctc_loss.cc`): ``CTCLoss``.

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

from .registry import alias, register

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
