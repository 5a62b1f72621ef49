"""Program auditor: statically check a step program the port captures as
a CUDA graph (the counterpart of `mxnet_tpu/analysis/program_audit.py`,
which walks a jaxpr and its lowered MLIR).

The port's programs are `build_steps` plans (op, attrs, inputs, outputs)
whose control-flow nodes carry their bodies as symbol JSON, so the
auditor walks the plan, recursively through every body, and never runs
a kernel:

* **host-callback** -- an op no CUDA graph can hold
  (`graph_compile.uncapturable_ops`: ``Custom``, ``_cond`` and the
  ``MXTPU_GRAPH_COMPILE_DENY`` set) anywhere inside a plan the port
  means to capture, bodies included.  Fallback islands are the one
  sanctioned home for host round-trips: in an island plan the eager
  nodes between islands are declared, and only an uncapturable op
  inside a ``_subgraph_op`` island is a finding.
* **f64-promotion** -- a float64 value inside a program whose inputs
  carry none (2x memory, off the tensor cores).  The plan runs once on
  ``meta`` tensors, which carry shapes and dtypes and no values.
* **retrace-hazard** -- an lr/wd value baked into the captured step (an
  attr of a plan step, or a static hyperparameter of an update group)
  instead of read from the step's device buffer of scalars: a schedule
  changing it would need a new capture each step.  Trivial constants
  0/+-1 are exempt.
* **donation-miss** -- a parameter or optimizer state the step updates
  in place whose storage (``data_ptr``) changed across the last step or
  since the capture: a CUDA graph writes the buffer it captured, so a
  rebound tensor is updated nowhere (the JAX package's claimed-but-
  unaliased donation).

Findings are structured :class:`Finding` objects, counted in the
profiler ``audit`` family, and printable as grep-able ``AUDIT-FINDINGS``
lines via :func:`dump_findings`.  `GraphProgram.audit` and
`FusedTrainStep.audit` delegate here.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import torch

from .. import profiler as _prof

__all__ = ["Finding", "R_HOST_CALLBACK", "R_DONATION", "R_F64",
           "R_RETRACE", "audit_plan", "audit_storage", "walk_plan",
           "dump_findings", "record"]

# rule ids (stable: counters key on them)
R_HOST_CALLBACK = "host-callback"
R_DONATION = "donation-miss"
R_F64 = "f64-promotion"
R_RETRACE = "retrace-hazard"

_F64_DTYPES = (torch.float64, torch.complex128)
_TRIVIAL_SCALARS = (0.0, 1.0, -1.0)
#: the attrs that carry a control-flow node's body graphs as JSON
_BODY_ATTRS = ("__subgraph__", "__body__", "__cond__", "__then__",
               "__else__")


@dataclass
class Finding:
    """One statically-detected contract violation in a step program."""
    program: str          # e.g. "fused_step", "graph_program:fwd"
    rule: str             # rule id (R_* above)
    location: str         # plan path ("steps[3]/_foreach/nodes[0]")
    detail: str           # human-readable specifics
    primitive: str = ""   # offending op or tensor name, when applicable
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> str:
        """Stable identity (no step indices -- those drift with unrelated
        graph edits)."""
        return f"{self.rule}:{self.program}:{self.primitive or 'program'}"

    def to_dict(self) -> Dict[str, Any]:
        d = {"program": self.program, "rule": self.rule,
             "location": self.location, "detail": self.detail}
        if self.primitive:
            d["primitive"] = self.primitive
        if self.extra:
            d["extra"] = self.extra
        return d


def _body_nodes(text: str):
    """(op, attrs) of every compute node of a body graph's JSON."""
    try:
        nodes = json.loads(text).get("nodes", [])
    except (TypeError, ValueError):
        return []
    return [(n.get("op"), n.get("attrs") or n.get("attr") or {})
            for n in nodes if n.get("op") not in (None, "null")]


def _walk_attrs(attrs: Mapping, path: str):
    for key in _BODY_ATTRS:
        text = attrs.get(key)
        if isinstance(text, str):
            for j, (op, sub) in enumerate(_body_nodes(text)):
                here = f"{path}/{key}/nodes[{j}]"
                yield op, sub, here
                yield from _walk_attrs(sub, here)


def walk_plan(plan):
    """Depth-first ``(top-level step index, op name, attrs, path)`` over a
    `build_steps` plan, recursing through every control-flow body."""
    _names, steps, _heads = plan
    for i, (op, attrs, _ins, _outs, _mut) in enumerate(steps):
        here = f"steps[{i}]"
        yield i, op.name, attrs, here
        for name, sub, path in _walk_attrs(attrs, f"{here}/{op.name}"):
            yield i, name, sub, path


def _hazards(hazard_values):
    out = []
    for label, vals in (hazard_values or {}).items():
        for v in vals:
            v = float(v)
            if v not in _TRIVIAL_SCALARS:
                out.append((label, v))
    return out


def _matches(value, hazards):
    try:
        fval = float(value)
    except (TypeError, ValueError):
        return None
    for label, hv in hazards:
        # a value that went through float32 matches after rounding too
        if fval == hv or float(torch.tensor(fval, dtype=torch.float32)) == \
                float(torch.tensor(hv, dtype=torch.float32)):
            return label, hv
    return None


def _f64_findings(program, plan, feed_meta) -> List[Finding]:
    """Run the plan on ``meta`` tensors and report the first float64
    output of each step, when no input is float64."""
    from ..graph_compile import _call
    if any(t.dtype in _F64_DTYPES for t in feed_meta.values()):
        return []
    var_names, steps, _heads = plan
    vals = {n: feed_meta[n] for n in var_names if n in feed_meta}
    meta = torch.device("meta")
    out: List[Finding] = []
    with torch.no_grad():
        for i, (op, attrs, in_keys, out_keys, _mut) in enumerate(steps):
            if any(k not in vals for k in in_keys):
                continue
            try:
                outs = _call(op, attrs, [vals[k] for k in in_keys], False,
                             None, meta)
            except Exception:
                continue  # an op that needs values: nothing to infer
            for k, o in zip(out_keys, outs):
                vals[k] = o
            bad = [o for o in outs if isinstance(o, torch.Tensor)
                   and o.dtype in _F64_DTYPES]
            if bad:
                out.append(Finding(
                    program, R_F64, f"steps[{i}]",
                    f"`{op.name}` produces {bad[0].dtype} in a program "
                    "whose inputs carry no float64 -- an implicit "
                    "promotion (2x memory, off the tensor cores)",
                    primitive=op.name))
    return out


def audit_plan(program: str, plan, *,
               feed: Optional[Mapping[str, torch.Tensor]] = None,
               islands: bool = False,
               hazard_values: Optional[Dict[str, Iterable[float]]] = None
               ) -> List[Finding]:
    """Audit one `build_steps` plan the port captures.

    ``islands``: the plan is an island plan, whose top-level uncapturable
    nodes are declared and run eagerly; only ``_subgraph_op`` islands
    must be clean.  ``feed`` ({name: tensor}, any device) gives the
    inputs' shapes and dtypes for the float64 rule (skipped without it).
    ``hazard_values``: label -> live per-step scalars (``{"lr": (0.1,),
    "wd": (1e-4,)}``); a step attr equal to one is a baked scalar."""
    from ..graph_compile import uncapturable_ops
    bad_ops = uncapturable_ops()
    hazards = _hazards(hazard_values)
    _names, steps, _heads = plan
    findings: List[Finding] = []
    for i, name, attrs, path in walk_plan(plan):
        top = steps[i][0].name
        if name in bad_ops and not (islands and top != "_subgraph_op"):
            findings.append(Finding(
                program, R_HOST_CALLBACK, path,
                f"`{name}` cannot be held by a CUDA graph (it runs on "
                "the host) but sits in a plan the port captures; run it "
                "between fallback islands instead", primitive=name))
        if hazards:
            for key, value in attrs.items():
                if isinstance(value, str) and key.startswith("__"):
                    continue
                hit = _matches(value, hazards) \
                    if not isinstance(value, (dict, list, tuple)) else None
                if hit is not None:
                    findings.append(Finding(
                        program, R_RETRACE, path,
                        f"{hit[0]}={hit[1]!r} is baked into `{name}` as "
                        f"attr {key!r}; a schedule changing it needs a "
                        "new capture every step -- read it from the "
                        "step's device buffer", primitive=name,
                        extra={"label": hit[0], "value": hit[1]}))
    if feed is not None:
        meta = {n: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
                for n, t in feed.items()}
        findings += _f64_findings(program, plan, meta)
    return findings


def audit_storage(program: str, before: Mapping[str, int],
                  after: Mapping[str, int]) -> List[Finding]:
    """The donation rule: every tensor the step updates in place
    (name -> ``data_ptr`` before the step or at the capture) must keep
    its storage (``after``).  Counts the checked and kept tensors."""
    findings = []
    kept = 0
    for name, ptr in before.items():
        if after.get(name) == ptr:
            kept += 1
            continue
        findings.append(Finding(
            program, R_DONATION, "storage",
            f"`{name}` is updated in place by the step but its storage "
            f"moved (0x{ptr:x} -> 0x{after.get(name, 0):x}); a captured "
            "graph writes the buffer it captured, so the new tensor "
            "would never see the update", primitive=name))
    _prof.bump_audit("donated_leaves_checked", len(before))
    _prof.bump_audit("donation_aliases_confirmed", kept)
    return findings


def record(findings: Sequence[Finding]) -> List[Finding]:
    """Count one audited program and its findings in the ``audit``
    family; returns ``findings``."""
    _prof.bump_audit("programs_audited")
    if findings:
        _prof.bump_audit("findings_total", len(findings))
        for f in findings:
            _prof.bump_audit("findings_" + f.rule.replace("-", "_"))
    else:
        _prof.bump_audit("clean_programs")
    return list(findings)


def dump_findings(findings: Sequence[Finding], out=None) -> None:
    """Print one grep-able ``AUDIT-FINDINGS`` line per finding, or a
    single all-clean line when there are none."""
    import sys
    out = out if out is not None else sys.stdout
    if not findings:
        print("AUDIT-FINDINGS none", file=out)
        return
    for f in findings:
        print("AUDIT-FINDINGS " + json.dumps(f.to_dict(), sort_keys=True),
              file=out)
