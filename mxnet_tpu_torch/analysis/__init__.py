"""Static analysis over the port's step programs and source (the
counterpart of `mxnet_tpu/analysis/`).

* :mod:`~mxnet_tpu_torch.analysis.program_audit` -- walks a plan the port
  captures as a CUDA graph (`GraphProgram`, `FusedTrainStep`) and checks
  the one-graph contract: no host-bound op outside declared fallback
  islands, no float64 promotion, no lr/wd baked into the capture, and
  in-place updates that keep their storage across a step.
* :mod:`~mxnet_tpu_torch.analysis.lint_rules` -- AST rules over the
  port's source: the env-knob registry, no raw ``os.environ`` knob reads,
  no pickle on wire modules, chained signal handlers, atomic checkpoint
  writes, no host sync inside a captured function.
  `tools/torch_lint.py` is the CLI, against the baseline beside these
  modules (``lint_baseline.json``).
"""
from .program_audit import (Finding, audit_plan, audit_storage,
                            dump_findings)
from .lint_rules import LintFinding, lint_path, lint_source, RULES

__all__ = ["Finding", "audit_plan", "audit_storage", "dump_findings",
           "LintFinding", "lint_path", "lint_source", "RULES"]
