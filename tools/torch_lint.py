#!/usr/bin/env python
"""Invariant linter for the PyTorch port (`mxnet_tpu_torch/`), the
counterpart of `tools/lint_mxtpu.py`.

    python tools/torch_lint.py                   # lint vs the baseline
    python tools/torch_lint.py --write-baseline  # accept current findings
    python tools/torch_lint.py --rules pickle-in-wire,env-registry

Lints the port's package, `tools/torch_*.py` and `chip_smoke.py` with
`mxnet_tpu_torch.analysis.lint_rules` against the knobs of the port's
`config.py`.  Exit code 0 = no finding outside the baseline
(`mxnet_tpu_torch/analysis/lint_baseline.json`, keyed `rule:path:token`
with a reason each).  Every new finding prints a grep-able
``LINT-FINDINGS {json}`` line.  Imports neither JAX nor the JAX package.
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

BASELINE_PATH = os.path.join(_REPO, "mxnet_tpu_torch", "analysis",
                             "lint_baseline.json")


def load_baseline(path):
    if not os.path.exists(path):
        return {}
    with open(path, "r") as f:
        data = json.load(f)
    return dict(data.get("findings", {}))


def run_lint(rules=None, baseline_path=BASELINE_PATH,
             write_baseline=False, out=sys.stdout):
    """Returns (new_findings, baselined_count, stale_keys)."""
    from mxnet_tpu_torch.analysis.lint_rules import lint_path
    findings = lint_path(_REPO, rules=rules)
    baseline = load_baseline(baseline_path)
    if write_baseline:
        payload = {
            "_comment": "Accepted lint findings of the PyTorch port, keyed "
                        "rule:path:token (line-number free). Remove an "
                        "entry when the debt is paid; torch_lint.py fails "
                        "on anything not listed here.",
            "findings": {f.key: {"rule": f.rule, "path": f.path,
                                 "reason": baseline.get(f.key, {}).get(
                                     "reason", "TODO: justify")}
                         for f in findings},
        }
        with open(baseline_path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}",
              file=out)
        return [], len(findings), []
    new = [f for f in findings if f.key not in baseline]
    seen = {f.key for f in findings}
    stale = sorted(k for k in baseline if k not in seen)
    for f in new:
        print("LINT-FINDINGS " + json.dumps(f.to_dict(), sort_keys=True),
              file=out)
        print(f"  {f.path}:{f.line}: [{f.rule}] {f.message}", file=out)
    for k in stale:
        print(f"note: stale baseline entry (finding gone): {k}", file=out)
    print(f"lint: {len(new)} new finding(s), {len(findings) - len(new)} "
          f"baselined, {len(stale)} stale baseline entr(ies)", file=out)
    return new, len(findings) - len(new), stale


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of the rules")
    ap.add_argument("--write-baseline", action="store_true")
    args = ap.parse_args(argv)
    rules = [r.strip() for r in args.rules.split(",")] if args.rules \
        else None
    new, _n, _stale = run_lint(rules=rules,
                               write_baseline=args.write_baseline)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
