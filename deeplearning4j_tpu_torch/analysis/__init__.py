"""graftcheck — repo-native static analysis (docs/STATIC_ANALYSIS.md),
the port's copy of ``deeplearning4j_tpu/analysis``.

AST-based (stdlib ``ast``, zero dependencies) checks for the invariants
the repo's hard gates rest on: purity inside the inferred traced set,
determinism of step/replay/export paths, thread-safety discipline at
the spawn sites, and the span-taxonomy / metric-naming /
nothing-stranded contracts.  The rule catalog and a finding's JSON are
the reference's; the purity boundary is the port's: CUDA-graph capture
blocks, ``.apply`` of autograd Functions and callables passed into a
capture (``callgraph``).

Run it::

    python -m deeplearning4j_tpu_torch.analysis            # whole package
    python -m deeplearning4j_tpu_torch check               # same, via the CLI
    python -m deeplearning4j_tpu_torch.analysis --format json

``tests/test_torch_analysis.py`` runs the analyzer over the port as a
tier-1 test: any unsuppressed finding fails it.
"""

from .callgraph import CallGraph, load_package
from .findings import Finding, Rule, RULES
from .runner import (AnalysisResult, run_analysis, update_baseline,
                     default_baseline_path, default_taxonomy_path)

__all__ = [
    "CallGraph", "load_package", "Finding", "Rule", "RULES",
    "AnalysisResult", "run_analysis", "update_baseline",
    "default_baseline_path", "default_taxonomy_path", "main",
]


def main(argv=None) -> int:
    """CLI entry shared by ``python -m deeplearning4j_tpu_torch.analysis``
    and the ``check`` CLI subcommand."""
    import argparse
    import json as _json
    import sys

    p = argparse.ArgumentParser(
        prog="graftcheck",
        description="repo-native static analysis "
                    "(docs/STATIC_ANALYSIS.md)")
    p.add_argument("paths", nargs="*",
                   help="specific .py files (default: the whole "
                   "deeplearning4j_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default="<default>",
                   help="baseline json (default: analysis/baseline.json; "
                   "'none' disables)")
    p.add_argument("--baseline-update", action="store_true",
                   help="append current unsuppressed findings to the "
                   "baseline (REQUIRES --justification)")
    p.add_argument("--justification", default="",
                   help="why the baselined findings are accepted")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also list suppressed findings (text mode)")
    args = p.parse_args(argv)

    baseline = None if args.baseline == "none" else args.baseline
    result = run_analysis(paths=args.paths or None, baseline_path=baseline)

    if args.baseline_update:
        try:
            bp = default_baseline_path() if baseline == "<default>" \
                else baseline
            added = update_baseline(result, bp, args.justification)
        except ValueError as e:
            print(f"graftcheck: error: {e}", file=sys.stderr)
            return 2
        print(f"graftcheck: baselined {added} finding(s) into {bp}")
        return 0

    if args.format == "json":
        print(_json.dumps(result.to_dict(), indent=1))
    else:
        for f in result.findings:
            print(f.format())
        if args.show_suppressed:
            for f, how in result.suppressed:
                print(f"[suppressed by {how}] {f.format()}")
        print(f"graftcheck: {len(result.findings)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{result.n_files} file(s), {len(RULES)} rules, "
              f"{len(result.graph.traced)} traced function(s)")
    return 0 if result.ok else 1
