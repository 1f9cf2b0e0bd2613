"""``python -m repro_torch.analysis`` — run the three static-analysis layers.

Layers (select with ``--layers``):
  ast         Python AST rules over ``src/repro_torch`` (no ranks needed)
  trace       op-trace rules over each target's run (f64, host syncs,
              kernel presence)
  collective  collective count / byte budgets and the replicated-egress rule
              over each rank's ``torch.distributed`` calls

``--device`` is ``cuda`` by default, as for every entry point of the port:
without a card ``main`` raises (``repro_torch.resolve_device``); pass
``--device cpu`` to run on the CPU. Only the op-trace layer follows it.
``--device cuda`` runs the trace layer's targets on the card, one rank,
with kernel presence read from ``kernels.LAUNCHES``; with ``--device cpu``
the trace layer reads the gloo ranks' run. The AST layer reads source
files, and the collective layer always runs over 8 gloo ranks on the CPU
(``targets.run_on_ranks``; ``launch.mesh.spawn_ranks`` gives each rank
its share of the host's threads), whatever the device: the reference
counts its collectives on 8 host devices, and gloo's ``all_to_all``
aborts on CUDA tensors (``shard_kernels.exchange``).

Exit status is nonzero iff an error-severity finding fired. ``--json``
writes the machine-readable report; ``--update-budgets`` regenerates the
committed per-target collective budgets from the current tree instead of
checking them.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from repro_torch import resolve_device
from repro_torch.analysis.findings import Report

#: the AST layer's default tree: this package's own
DEFAULT_SRC = (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),)
ALL_LAYERS = ("ast", "trace", "collective")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="three-layer static analysis gate (AST / op trace / collectives)")
    ap.add_argument("--layers", type=str, default="all",
                    help="comma list of ast,trace,collective (default: all)")
    ap.add_argument("--src", type=str, nargs="*", default=None,
                    help="paths for the AST layer (default: src/repro_torch)")
    ap.add_argument("--json", type=str, default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--update-budgets", action="store_true",
                    help="regenerate committed collective budgets from the current tree "
                         "instead of checking them")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the trace layer runs: cuda (default; raises without a "
                         "card) or cpu (the gloo ranks)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    layers = (list(ALL_LAYERS) if args.layers == "all"
              else [l.strip() for l in args.layers.split(",") if l.strip()])
    unknown = [l for l in layers if l not in ALL_LAYERS]
    if unknown:
        ap.error(f"unknown layer(s) {unknown}; have {list(ALL_LAYERS)}")

    report = Report(meta={"layers": layers})

    # ---- AST layer: pure stdlib, runs first
    if "ast" in layers:
        from repro_torch.analysis.ast_lint import lint_paths

        src = args.src if args.src is not None else list(DEFAULT_SRC)
        report.meta["ast_paths"] = src
        report.extend(lint_paths(src))

    # ---- traced layers: the targets on the ranks (and on the card)
    if "trace" in layers or "collective" in layers:
        import torch

        from repro_torch.analysis import targets as targets_mod

        specs = targets_mod.resolve()
        on_card = torch.device(args.device).type == "cuda"
        ranks = traced = None
        if "collective" in layers or not on_card:
            ranks = targets_mod.run_on_ranks(specs)
        if "trace" in layers:
            traced = targets_mod.run_on_device(specs, args.device) if on_card else ranks
        report.meta.update(torch_version=torch.__version__, backend="gloo",
                           n_ranks=targets_mod.N_RANKS, device=args.device,
                           targets=[s.name for s in specs])
        if on_card:
            report.meta["device_name"] = torch.cuda.get_device_name(0)
        report.extend(lint_runs(specs, traced=traced,
                                ranks=ranks if "collective" in layers else None,
                                update_budgets=args.update_budgets))

    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(report.to_json())
            fh.write("\n")
    print(report.summary())
    return 0 if report.ok else 1


def lint_runs(specs, traced=None, ranks=None, update_budgets: bool = False,
              budget_dir: Optional[str] = None):
    """The findings of the trace layer over ``traced`` and of the collective
    layer over ``ranks`` (each ``{name: [TargetRun, ...]}``, as
    ``targets.run_on_ranks`` / ``run_on_device`` return; ``None`` skips the
    layer) for the targets ``specs``, against the budgets in ``budget_dir``
    (the committed ones by default). ``update_budgets`` first writes each
    target's budget from ``ranks``, with the default tolerance."""
    import torch

    from repro_torch.analysis.collective_lint import (lint_collectives, make_budget,
                                                      write_budget)
    from repro_torch.analysis.op_trace import lint_trace
    from repro_torch.analysis.targets import N_RANKS

    findings = []
    for spec in specs:
        if traced is not None:
            seen = set()
            for run in traced[spec.name]:  # one finding over the ranks
                for f in lint_trace(run.trace, spec.name, spec.expect_kernels):
                    if (f.rule, f.location) not in seen:
                        seen.add((f.rule, f.location))
                        findings.append(f)
        if ranks is None:
            continue
        runs = ranks[spec.name]
        calls = [run.calls for run in runs]
        check = spec.check_spec(runs[0].n_pad)
        # a target that checks ANOTHER target's budget never owns a file:
        # its check stays live against the fresh budget
        if update_budgets and spec.budget_name is None:
            budget = make_budget(
                calls, spec.name,
                meta={"torch_version": torch.__version__, "backend": "gloo",
                      "n_ranks": N_RANKS, "description": spec.description})
            print(f"wrote {write_budget(budget, budget_dir)}")
            check.check_budget = False  # fresh by definition
        findings += lint_collectives(calls, check, budget_dir=budget_dir)
    return findings
