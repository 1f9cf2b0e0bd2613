"""Collective lint: count and byte budgets over the collectives a target
makes on each rank; the port's counterpart of ``repro/analysis/hlo_lint.py``.

The reference reads collectives from compiled HLO; the port records the
``torch.distributed`` calls each rank makes (``launch/collectives.py``).
A target's profile is, per kind, the largest count and the largest
received bytes over its ranks (the busiest rank: XLA's SPMD program is one
rank's too). Rules, with the reference's budget schema, 0.25 tolerance,
4096-byte slack, missing-budget error, large-undershoot warning, exact
mode and aliases:

  collective-count-budget / collective-bytes-budget
      Per-target collective counts and received bytes vs a committed
      budget (``analysis/budgets/<target>.json``), within a relative
      tolerance. A new collective kind fails; a large undershoot is a
      warning (a stale budget: regenerate with ``--update-budgets``).
      ``exact`` demands equality both ways (the telemetry-off proof).

  collective-replicated-egress
      In the param-sharded sync, a rank received the whole fp32 ``[n_pad]``
      row through a collective that replicates (all-reduce, all-gather,
      broadcast) — the egress regression the param-sharded unpack removed.
      A call is judged by the bytes it fills on the rank, summed over its
      buffers, whatever their dtype: the port's own all-gather
      (``sharding._gather_along``) moves byte views in a list of per-rank
      chunks. An all-to-all hands each rank different elements and never
      counts.

The budgets are the port's own numbers (gloo's buffers, not XLA's);
PERF.md sets each beside the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.launch.collectives import (CollectiveCall, collective_bytes,
                                            collective_counts)

BUDGET_DIR = os.path.join(os.path.dirname(__file__), "budgets")
DEFAULT_TOLERANCE = 0.25
# collectives smaller than this never trip a byte budget (the reference's slack)
_BYTES_SLACK = 4096
#: the kinds whose result is the same on every rank of the group
REPLICATING = ("all-reduce", "all-gather", "broadcast")


@dataclasses.dataclass
class CollectiveCheckSpec:
    """What to enforce for one target."""

    name: str                                     # target / budget-file stem
    #: a replicating collective must never fill this many bytes or more on
    #: a rank (summed over its buffers), e.g. 4 * n_pad for the fp32 row
    forbid_replicated_bytes: Optional[int] = None
    check_budget: bool = True
    #: check against ANOTHER target's committed budget (such targets never
    #: write one on --update-budgets)
    budget_name: Optional[str] = None
    #: counts and bytes must EQUAL the budget's, both ways
    exact: bool = False


def profile(ranks: Sequence[Sequence[CollectiveCall]]) -> Dict[str, Dict[str, int]]:
    """``{"collective_counts", "collective_bytes"}``: per kind, the largest
    count and the largest received bytes over the ranks."""
    counts: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    for calls in ranks:
        for kind, n in collective_counts(calls).items():
            counts[kind] = max(counts.get(kind, 0), n)
        for kind, b in collective_bytes(calls).items():
            nbytes[kind] = max(nbytes.get(kind, 0), b)
    return {"collective_counts": dict(sorted(counts.items())),
            "collective_bytes": dict(sorted(nbytes.items()))}


# ------------------------------------------------------------------ budgets
def budget_path(name: str, budget_dir: Optional[str] = None) -> str:
    return os.path.join(budget_dir or BUDGET_DIR, f"{name}.json")


def load_budget(name: str, budget_dir: Optional[str] = None) -> Optional[Dict]:
    path = budget_path(name, budget_dir)
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def make_budget(ranks: Sequence[Sequence[CollectiveCall]], name: str,
                tolerance: float = DEFAULT_TOLERANCE, meta: Optional[Dict] = None) -> Dict:
    """Measure a target's ranks into a committable budget dict."""
    budget = {"target": name, "tolerance": tolerance, **profile(ranks)}
    if meta:
        budget.update(meta)
    return budget


def write_budget(budget: Dict, budget_dir: Optional[str] = None) -> str:
    path = budget_path(budget["target"], budget_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(budget, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def _check_budget_exact(measured: Dict, spec: CollectiveCheckSpec,
                        budget: Dict) -> List[Finding]:
    """Every kind's count AND bytes equal the committed budget, both ways:
    one extra all-reduce or one extra byte fails."""
    findings: List[Finding] = []
    ref = budget.get("target", spec.budget_name or spec.name)
    for field, rule in (("collective_counts", "collective-count-budget"),
                        ("collective_bytes", "collective-bytes-budget")):
        got, want = measured[field], budget.get(field, {})
        for kind in sorted(set(got) | set(want)):
            g, w = got.get(kind, 0), want.get(kind, 0)
            if g != w:
                findings.append(Finding(
                    rule=rule, severity=ERROR, target=spec.name, location=f"op kind {kind}",
                    message=(f"{field.split('_')[1]} of {kind}: {g} != {w} committed for "
                             f"{ref!r} (exact match required — this target must make the "
                             f"byte-identical collective schedule)")))
    return findings


def _check_budget(measured: Dict, spec: CollectiveCheckSpec,
                  budget: Optional[Dict]) -> List[Finding]:
    budget_ref = spec.budget_name or spec.name
    if budget is None:
        return [Finding(
            rule="collective-budget-missing", severity=ERROR, target=spec.name,
            location=budget_path(budget_ref),
            message=("no committed collective budget for this target — run "
                     "`python -m repro_torch.analysis --update-budgets` and commit the "
                     "generated file"))]
    if spec.exact:
        return _check_budget_exact(measured, spec, budget)
    findings: List[Finding] = []
    tol = float(budget.get("tolerance", DEFAULT_TOLERANCE))
    counts, nbytes = measured["collective_counts"], measured["collective_bytes"]
    b_counts: Dict[str, int] = budget.get("collective_counts", {})
    b_bytes: Dict[str, int] = budget.get("collective_bytes", {})

    for kind, n in sorted(counts.items()):
        allowed = b_counts.get(kind)
        if allowed is None:
            findings.append(Finding(
                rule="collective-count-budget", severity=ERROR, target=spec.name,
                location=f"op kind {kind}",
                message=(f"{n} {kind} call(s) but the budget has none of this kind — a new "
                         f"collective appeared in the schedule")))
        elif n > allowed * (1.0 + tol) + 1:
            findings.append(Finding(
                rule="collective-count-budget", severity=ERROR, target=spec.name,
                location=f"op kind {kind}",
                message=(f"{n} {kind} calls vs budget {allowed} "
                         f"(+{(n / allowed - 1) * 100:.0f}%, tolerance {tol * 100:.0f}%)")))
    for kind, b in sorted(nbytes.items()):
        allowed = b_bytes.get(kind, 0)
        if b > allowed * (1.0 + tol) + _BYTES_SLACK:
            over = f"+{(b / allowed - 1) * 100:.0f}%" if allowed else "new kind"
            findings.append(Finding(
                rule="collective-bytes-budget", severity=ERROR, target=spec.name,
                location=f"op kind {kind}",
                message=(f"{b} received bytes of {kind} vs budget {allowed} ({over}, "
                         f"tolerance {tol * 100:.0f}%)")))
    total, b_total = sum(nbytes.values()), sum(b_bytes.values())
    if total > b_total * (1.0 + tol) + _BYTES_SLACK:
        over = f"+{(total / b_total - 1) * 100:.0f}%" if b_total else "empty budget"
        findings.append(Finding(
            rule="collective-bytes-budget", severity=ERROR, target=spec.name,
            location="total",
            message=(f"{total} total received bytes vs budget {b_total} ({over}, "
                     f"tolerance {tol * 100:.0f}%)")))
    elif b_total and total < b_total * (1.0 - tol) - _BYTES_SLACK:
        findings.append(Finding(
            rule="collective-bytes-budget", severity=WARNING, target=spec.name,
            location="total",
            message=(f"{total} total received bytes is {(1 - total / b_total) * 100:.0f}% "
                     f"UNDER budget {b_total} — schedule improved; refresh with "
                     f"--update-budgets")))
    return findings


# -------------------------------------------------------------------- rules
def _check_replicated(ranks: Sequence[Sequence[CollectiveCall]],
                      spec: CollectiveCheckSpec) -> List[Finding]:
    limit = spec.forbid_replicated_bytes
    if limit is None:
        return []
    hit = next(((r, c) for r, calls in enumerate(ranks) for c in calls
                if c.kind in REPLICATING and c.received >= limit), None)
    if hit is None:
        return []
    r, c = hit  # one finding is enough
    return [Finding(
        rule="collective-replicated-egress", severity=ERROR, target=spec.name,
        location=f"rank {r}: {c.fn}",
        message=(f"{c.received} bytes received through {c.fn}, at least the {limit} of the "
                 f"replicated fp32 row (param-sharded egress regression): buffers "
                 f"{c.buffers}"))]


def lint_collectives(ranks: Sequence[Sequence[CollectiveCall]], spec: CollectiveCheckSpec,
                     budget_dir: Optional[str] = None) -> List[Finding]:
    """Every collective rule for one target; ``ranks[r]``: rank r's calls."""
    findings = _check_replicated(ranks, spec)
    if spec.check_budget:
        findings += _check_budget(profile(ranks), spec,
                                  load_budget(spec.budget_name or spec.name, budget_dir))
    return findings
