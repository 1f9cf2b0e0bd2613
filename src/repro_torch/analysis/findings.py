"""Finding / report types shared by all three analysis layers (a copy of
``repro/analysis/findings.py``: the same fields, JSON and exit semantics).

A ``Finding`` is one rule violation: which rule fired, where (a source
``file:line`` for AST rules, an analysis-target name + op or collective
for the traced layers), and severity. ``error`` findings make
``python -m repro_torch.analysis`` exit nonzero; ``warning`` findings are
reported but do not gate.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Finding:
    rule: str        # rule id, e.g. "collective-bytes-budget"
    severity: str    # ERROR | WARNING
    target: str      # analysis target name, or source file for AST rules
    location: str    # "file:line", "op kind all-reduce", "aten::_local_scalar_dense", ...
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.rule} @ {self.target} "
                f"({self.location}): {self.message}")


@dataclasses.dataclass
class Report:
    """Machine-readable result of one analysis run."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "meta": self.meta,
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        lines = [str(f) for f in self.findings]
        verdict = ("OK" if self.ok else "FAIL")
        lines.append(
            f"repro_torch.analysis: {verdict} — {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)
