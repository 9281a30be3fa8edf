"""Finding / report types shared by the three layers of the port's guard
(the reference's ``staticcheck/report.py``: the same rule ids, the same
JSON).

Everything the gate emits — AST lint hits, collective contract
violations, steady-state audit regressions — is a :class:`Finding` with a
stable rule id, so a failure names the rule (``RS005``, ``IR002``,
``SH001``) instead of handing the reader a stack trace.  :class:`Report`
aggregates them plus per-layer summary counters and serializes to JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

__all__ = ["Finding", "Report", "SEVERITY_ERROR", "SEVERITY_WARNING"]

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"


@dataclasses.dataclass
class Finding:
    """One violation: ``rule`` is a stable id (RSnnn / IRnnn / SHnnn),
    ``path`` a repo-relative file or a symbolic target (``backend:grid``),
    ``line`` 0 when the finding has no source location."""

    rule: str
    path: str
    line: int
    message: str
    severity: str = SEVERITY_ERROR

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} [{self.severity}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    summary: Dict[str, object] = dataclasses.field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_WARNING]

    def to_json(self) -> dict:
        return {
            "summary": self.summary,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings": [f.to_json() for f in self.findings],
        }

    def write(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
