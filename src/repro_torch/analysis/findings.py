"""Finding/Report types for the static analyzer.

A *finding* is one rule firing (or passing) on one program.  A *report*
is a collection of findings over a sweep: it renders a human table,
mirrors every finding as a JSON line through :mod:`repro.obs.log` (same
sink the serving layer uses, so CI artifacts interleave), and reduces to
an exit code (nonzero iff any ``error``-severity finding).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

from repro_torch.obs.log import log_event

__all__ = ["Finding", "Report", "ERROR", "WARNING", "INFO"]

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule outcome on one program.

    ``rule`` is a stable dotted id (``purity.callback_in_scan``);
    ``program`` names the analyzed program (``tick/event/frozen/telem``);
    ``location`` is a best-effort pointer into the artifact (an eqn path
    like ``scan[0].cond[1]``, a BlockSpec operand name, a dataclass
    field).
    """

    rule: str
    severity: str
    program: str
    message: str
    location: str = ""

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity must be one of {_SEVERITIES}, got "
                f"{self.severity!r}")

    def row(self) -> List[str]:
        return [self.severity.upper(), self.program, self.rule,
                self.location, self.message]


class Report:
    """Accumulates findings across a sweep; renders + scores them."""

    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.programs_checked: List[str] = []

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        for f in findings:
            self.add(f)

    def mark_checked(self, program: str) -> None:
        if program not in self.programs_checked:
            self.programs_checked.append(program)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors

    def exit_code(self) -> int:
        return 1 if self.errors else 0

    # -- rendering ---------------------------------------------------------

    def table(self, *, include_info: bool = False) -> str:
        """Aligned human-readable findings table (markdown-compatible:
        the CI job appends it verbatim to the step summary)."""
        shown = [f for f in self.findings
                 if include_info or f.severity != INFO]
        header = ["severity", "program", "rule", "location", "message"]
        rows = [f.row() for f in shown]
        widths = [max(len(header[i]), *(len(r[i]) for r in rows))
                  if rows else len(header[i]) for i in range(len(header))]
        fmt = lambda r: "| " + " | ".join(
            c.ljust(w) for c, w in zip(r, widths)) + " |"
        lines = [fmt(header),
                 "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
        lines += [fmt(r) for r in rows]
        if not rows:
            lines.append(fmt(["-"] * len(header)))
        lines.append("")
        lines.append(
            f"{len(self.programs_checked)} program(s) checked, "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s).")
        return "\n".join(lines)

    def emit_json(self) -> None:
        """Mirror every finding through the shared JSON-lines event log
        (set ``REPRO_EVENT_LOG=path`` to capture; see obs/log.py)."""
        for f in self.findings:
            log_event("analysis_finding", rule=f.rule, severity=f.severity,
                      program=f.program, location=f.location,
                      message=f.message)
        log_event("analysis_report", programs=len(self.programs_checked),
                  errors=len(self.errors), warnings=len(self.warnings))

    def summary(self) -> str:
        verdict = "PASS" if self.ok() else "FAIL"
        return (f"analysis: {verdict} -- {len(self.programs_checked)} "
                f"program(s), {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")


def finding_or_none(condition: bool, finding: Finding) -> Optional[Finding]:
    """Tiny helper: ``finding`` if ``condition`` else None (filter-friendly)."""
    return finding if condition else None
