"""Structured findings of the static program verifier.

The port's copy of ``paddle_tpu/analysis/diagnostics.py``. The JAX
package also hands a failed verification to its flight recorder; the
port's recorder (observability/flight_recorder.py) is not wired here
yet (ROADMAP A11).

A `Diagnostic` pins one defect (or observation) to a program location:
severity, a stable machine-readable code, the op index inside its
block, the *block path* from the root block down through sub-blocks
(While/IfElse bodies), the variable involved, and a fix hint. A
`VerifyReport` aggregates the diagnostics of one verification run and
renders them as text or JSON — the shared currency between the
pre-compile gate (core/executor.py), the generation model's build
check, the trainer setup check and the save gate.
"""
from __future__ import annotations

import json
from enum import IntEnum
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Severity", "Diagnostic", "VerifyReport", "VerificationError"]


class Severity(IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name.lower()


class Diagnostic:
    """One verifier finding, attributable to an op in a block path."""

    __slots__ = ("severity", "code", "message", "block_path", "op_index",
                 "op_type", "var", "hint")

    def __init__(self, severity: Severity, code: str, message: str,
                 block_path: Sequence[int] = (0,),
                 op_index: Optional[int] = None,
                 op_type: Optional[str] = None,
                 var: Optional[str] = None,
                 hint: Optional[str] = None):
        self.severity = Severity(severity)
        self.code = code
        self.message = message
        self.block_path = tuple(int(b) for b in block_path)
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.hint = hint

    @property
    def block_idx(self) -> int:
        """The innermost block holding the finding."""
        return self.block_path[-1]

    def location(self) -> str:
        """Human-readable position: ``block 0 > block 2 / op 3 (while)``."""
        path = " > ".join(f"block {b}" for b in self.block_path)
        if self.op_index is None:
            return path
        op = f"op {self.op_index}"
        if self.op_type:
            op += f" ({self.op_type})"
        return f"{path} / {op}"

    def render(self) -> str:
        line = f"{self.severity}[{self.code}] {self.location()}: " \
               f"{self.message}"
        if self.hint:
            line += f"\n    hint: {self.hint}"
        return line

    def to_dict(self) -> Dict[str, Any]:
        return {"severity": str(self.severity), "code": self.code,
                "message": self.message,
                "block_path": list(self.block_path),
                "op_index": self.op_index, "op_type": self.op_type,
                "var": self.var, "hint": self.hint}

    def __repr__(self):
        return f"Diagnostic({self.severity}[{self.code}] {self.location()})"


class VerifyReport:
    """All diagnostics of one verification run, worst first."""

    def __init__(self, diagnostics: Optional[List[Diagnostic]] = None,
                 program_label: str = "program"):
        self.diagnostics: List[Diagnostic] = list(diagnostics or [])
        self.program_label = program_label
        # filled by the cost_model pass when it runs in the pipeline
        self.cost = None
        # filled by the memory pass / budget gate (analysis/memory.py)
        self.memory = None

    def add(self, diag: Diagnostic) -> Diagnostic:
        self.diagnostics.append(diag)
        return diag

    # -- queries ------------------------------------------------------
    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostic was found."""
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.diagnostics,
                      key=lambda d: (-int(d.severity), d.block_path,
                                     -1 if d.op_index is None
                                     else d.op_index))

    # -- rendering ----------------------------------------------------
    def render_text(self, min_severity: Severity = Severity.INFO) -> str:
        shown = [d for d in self.sorted() if d.severity >= min_severity]
        head = (f"verify {self.program_label}: "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s), "
                f"{len(self.diagnostics) - len(self.errors) - len(self.warnings)}"
                f" note(s)")
        return "\n".join([head] + [d.render() for d in shown])

    def to_json(self) -> str:
        return json.dumps({
            "program": self.program_label,
            "ok": self.ok,
            "counts": {"error": len(self.errors),
                       "warning": len(self.warnings),
                       "info": len(self.diagnostics) - len(self.errors)
                       - len(self.warnings)},
            "diagnostics": [d.to_dict() for d in self.sorted()]})

    def raise_if_errors(self, context: str = ""):
        if not self.ok:
            raise VerificationError(self, context=context)
        return self

    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)


class VerificationError(ValueError):
    """Error-severity diagnostics found by the verifier.

    Subclasses ValueError so call sites that previously relied on the
    executor's runtime guards (e.g. the async donated-state fetch
    ValueError) keep their exception contract when the same defect is
    now caught statically at verify time.
    """

    def __init__(self, report: VerifyReport, context: str = ""):
        self.report = report
        lines = [d.render() for d in report.sorted()
                 if d.severity == Severity.ERROR]
        prefix = f"{context}: " if context else ""
        super().__init__(
            f"{prefix}program verification failed with "
            f"{len(lines)} error(s) (set PADDLE_TPU_VERIFY=0 to bypass "
            f"the gate):\n" + "\n".join(lines))
