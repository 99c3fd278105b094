"""One analysis finding (port of ``Diagnostic`` in
``simple_tensorflow_tpu/analysis/diagnostics.py`` :53): a severity, a
stable code (``"hazard/war"``), a message, and the offending op's name and
type. Left out: the report helpers and the monitoring counters."""

from __future__ import annotations

from typing import Any, Optional

NOTE = "note"
WARNING = "warning"
ERROR = "error"
SEVERITIES = (NOTE, WARNING, ERROR)


class Diagnostic:
    __slots__ = ("severity", "code", "message", "op_name", "op_type",
                 "source")

    def __init__(self, severity: str, code: str, message: str,
                 op: Any = None, op_name: Optional[str] = None,
                 op_type: Optional[str] = None,
                 source: Optional[str] = None):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        self.severity = severity
        self.code = code
        self.message = message
        if op is not None:
            op_name = op_name or op.name
            op_type = op_type or op.type
            source = source or getattr(op, "source_site", None)
        self.op_name = op_name
        self.op_type = op_type
        self.source = source

    def format(self) -> str:
        loc = ""
        if self.op_name:
            loc = f" [op {self.op_type or '?'} {self.op_name!r}"
            if self.source:
                loc += f" at {self.source}"
            loc += "]"
        return f"{self.severity.upper()} {self.code}: {self.message}{loc}"

    def __repr__(self):
        return f"<Diagnostic {self.format()}>"
