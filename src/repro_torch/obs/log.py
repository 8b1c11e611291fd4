"""Structured run log: typed records first, stdout as a formatted view
(the port's copy of ``repro.obs.log``).

The demos (``examples/elastic_serving.py``, ``examples/elastic_failover.py``)
used to report with raw ``print`` — human-readable, machine-opaque. A
``StructuredLog`` inverts that: callers emit RECORDS (kind + fields, an
optional virtual timestamp), assertions and post-hoc analysis read the
records, and stdout output — when ``echo`` is on — is just a formatted
rendering of the very same records. Nothing is printed that is not also
captured.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, TextIO

__all__ = ["LogRecord", "StructuredLog"]


@dataclasses.dataclass(frozen=True)
class LogRecord:
    kind: str
    fields: Dict[str, Any]
    t: Optional[float] = None     # virtual time, when the producer has one

    def format(self) -> str:
        head = f"[{self.kind}]"
        if self.t is not None:
            head = f"t={self.t:10.4f} {head}"
        body = " ".join(f"{k}={_fmt(v)}" for k, v in self.fields.items())
        return f"{head} {body}".rstrip()

    def to_jsonable(self) -> Dict[str, Any]:
        return {"kind": self.kind, "t": self.t, "fields": dict(self.fields)}


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt(x) for x in v) + "]"
    return str(v)


class StructuredLog:
    def __init__(
        self,
        echo: bool = False,
        stream: Optional[TextIO] = None,
        enabled: bool = True,
    ):
        """``enabled=False`` makes ``emit`` a pure constructor: nothing
        is stored or echoed. The shared ``NULL_OBS`` bundle uses this so
        un-instrumented runs cannot grow global state."""
        self.echo = bool(echo)
        self.enabled = bool(enabled)
        self.stream = stream or sys.stdout
        self.records: List[LogRecord] = []

    def emit(self, kind: str, t: Optional[float] = None, **fields: Any) -> LogRecord:
        rec = LogRecord(kind, fields, t)
        if not self.enabled:
            return rec
        self.records.append(rec)
        if self.echo:
            print(rec.format(), file=self.stream, flush=True)
        return rec

    def by_kind(self, kind: str) -> List[LogRecord]:
        return [r for r in self.records if r.kind == kind]

    def last(self, kind: str) -> Optional[LogRecord]:
        for r in reversed(self.records):
            if r.kind == kind:
                return r
        return None

    def to_jsonable(self) -> List[Dict[str, Any]]:
        return [r.to_jsonable() for r in self.records]

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=2, sort_keys=True)
