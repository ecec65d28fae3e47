"""Characterization report — renders probe results as the paper's tables
(a copy of ``repro.core.report``, which has no JAX): markdown tables,
``name,key=value`` CSV lines and a markdown :class:`Report`.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Iterable, List, Mapping, Sequence


def table(headers: Sequence[str], rows: Iterable[Sequence[Any]]) -> str:
    buf = io.StringIO()
    buf.write("| " + " | ".join(headers) + " |\n")
    buf.write("|" + "|".join("---" for _ in headers) + "|\n")
    for row in rows:
        buf.write("| " + " | ".join(_fmt(c) for c in row) + " |\n")
    return buf.getvalue()


def _fmt(x: Any) -> str:
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) >= 1e5 or abs(x) < 1e-3:
            return f"{x:.3e}"
        return f"{x:.3f}"
    return str(x)


def csv_rows(name: str, rows: Iterable[Mapping[str, Any]]) -> str:
    """``name,us_per_call,derived`` style CSV lines for benchmarks.run."""
    out = []
    for row in rows:
        cells = ",".join(f"{k}={_fmt(v)}" for k, v in row.items())
        out.append(f"{name},{cells}")
    return "\n".join(out)


def dataclass_table(items: Sequence[Any],
                    fields: Sequence[str] | None = None) -> str:
    if not items:
        return "(empty)\n"
    fields = list(fields or [f.name for f in dataclasses.fields(items[0])])
    rows = [[getattr(it, f) for f in fields] for it in items]
    return table(fields, rows)


class Report:
    """Accumulates sections and writes one markdown file."""

    def __init__(self, title: str):
        self.title = title
        self.sections: List[str] = []

    def add(self, heading: str, body: str) -> None:
        self.sections.append(f"## {heading}\n\n{body}\n")

    def add_table(self, heading: str, items: Sequence[Any],
                  fields: Sequence[str] | None = None,
                  note: str = "") -> None:
        body = dataclass_table(items, fields)
        if note:
            body += f"\n> {note}\n"
        self.add(heading, body)

    def render(self) -> str:
        return f"# {self.title}\n\n" + "\n".join(self.sections)

    def write(self, path: str) -> None:
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.render())
