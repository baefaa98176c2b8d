"""Shared finding record for the port's static-analysis passes.

Every pass (``contracts`` / ``lint`` / ``launch``) reports the same
:class:`Finding` shape so the CLI, the baseline file, and the tests all
speak one format. A finding is frozen — passes build them, consumers only
read; ``baselined``/``suppressed`` annotations come back as *new* records
via :func:`dataclasses.replace` so a list of findings is safely shareable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["Finding", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect reported by a pass.

    ``path`` is the primary file (repo-relative where possible) and
    ``related`` names the other side(s) of a cross-file contract — the
    contract checker always fills it, so a report names EVERY file that
    must move together. ``source`` holds the stripped source-line text for
    lint findings: the baseline keys on it instead of the line number, so
    frozen debt survives unrelated edits shifting lines."""

    pass_name: str  # "contracts" | "lint" | "launch"
    rule: str
    message: str
    path: str = ""
    line: int = 0
    related: Tuple[str, ...] = ()
    source: str = ""
    suppressed: bool = False  # via `# repro_torch: noqa[rule]`
    baselined: bool = False  # frozen in the checked-in baseline

    def key(self) -> str:
        """Baseline identity: file + rule + normalized source text (line
        numbers drift; the offending line's text does not)."""
        return f"{self.path}::{self.rule}::{self.source}"

    @property
    def live(self) -> bool:
        """Counts against ``--strict``: neither suppressed nor baselined."""
        return not (self.suppressed or self.baselined)

    def render(self) -> str:
        loc = self.path or "<global>"
        if self.line:
            loc += f":{self.line}"
        tags = "".join(
            t for t, on in ((" [noqa]", self.suppressed),
                            (" [baseline]", self.baselined)) if on
        )
        rel = f" (with {', '.join(self.related)})" if self.related else ""
        return f"{loc}: {self.pass_name}/{self.rule}{tags}: {self.message}{rel}"


def format_findings(findings: List[Finding]) -> str:
    return "\n".join(f.render() for f in findings)
