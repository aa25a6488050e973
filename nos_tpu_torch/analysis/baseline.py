"""Port of `nos_tpu/analysis/baseline.py:1` (:1-106). Copied near verbatim; the
imports point at the port, which imports nothing of the JAX package.

Suppression baseline: the committed ledger of accepted findings.

Every entry carries a rationale (the `#` comment block directly above it), so
`git blame` is never needed to learn why a finding is tolerated. Format, one
entry per line:

    # rationale for the next entry (required by convention, one or more lines)
    NOS002 nos_tpu_torch/constants.py :: protocol constant LABEL_* ...

Fields: `<code> <path-glob> :: <message-glob>`. Globs use fnmatch syntax so
an entry can cover a family of findings (e.g. a whole directory) while the
message keeps it tight. Matching is line-number-free on purpose: unrelated
edits move lines; a baseline that churns on every edit gets rubber-stamped.

A stale entry (matching no current finding) is reported by the CLI so the
baseline shrinks as the tree heals, instead of fossilizing.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

from nos_tpu_torch.analysis.core import Finding


@dataclass(frozen=True)
class BaselineEntry:
    code: str
    path_glob: str
    message_glob: str
    rationale: Tuple[str, ...] = field(default_factory=tuple)

    def matches(self, finding: Finding) -> bool:
        return (
            finding.code == self.code
            and fnmatch.fnmatchcase(finding.path, self.path_glob)
            and fnmatch.fnmatchcase(finding.message, self.message_glob)
        )

    def render(self) -> str:
        return f"{self.code} {self.path_glob} :: {self.message_glob}"


def parse_baseline(text: str) -> List[BaselineEntry]:
    entries: List[BaselineEntry] = []
    rationale: List[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            rationale = []
            continue
        if line.startswith("#"):
            rationale.append(line.lstrip("#").strip())
            continue
        head, sep, message = line.partition("::")
        parts = head.split(None, 1)
        if not sep or len(parts) != 2:
            raise ValueError(f"malformed baseline entry: {raw!r}")
        code, path_glob = parts
        entries.append(
            BaselineEntry(code, path_glob.strip(), message.strip(), tuple(rationale))
        )
        rationale = []
    return entries


def load_baseline(path: str) -> List[BaselineEntry]:
    with open(path, encoding="utf-8") as f:
        return parse_baseline(f.read())


def apply_baseline(
    findings: Iterable[Finding], entries: Sequence[BaselineEntry]
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """-> (kept, suppressed, stale_entries)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(entries)
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if e.matches(f):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return kept, suppressed, stale


def write_baseline(findings: Iterable[Finding], path: str) -> None:
    """Emit a fresh baseline from current findings. Rationales are stubbed:
    the author must replace TODO with the actual reason before committing —
    an unexplained suppression is just a hidden bug."""
    lines = [
        "# nos-tpu lint suppression baseline.",
        "# Every entry needs a rationale comment directly above it.",
        "",
    ]
    for f in sorted(set(findings)):
        lines.append("# TODO: rationale")
        lines.append(f"{f.code} {f.path} :: {f.message}")
        lines.append("")
    with open(path, "w", encoding="utf-8") as out:
        out.write("\n".join(lines))
