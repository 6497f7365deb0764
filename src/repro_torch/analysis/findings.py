"""Finding model + text/JSON reporters for mergelint."""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Finding:
    """One rule violation.

    ``fingerprint`` deliberately excludes the line number so that a
    baseline entry survives unrelated edits to the same file; it hashes
    the pass, the file, the symbol (usually ``Class.method`` or
    ``Class.field``) and the message.
    """

    pass_id: str          # e.g. "guarded-by"
    path: str             # repo-relative posix path
    line: int             # 1-based
    symbol: str           # Class.method / Class.field / module-level name
    message: str
    waived: bool = False
    waive_reason: Optional[str] = None
    extra: Dict = field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        raw = "|".join((self.pass_id, self.path, self.symbol, self.message))
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict:
        return {
            "pass": self.pass_id,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "waived": self.waived,
            "waive_reason": self.waive_reason,
        }

    def render(self) -> str:
        tag = " (waived: %s)" % self.waive_reason if self.waived else ""
        return "%s:%d: [%s] %s — %s%s" % (
            self.path, self.line, self.pass_id, self.symbol, self.message, tag,
        )


def render_text(findings: List[Finding], show_waived: bool = False) -> str:
    lines = []
    active = [f for f in findings if not f.waived]
    for f in sorted(active, key=lambda f: (f.path, f.line)):
        lines.append(f.render())
    if show_waived:
        for f in sorted((f for f in findings if f.waived),
                        key=lambda f: (f.path, f.line)):
            lines.append(f.render())
    n_waived = sum(1 for f in findings if f.waived)
    lines.append(
        "mergelint: %d finding(s), %d waived" % (len(active), n_waived)
    )
    return "\n".join(lines)


def render_json(findings: List[Finding]) -> str:
    doc = {
        "tool": "mergelint",
        "findings": [f.to_dict() for f in findings if not f.waived],
        "waived": [f.to_dict() for f in findings if f.waived],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
