"""Checked-in baseline for mergelint.

The baseline exists so that *pre-existing, reasoned* waivers are
explicit and reviewable — it is not an amnesty mechanism.  Policy: fix
real violations; waive deliberate ones inline (the inline waiver
carries its reason next to the code); baseline only findings that
cannot carry an inline comment (e.g. generated files).  Every entry
must have a non-empty ``reason``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from repro_torch.analysis.findings import Finding

BASELINE_NAME = "mergelint_torch.baseline.json"


def load(path: str) -> Dict[str, str]:
    """``fingerprint -> reason``; missing file means empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    out: Dict[str, str] = {}
    for entry in doc.get("entries", []):
        out[entry["fingerprint"]] = entry.get("reason", "")
    return out


def apply(findings: List[Finding], baseline: Dict[str, str]) -> List[Finding]:
    """Mark findings present in the baseline as waived (in place)."""
    for f in findings:
        if f.waived:
            continue
        reason = baseline.get(f.fingerprint)
        if reason:
            f.waived = True
            f.waive_reason = "baseline: " + reason
    return findings


def write(path: str, findings: List[Finding]) -> int:
    """Write all currently-active findings as baseline entries.

    Intended for bootstrapping only; entries get a placeholder reason
    that the lint itself will reject until a human replaces it.
    """
    entries = []
    for f in sorted((f for f in findings if not f.waived),
                    key=lambda f: (f.path, f.line)):
        entries.append({
            "fingerprint": f.fingerprint,
            "pass": f.pass_id,
            "path": f.path,
            "symbol": f.symbol,
            "message": f.message,
            "reason": "",
        })
    doc = {"version": 1, "entries": entries}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)


def lint_baseline(path: str) -> List[Finding]:
    """The baseline file itself is linted: entries need real reasons."""
    findings: List[Finding] = []
    if not os.path.exists(path):
        return findings
    with open(path) as f:
        doc = json.load(f)
    for i, entry in enumerate(doc.get("entries", [])):
        if not entry.get("reason"):
            findings.append(Finding(
                pass_id="baseline", path=os.path.basename(path), line=i + 1,
                symbol=entry.get("fingerprint", "?"),
                message="baseline entry for %s (%s) has no reason" % (
                    entry.get("path", "?"), entry.get("message", "?")),
            ))
    return findings
