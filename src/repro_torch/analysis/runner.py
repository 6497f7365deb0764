"""File discovery + pass orchestration for mergelint."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import accounting, durability, exceptions, guarded
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

# pass-id -> per-file entry point
ALL_PASSES = {
    guarded.PASS_ID: guarded.run,
    accounting.PASS_ID: accounting.run,
    exceptions.PASS_ID: exceptions.run,
    durability.PASS_ID: durability.run,
}
# repo-wide passes run once over the whole file set
REPO_PASSES = {durability.PASS_ID + "-drift": durability.run_repo}


def discover(root: str) -> List[str]:
    """All lintable .py files: ``src/repro_torch`` relative to ``root``."""
    src = os.path.join(root, "src", "repro_torch")
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def parse_files(paths: Sequence[str], root: str) -> List[SourceFile]:
    files: List[SourceFile] = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        files.append(SourceFile.parse(rel, text))
    return files


def run_paths(
    paths: Sequence[str],
    root: str = ".",
    passes: Optional[Sequence[str]] = None,
    with_repo_passes: bool = True,
) -> List[Finding]:
    files = parse_files(paths, root)
    selected = passes or list(ALL_PASSES)
    findings: List[Finding] = []
    for sf in files:
        for pid in selected:
            findings.extend(ALL_PASSES[pid](sf))
    if with_repo_passes and (passes is None or durability.PASS_ID in passes):
        for run_repo in REPO_PASSES.values():
            findings.extend(run_repo(files))
    return findings


def run_repo(
    root: str,
    passes: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
) -> List[Finding]:
    """Lint the whole repo and apply the checked-in baseline."""
    findings = run_paths(discover(root), root=root, passes=passes)
    if baseline_path is None:
        baseline_path = os.path.join(root, baseline_mod.BASELINE_NAME)
    findings.extend(baseline_mod.lint_baseline(baseline_path))
    baseline_mod.apply(findings, baseline_mod.load(baseline_path))
    return findings


def find_repo_root(start: str = ".") -> str:
    """Walk up from ``start`` to the directory containing src/repro_torch."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, "src", "repro_torch")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            raise SystemExit(
                "mergelint: cannot find repo root (src/repro_torch) from %s"
                % os.path.abspath(start)
            )
        cur = parent
