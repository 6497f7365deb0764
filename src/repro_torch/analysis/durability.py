"""Pass 4 — durability discipline + chaos-point registry drift.

Publish/journal durability edges follow the fsync-before-rename
pattern: the bytes (and for new files, ideally the directory) must be
fsync'd before the ``os.rename`` / ``os.replace`` that makes them
visible, otherwise a power cut can publish a torn file under the final
name.  Every function performing a rename must therefore contain an
``os.fsync`` call lexically before it (``# fsync-ok: <reason>`` waives
edges whose torn writes self-heal, e.g. revalidated cache files).

Each such durability edge must also be covered by crash-safety tests:
the function must contain a registered ``chaos_point(...)`` call, or a
``# chaos-ok: <reason>`` waiver explaining which layer carries the
crash points instead.

Repo-wide, the pass flags drift between ``chaos.CRASH_POINTS`` and the
actual ``chaos_point("...")`` call sites, in both directions: a
registered point with no live call site is dead coverage; an
unregistered name at a call site can never be armed by the chaos
harness.  The same two-way drift check covers the corruption-injection
registry — ``chaos.CORRUPTION_POINTS`` vs ``chaos_corrupt("...")``
call sites — so the integrity tests' corruption sweep and the data
path can never silently diverge.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile
from repro_torch.testing.chaos import CORRUPTION_POINTS, CRASH_POINTS

PASS_ID = "durability"
FSYNC_WAIVER = "fsync-ok"
CHAOS_WAIVER = "chaos-ok"

RENAMES = ("rename", "replace")


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    parents = {}
    for node in ast.walk(sf.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and _is_os_call(node, RENAMES):
            findings.extend(_check_rename(sf, node, parents))
    return findings


#: (call-site function name, registry tuple, registry symbol, armed-verb)
_REGISTRIES = (
    ("chaos_point", CRASH_POINTS, "CRASH_POINTS", "armed"),
    ("chaos_corrupt", CORRUPTION_POINTS, "CORRUPTION_POINTS", "injected"),
)


def run_repo(files: List[SourceFile]) -> List[Finding]:
    """Cross-file check: chaos registries vs call-site drift, both ways,
    for the crash-point *and* the corruption-point registry."""
    findings: List[Finding] = []
    sites: Dict[str, Dict[str, Tuple[str, int]]] = {
        fn: {} for fn, _pts, _sym, _verb in _REGISTRIES
    }
    registry_file = None
    for sf in files:
        if sf.path.endswith("testing/chaos.py"):
            registry_file = sf
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name not in sites or not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            sites[name].setdefault(arg.value, (sf.path, node.lineno))
    for fn, points, symbol, verb in _REGISTRIES:
        for point, (path, lineno) in sorted(sites[fn].items()):
            if point not in points:
                findings.append(Finding(
                    pass_id=PASS_ID, path=path, line=lineno, symbol=fn,
                    message="%s(%r) is not registered in chaos.%s — it "
                            "can never be %s" % (fn, point, symbol, verb),
                ))
        for point in points:
            if point not in sites[fn]:
                path = (registry_file.path if registry_file
                        else "testing/chaos.py")
                findings.append(Finding(
                    pass_id=PASS_ID, path=path, line=1, symbol=symbol,
                    message="registered point %r has no live %s() call "
                            "site" % (point, fn),
                ))
    return findings


# ------------------------------------------------------------- rename
def _check_rename(sf, call, parents) -> List[Finding]:
    findings: List[Finding] = []
    func = _enclosing_function(call, parents)
    fname = func.name if func else "<module>"
    line = call.lineno

    if not _has_call_before(func, ("fsync",), line):
        reason = _waiver(sf, line, func, FSYNC_WAIVER)
        findings.append(Finding(
            pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
            message="os.%s without a preceding os.fsync in %s() — a "
                    "crash can publish a torn file" % (
                        call.func.attr, fname),
            waived=bool(reason),
            waive_reason=reason or None,
        ))
        if reason == "":
            findings.append(Finding(
                pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
                message="fsync-ok waiver has no reason",
            ))

    if not _has_chaos_point(func):
        reason = _waiver(sf, line, func, CHAOS_WAIVER)
        findings.append(Finding(
            pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
            message="durability edge os.%s in %s() has no registered "
                    "chaos_point call site" % (call.func.attr, fname),
            waived=bool(reason),
            waive_reason=reason or None,
        ))
        if reason == "":
            findings.append(Finding(
                pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
                message="chaos-ok waiver has no reason",
            ))
    return findings


def _waiver(sf, line, func, key):
    reason = sf.waiver_near(line, key)
    if reason is None and func is not None:
        reason = sf.waiver_near(func.lineno, key)
    return reason


def _is_os_call(call: ast.Call, names: Tuple[str, ...]) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr in names
        and isinstance(f.value, ast.Name)
        and f.value.id == "os"
    )


def _has_call_before(func, names: Tuple[str, ...], line: int) -> bool:
    if func is None:
        return False
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and node.lineno <= line:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in names:
                return True
    return False


def _has_chaos_point(func) -> bool:
    if func is None:
        return False
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name == "chaos_point":
                return True
    return False


def _enclosing_function(node, parents):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None
