"""Pass 1 — guarded-by discipline.

A field annotated ``# guarded-by: <lock>`` on its assignment line (by
convention the initial assignment in ``__init__``) may only be read or
written lexically under ``with self.<lock>``.  ``__init__`` itself is
exempt: construction happens-before publication of ``self`` to other
threads.  Closures and nested ``def``s do NOT inherit the enclosing
``with`` — they may run on another thread, so an access inside one
needs its own lock or a waiver.

Waive with ``# unguarded-ok: <reason>`` on the access line, or on the
``def`` line to waive a whole helper whose contract is "caller holds
the lock".
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

PASS_ID = "guarded-by"
WAIVER = "unguarded-ok"


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_check_class(sf, node))
    return findings


# ---------------------------------------------------------------- class
def _check_class(sf: SourceFile, cls: ast.ClassDef) -> List[Finding]:
    fields = _annotated_fields(sf, cls)
    findings: List[Finding] = []
    for name, (lock, line, dup) in fields.items():
        if dup:
            findings.append(Finding(
                pass_id=PASS_ID, path=sf.path, line=line,
                symbol="%s.%s" % (cls.name, name),
                message="field annotated guarded-by twice with different "
                        "locks (%s vs %s)" % (lock, dup),
            ))
    if not fields:
        return findings
    locks = {lock for lock, _, _ in fields.values()}
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name == "__init__":
            continue
        method_waiver = sf.waiver_near(item.lineno, WAIVER)
        _visit(sf, cls, item, item, frozenset(), fields, locks,
               method_waiver, findings)
    return findings


def _annotated_fields(
    sf: SourceFile, cls: ast.ClassDef
) -> Dict[str, Tuple[str, int, Optional[str]]]:
    """``field -> (lock, annotation line, conflicting lock or None)``."""
    fields: Dict[str, Tuple[str, int, Optional[str]]] = {}
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            lock = sf.guarded_by(node.lineno)
            if not lock:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for tgt in targets:
                if _is_self_attr(tgt):
                    name = tgt.attr
                    if name in fields and fields[name][0] != lock:
                        prev = fields[name]
                        fields[name] = (prev[0], prev[1], lock)
                    else:
                        fields.setdefault(name, (lock, node.lineno, None))
    return fields


# --------------------------------------------------------------- visit
def _visit(
    sf: SourceFile,
    cls: ast.ClassDef,
    method: ast.AST,
    node: ast.AST,
    held: frozenset,
    fields: Dict[str, Tuple[str, int, Optional[str]]],
    locks: Set[str],
    method_waiver: Optional[str],
    findings: List[Finding],
) -> None:
    for child in ast.iter_child_nodes(node):
        _dispatch(sf, cls, method, child, held, fields, locks,
                  method_waiver, findings)


def _dispatch(
    sf: SourceFile,
    cls: ast.ClassDef,
    method: ast.AST,
    child: ast.AST,
    held: frozenset,
    fields: Dict[str, Tuple[str, int, Optional[str]]],
    locks: Set[str],
    method_waiver: Optional[str],
    findings: List[Finding],
) -> None:
    if isinstance(child, ast.With):
        child_held = held | _locks_entered(child, locks)
        # the with-items themselves evaluate before the lock is held
        for w in child.items:
            _dispatch(sf, cls, method, w, held, fields, locks,
                      method_waiver, findings)
        for stmt in child.body:
            _dispatch(sf, cls, method, stmt, child_held, fields, locks,
                      method_waiver, findings)
        return
    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
        # closures may run on another thread: locks do not carry over
        nested_waiver = method_waiver
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested_waiver = (
                sf.waiver_near(child.lineno, WAIVER) or method_waiver
            )
        _visit(sf, cls, method, child, frozenset(), fields, locks,
               nested_waiver, findings)
        return
    if isinstance(child, ast.Attribute) and _is_self_attr(child):
        name = child.attr
        if name in fields:
            lock, ann_line, _ = fields[name]
            # the annotating assignment IS the construction point
            # (usually __init__ or an _init helper): exempt it
            if lock not in held and child.lineno != ann_line:
                _report(sf, cls, method, child, lock, method_waiver,
                        findings)
    _visit(sf, cls, method, child, held, fields, locks,
           method_waiver, findings)


def _report(sf, cls, method, node, lock, method_waiver, findings) -> None:
    line = node.lineno
    reason = sf.waiver_near(line, WAIVER)
    if reason is None:
        reason = method_waiver
    mname = getattr(method, "name", "<lambda>")
    kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
    findings.append(Finding(
        pass_id=PASS_ID, path=sf.path, line=line,
        symbol="%s.%s" % (cls.name, mname),
        message="%s of self.%s outside `with self.%s`" % (
            kind, node.attr, lock),
        waived=bool(reason),
        waive_reason=reason or None,
    ))
    if reason == "":
        findings.append(Finding(
            pass_id=PASS_ID, path=sf.path, line=line,
            symbol="%s.%s" % (cls.name, mname),
            message="unguarded-ok waiver has no reason",
        ))


def _locks_entered(node: ast.With, locks: Set[str]) -> frozenset:
    out = set()
    for item in node.items:
        expr = item.context_expr
        if _is_self_attr(expr) and expr.attr in locks:
            out.add(expr.attr)
    return frozenset(out)


def _is_self_attr(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )
