"""Pass 3 — exception discipline.

Two invariants from the crash-safety design (docs/RECOVERY.md):

* ``MergeCancelled`` (a ``RuntimeError``) must propagate to the layer
  that settles the job handle — so an ``except Exception`` on a path it
  crosses must either re-raise or be waived with a reason explaining
  where cancellation is handled.
* ``SimulatedCrash`` derives from ``BaseException`` precisely so that
  abort paths (``except Exception: txn.abort()``) cannot see it.  A
  bare ``except:`` or ``except BaseException:`` that does not re-raise
  would swallow a simulated crash and turn a resumable death into a
  silent success — flagged unless it re-raises or is waived.

Waive with ``# broad-except-ok: <reason>`` on the ``except`` line.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

PASS_ID = "except-discipline"
WAIVER = "broad-except-ok"

BROAD = ("Exception",)
CRASH_VISIBLE = ("BaseException",)   # can see SimulatedCrash


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    parents = {}
    for node in ast.walk(sf.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ExceptHandler):
            findings.extend(_check_handler(sf, node, parents))
    return findings


def _check_handler(sf, handler: ast.ExceptHandler, parents) -> List[Finding]:
    kinds = _caught_names(handler.type)
    if kinds is None:
        label = "bare except:"
        severity = "swallows SimulatedCrash"
    elif any(k in CRASH_VISIBLE for k in kinds):
        label = "except BaseException"
        severity = "swallows SimulatedCrash"
    elif any(k in BROAD for k in kinds):
        label = "except Exception"
        severity = "swallows MergeCancelled"
    else:
        return []
    if _reraises(handler):
        return []
    func = _enclosing_function(handler, parents)
    fname = func.name if func else "<module>"
    reason = sf.waiver_near(handler.lineno, WAIVER)
    findings = [Finding(
        pass_id=PASS_ID, path=sf.path, line=handler.lineno, symbol=fname,
        message="%s without re-raise %s" % (label, severity),
        waived=bool(reason),
        waive_reason=reason or None,
    )]
    if reason == "":
        findings.append(Finding(
            pass_id=PASS_ID, path=sf.path, line=handler.lineno,
            symbol=fname, message="broad-except-ok waiver has no reason",
        ))
    return findings


def _caught_names(node) -> Optional[List[str]]:
    """Exception class names caught; ``None`` for a bare ``except:``."""
    if node is None:
        return None
    names: List[str] = []
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, ast.Tuple):
            stack.extend(cur.elts)
        elif isinstance(cur, ast.Name):
            names.append(cur.id)
        elif isinstance(cur, ast.Attribute):
            names.append(cur.attr)
    return names


def _reraises(handler: ast.ExceptHandler) -> bool:
    """True if the handler body contains a ``raise`` on every relevant
    path — approximated as: any ``raise`` statement outside nested
    function definitions."""
    stack = list(handler.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return False


def _enclosing_function(node, parents):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None
