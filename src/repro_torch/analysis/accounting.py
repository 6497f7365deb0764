"""Pass 2 — IOStats accounting completeness.

Budget enforcement (realized C_expert <= planned <= B) is only sound if
every byte read reaches an :class:`repro_torch.store.iostats.IOStats`
category.  This pass watches the three read primitives named in the
repo's accounting contract — ``read_range``, ``pread`` (incl. the
``os.pread``-based ``_pread`` helpers) and ``get_range`` — and requires
each call site to be *accounted*: either a category flows through the
call (a ``category=...`` argument, a variable named ``category``/
``cat``, or a literal category string), or the enclosing function
itself records the bytes via an ``IOStats.record_*`` / ``_record``
helper call.  Call sites whose bytes are recorded by a caller one layer
up carry ``# unaccounted-ok: <reason>``.

It also validates every literal category string (in watched calls and
in ``record_read``/``record_write``/``record_skip``) against
``iostats.CATEGORIES`` — a typo'd category would silently escape every
``C_*`` aggregate.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile
from repro_torch.store.iostats import CATEGORIES

PASS_ID = "io-accounting"
WAIVER = "unaccounted-ok"

READ_PRIMITIVES = ("read_range", "get_range", "pread", "_pread")
RECORDERS = ("record_read", "record_write", "record_skip")
_RECORD_CALL = re.compile(r"^_?record(_\w+)?$")


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    # enclosing-function index: maps every node to its nearest def
    parents = {}
    for node in ast.walk(sf.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in READ_PRIMITIVES:
            findings.extend(_check_read_site(sf, node, name, parents))
        if name in RECORDERS:
            findings.extend(_check_category_literal(sf, node, name))
    return findings


def _check_read_site(sf, call, name, parents) -> List[Finding]:
    findings: List[Finding] = []
    func = _enclosing_function(call, parents)
    fname = func.name if func else "<module>"
    # literal categories on the call itself are validated either way
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value in CATEGORIES:
                continue
            if _looks_like_category(call, arg):
                findings.append(Finding(
                    pass_id=PASS_ID, path=sf.path, line=arg.lineno,
                    symbol=fname,
                    message="unknown IOStats category %r passed to %s()"
                            % (arg.value, name),
                ))
    if _carries_category(call) or _function_records(func):
        return findings
    line = call.lineno
    reason = sf.waiver_near(line, WAIVER)
    if reason is None and func is not None:
        reason = sf.waiver_near(func.lineno, WAIVER)
    findings.append(Finding(
        pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
        message="%s() call site not accounted: no category flows in and "
                "%s() never records to IOStats" % (name, fname),
        waived=bool(reason),
        waive_reason=reason or None,
    ))
    if reason == "":
        findings.append(Finding(
            pass_id=PASS_ID, path=sf.path, line=line, symbol=fname,
            message="unaccounted-ok waiver has no reason",
        ))
    return findings


def _check_category_literal(sf, call, name) -> List[Finding]:
    args = list(call.args)
    cat = None
    for kw in call.keywords:
        if kw.arg == "category":
            cat = kw.value
    if cat is None and args:
        cat = args[0]
    if isinstance(cat, ast.Constant) and isinstance(cat.value, str):
        if cat.value not in CATEGORIES:
            func_name = _call_name(call) or name
            return [Finding(
                pass_id=PASS_ID, path=sf.path, line=call.lineno,
                symbol=func_name,
                message="unknown IOStats category %r passed to %s()"
                        % (cat.value, name),
            )]
    return []


# ------------------------------------------------------------- helpers
def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _enclosing_function(node, parents):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def _carries_category(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "category":
            return True
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Name) and (
            "category" in arg.id or arg.id == "cat"
        ):
            return True
        if isinstance(arg, ast.Attribute) and "category" in arg.attr:
            return True
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value in CATEGORIES:
            return True
    return False


def _function_records(func) -> bool:
    if func is None:
        return False
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name and name not in READ_PRIMITIVES \
                    and _RECORD_CALL.match(name):
                return True
    return False


def _looks_like_category(call: ast.Call, arg) -> bool:
    """Heuristic: a string arg to a read primitive is a category when it
    is the ``category`` keyword or matches a category-ish shape."""
    for kw in call.keywords:
        if kw.arg == "category" and kw.value is arg:
            return True
    return False
