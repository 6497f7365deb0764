"""Parsed source model shared by all mergelint passes.

Annotation / waiver grammar (all live in ordinary ``#`` comments):

``# guarded-by: <lock>``
    On a ``self.<field> = ...`` line: every other access of that field
    in the class must occur lexically under ``with self.<lock>``.

``# unguarded-ok: <reason>``
    Waives a guarded-by finding on that line (deliberate lock-free
    access; the reason must say why it is safe).

``# unaccounted-ok: <reason>``
    Waives an IOStats accounting finding on a read call site whose
    bytes are recorded by a caller at a different layer.

``# broad-except-ok: <reason>``
    Waives an exception-discipline finding on an ``except`` line; the
    reason must explain why ``MergeCancelled`` / ``SimulatedCrash``
    cannot be swallowed there.

``# fsync-ok: <reason>``
    Waives a fsync-before-rename finding (e.g. a cache file whose torn
    write self-heals).

``# chaos-ok: <reason>``
    Waives the "durability edge has no registered chaos point" check
    (e.g. the crash points bracket the call one layer up).

A waiver without a reason is itself reported — the reason is the
documentation the next reader gets.
"""
from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WAIVER_KEYS = (
    "unguarded-ok",
    "unaccounted-ok",
    "broad-except-ok",
    "fsync-ok",
    "chaos-ok",
)


@dataclass
class SourceFile:
    path: str                    # repo-relative posix path
    text: str
    tree: ast.Module
    comments: Dict[int, str] = field(default_factory=dict)  # line -> text
    # line -> {waiver_key: reason}; "" reason means malformed waiver
    waivers: Dict[int, Dict[str, str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        tree = ast.parse(text, filename=path)
        comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        waivers: Dict[int, Dict[str, str]] = {}
        for line, comment in comments.items():
            for key, reason in _parse_directives(comment):
                waivers.setdefault(line, {})[key] = reason
        return cls(path=path, text=text, tree=tree,
                   comments=comments, waivers=waivers)

    # ------------------------------------------------------------------
    def waiver(self, line: int, key: str) -> Optional[str]:
        """Reason string if ``line`` carries ``# <key>: reason``.

        Returns ``""`` for a malformed (reason-less) waiver and ``None``
        when no waiver of that kind is present.
        """
        entry = self.waivers.get(line)
        if entry is None:
            return None
        return entry.get(key)

    def waiver_near(self, line: int, key: str) -> Optional[str]:
        """Like :meth:`waiver`, but also accepts the waiver on a block of
        comment-only lines immediately above ``line`` (the usual style
        when the code line is already long)."""
        reason = self.waiver(line, key)
        if reason is not None:
            return reason
        lines = self.text.splitlines()
        cur = line - 1
        while cur >= 1 and cur <= len(lines) \
                and lines[cur - 1].lstrip().startswith("#"):
            reason = self.waiver(cur, key)
            if reason is not None:
                return reason
            cur -= 1
        return None

    def guarded_by(self, line: int) -> Optional[str]:
        """Lock name if ``line`` carries ``# guarded-by: <lock>``."""
        comment = self.comments.get(line)
        if not comment:
            return None
        for key, value in _parse_directives(comment, keys=("guarded-by",)):
            return value or None
        return None


def _parse_directives(
    comment: str, keys: Tuple[str, ...] = WAIVER_KEYS
) -> List[Tuple[str, str]]:
    """Extract ``key: value`` directives from one comment string."""
    out: List[Tuple[str, str]] = []
    body = comment.lstrip("#").strip()
    for key in keys:
        marker = key + ":"
        idx = body.find(marker)
        if idx < 0:
            # bare "# unguarded-ok" with no colon: malformed, empty reason
            if body == key or body.startswith(key + " "):
                out.append((key, ""))
            continue
        # only accept the directive at a comment-word boundary
        if idx > 0 and body[idx - 1] not in " ;,(":
            continue
        reason = body[idx + len(marker):].strip()
        # a follow-on directive ends the reason
        for other in keys:
            cut = reason.find(other + ":")
            if cut > 0:
                reason = reason[:cut].rstrip(" ;,")
        out.append((key, reason))
    return out
