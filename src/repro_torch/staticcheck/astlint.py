"""Layer 1: run the rule registry over Python source trees (the reference's
``staticcheck/astlint.py``), and read the declared syncs of Layer 3 off the
source.

Pure stdlib (``ast`` + ``re``): importing this module imports neither torch
nor numpy, so the lint runs anywhere in a fraction of a second.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Union

from .report import Finding, SEVERITY_WARNING
from .rules import HOT_PATH_PRAGMA, HOT_PATHS, RULES, LintContext

__all__ = ["iter_python_files", "lint_file", "lint_paths", "SKIP_DIRS",
           "SyncMarker", "sync_markers", "check_sync_markers"]

SKIP_DIRS = {".git", ".pytest_cache", "__pycache__", "node_modules",
             "reports", "fixtures"}

_SUPPRESS_RE = re.compile(r"#\s*staticcheck:\s*disable=([A-Z0-9, ]+)")
_SYNC_RE = re.compile(r"#\s*staticcheck:.*\bsync=([A-Za-z0-9_.]+)")


def iter_python_files(root: str, subdirs: Sequence[str]) -> List[str]:
    """All ``.py`` files under ``root/<subdir>`` for each subdir, skipping
    ``SKIP_DIRS`` (which includes the committed must-fail ``fixtures/``)."""
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


def _suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).split(",")
                      if tok.strip()}
    return out


_PRAGMA_RE = re.compile(r"^\s*" + re.escape(HOT_PATH_PRAGMA) + r"\s*$",
                        re.MULTILINE)


def _hot_functions(relpath: str, source: str) -> Union[str, Set[str], None]:
    for suffix, names in HOT_PATHS.items():
        if relpath.endswith(suffix):
            return names
    if _PRAGMA_RE.search(source):
        return "*"
    return None


def _map_functions(tree: ast.AST) -> Dict[int, str]:
    """id(node) -> name of the innermost enclosing function def."""
    func_of: Dict[int, str] = {}

    def visit(node: ast.AST, current: Optional[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            current = node.name
        for child in ast.iter_child_nodes(node):
            if current is not None:
                func_of[id(child)] = current
            visit(child, current)

    visit(tree, None)
    return func_of


def _is_test_path(relpath: str) -> bool:
    parts = relpath.split("/")
    base = parts[-1]
    return ("tests" in parts[:-1] or base.startswith("test_")
            or base == "conftest.py")


def _relpath(path: str, root: Optional[str]) -> str:
    rel = os.path.relpath(path, root) if root else path
    return rel.replace(os.sep, "/")


def lint_file(path: str, root: Optional[str] = None,
              severity: str = "error",
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every registered rule over one file.

    ``severity`` overrides the emitted findings' severity (``"warning"``
    for warn-only zones); ``rules`` restricts to a subset of rule ids.
    """
    relpath = _relpath(path, root)
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as exc:
        return [Finding(rule="RS000", path=relpath, line=exc.lineno or 0,
                        message=f"file does not parse: {exc.msg}")]
    lines = source.splitlines()
    ctx = LintContext(
        path=relpath, tree=tree, lines=lines,
        suppressed=_suppressions(lines),
        is_test=_is_test_path(relpath),
        hot_functions=_hot_functions(relpath, source),
        func_of=_map_functions(tree))
    findings: List[Finding] = []
    for rule in RULES:
        if rules is not None and rule.id not in rules:
            continue
        findings.extend(rule.check(ctx))
    if severity == SEVERITY_WARNING:
        for f in findings:
            f.severity = SEVERITY_WARNING
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: Iterable[str], root: Optional[str] = None,
               severity: str = "error",
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        out.extend(lint_file(p, root=root, severity=severity, rules=rules))
    return out


# ---------------------------------------------------------------------------
# declared syncs: the source side of Layer 3's budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SyncMarker:
    """One ``# staticcheck: ... sync=<site>`` comment: the site it names,
    where it is (``line``: the statement it marks, the comment's own line
    when it trails code, else the next line) and whether it also
    suppresses RS005 there."""

    site: str
    path: str
    line: int
    suppresses_rs005: bool


def sync_markers(paths: Iterable[str], root: Optional[str] = None) -> List[SyncMarker]:
    """Every sync marker in ``paths``, in file and line order."""
    out: List[SyncMarker] = []
    for p in paths:
        relpath = _relpath(p, root)
        with open(p, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for i, text in enumerate(lines, start=1):
            m = _SYNC_RE.search(text)
            if not m:
                continue
            sup = _SUPPRESS_RE.search(text)
            own_line = text.lstrip().startswith("#")
            out.append(SyncMarker(
                site=m.group(1), path=relpath, line=i + 1 if own_line else i,
                suppresses_rs005=bool(sup) and "RS005" in sup.group(1)))
    return out


def check_sync_markers(paths: Iterable[str], sites: Iterable[str],
                       root: Optional[str] = None) -> List[Finding]:
    """RS005 findings for a declaration that does not match Layer 3's
    budget: an RS005 suppression that names no sync site, a marker naming a
    site the budget does not have, a site marked twice, and a budget site
    with no marker."""
    paths = list(paths)
    sites = set(sites)
    findings: List[Finding] = []
    seen: Dict[str, SyncMarker] = {}
    for m in sync_markers(paths, root):
        if m.site not in sites:
            findings.append(Finding(
                rule="RS005", path=m.path, line=m.line,
                message=f"sync marker names {m.site!r}, which is not a site "
                        f"of shapes.SYNC_BUDGET"))
        elif m.site in seen:
            findings.append(Finding(
                rule="RS005", path=m.path, line=m.line,
                message=f"sync site {m.site!r} is marked twice (also "
                        f"{seen[m.site].path}:{seen[m.site].line})"))
        seen.setdefault(m.site, m)
    for p in paths:
        relpath = _relpath(p, root)
        with open(p, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for i, text in enumerate(lines, start=1):
            sup = _SUPPRESS_RE.search(text)
            if sup and "RS005" in sup.group(1) and not _SYNC_RE.search(text):
                findings.append(Finding(
                    rule="RS005", path=relpath, line=i,
                    message="an RS005 suppression must name the declared "
                            "sync it is (sync=<site of shapes.SYNC_BUDGET>)"))
    for site in sorted(sites - set(seen)):
        findings.append(Finding(
            rule="RS005", path=f"<budget:{site}>", line=0,
            message=f"shapes.SYNC_BUDGET declares {site!r} but no source line "
                    f"carries its sync marker"))
    return findings
