"""ut-lint core: module context, rule registry, suppressions, findings.

The analyzer is pure-AST (no jax import, no code execution) so it runs
anywhere — CI boxes without an accelerator, pre-commit hooks, editors.
Repo-specific knowledge lives in two places: `jitgraph.py` decides which
functions are device-traced (the scope where host-sync / control-flow /
side-effect hazards actually cost throughput), and `rules.py` holds the
rule pack.  This module is the machinery both stand on.

Suppression syntax (per line)::

    x = float(q)          # ut-lint: disable=R001
    # ut-lint: disable-next=R001,R004
    x = float(q)

`disable=all` silences every rule on that line.  Suppressed findings are
still collected (reporters can show them; the CLI exit code ignores
them), so an audit of intentional hazards is one `--show-suppressed`
away.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

SUPPRESS_RE = re.compile(
    r"#\s*ut-lint:\s*(disable|disable-next)\s*=\s*"
    r"(all|[A-Z]\d+(?:\s*,\s*[A-Z]\d+)*)")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    snippet: str = ""
    suppressed: bool = False
    occurrence: int = 0  # ordinal among same-(rule, snippet) findings

    def fingerprint(self) -> str:
        """Stable identity for baselines: path + rule + the stripped
        source line + occurrence ordinal, NOT the line number —
        findings survive unrelated edits above them.  For textually
        IDENTICAL findings the semantics are count-based: with N
        baselined occurrences, the first N (in file order) match the
        baseline and any extras are reported.  A new identical hazard
        therefore always surfaces as exactly one fresh finding, but
        which of the N+1 sites is flagged is positional (the last
        one), not necessarily the one most recently written."""
        key = (f"{self.path}::{self.rule}::{self.snippet.strip()}"
               f"::{self.occurrence}")
        return hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed,
                "fingerprint": self.fingerprint()}


class Rule:
    """One lint rule.  Subclasses set `id`/`name`/`short`/`why` and
    implement check(mod) yielding (node, message) pairs."""

    id: str = ""
    name: str = ""
    short: str = ""      # one-line description (SARIF shortDescription)
    why: str = ""        # TPU-throughput rationale (docs/LINT.md)

    def check(self, mod: "ModuleCtx") -> Iterator:
        raise NotImplementedError


class PackageRule(Rule):
    """A rule whose verdict needs EVERY linted module at once (the
    lock-order inversion check: the two halves of an inverted pair
    usually live in different files).  `lint_paths` calls
    `check_package` exactly once over the whole module set; linting a
    single file degrades gracefully to that one module — full coverage
    comes from the repo-wide gate run (scripts/lint.sh)."""

    def check(self, mod: "ModuleCtx") -> Iterator:
        for m, node, message in self.check_package([mod]):
            if m is mod:
                yield node, message

    def check_package(self, mods: Sequence["ModuleCtx"]) -> Iterator:
        """Yield (mod, node, message) triples across all modules."""
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the global registry."""
    inst = cls()
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    from . import rules as _rules  # noqa: F401  (registration side effect)
    from . import conc_rules as _conc  # noqa: F401  (R101–R106)
    return dict(_REGISTRY)


# ---------------------------------------------------------------------
def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, 1):
        for m in SUPPRESS_RE.finditer(text):
            kind, ids = m.group(1), m.group(2)
            ruleset = ({"all"} if ids == "all"
                       else {r.strip() for r in ids.split(",")})
            target = i if kind == "disable" else i + 1
            out.setdefault(target, set()).update(ruleset)
    return out


class ModuleCtx:
    """Parsed module + the shared analyses rules draw on."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions = _parse_suppressions(self.lines)
        self.aliases = self._collect_import_aliases(self.tree)
        self.parents = self._build_parents(self.tree)
        from .jitgraph import JitGraph
        self.jit = JitGraph(self)
        self._locks = None

    @property
    def locks(self):
        """Lazy LockGraph (the concurrency pass; `lockgraph.py`) —
        built on first use so jit-only tooling pays nothing for it."""
        if self._locks is None:
            from .lockgraph import LockGraph
            self._locks = LockGraph(self)
        return self._locks

    # -- imports ------------------------------------------------------
    @staticmethod
    def _collect_import_aliases(tree: ast.AST) -> Dict[str, str]:
        """Local name -> canonical dotted path (`jnp` -> `jax.numpy`,
        `random` -> `jax.random` after `from jax import random`, ...)."""
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    @staticmethod
    def _build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        return parents

    # -- shared helpers ----------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Attribute/Name chain -> canonical dotted string, resolving
        import aliases at the root; None for non-chain expressions."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def plain_dotted(self, node: ast.AST) -> Optional[str]:
        """Like dotted() but WITHOUT alias resolution — for value
        expressions like `self.key` / `state.key` where the root is a
        variable, not an import."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        ids = self.suppressions.get(line)
        return bool(ids) and ("all" in ids or rule_id in ids)

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)


FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def shallow_walk(roots: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Walk nodes without descending into nested function-like nodes
    (each reachable function is analyzed once, under its own scope)."""
    todo = list(roots)
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FUNCTION_NODES):
                continue
            todo.append(child)


def function_body(fn) -> List[ast.AST]:
    if isinstance(fn, ast.Lambda):
        return [fn.body]
    return list(fn.body)


# ---------------------------------------------------------------------
def _mk_finding(mod: ModuleCtx, rid: str, node, message: str) -> Finding:
    line = getattr(node, "lineno", 1)
    col = getattr(node, "col_offset", 0)
    return Finding(rid, mod.path, line, col, message,
                   snippet=mod.snippet(line),
                   suppressed=mod.is_suppressed(rid, line))


def _finalize(findings: List[Finding]) -> List[Finding]:
    """Per-module finishing: position sort, one finding per
    (rule, line, col) — loop double-execution in the key-reuse
    interpreter can emit duplicates — and occurrence ordinals for the
    count-based fingerprint semantics."""
    seen: Set[tuple] = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        k = (f.rule, f.line, f.col)
        if k not in seen:
            seen.add(k)
            out.append(f)
    counts: Dict[tuple, int] = {}
    for f in out:
        fk = (f.rule, f.snippet.strip())
        f.occurrence = counts.get(fk, 0)
        counts[fk] = f.occurrence + 1
    return out


def lint_source(path: str, source: str,
                select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one module's source; returns findings INCLUDING suppressed
    ones (marked), sorted by position.  Syntax errors yield a single
    parse-error finding under rule id 'E000'.  Package rules see just
    this module (their single-module fallback)."""
    try:
        mod = ModuleCtx(path, source)
    except SyntaxError as e:
        return [Finding("E000", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}", snippet="")]
    findings: List[Finding] = []
    for rid, rule in sorted(all_rules().items()):
        if select is not None and rid not in select:
            continue
        for node, message in rule.check(mod):
            findings.append(_mk_finding(mod, rid, node, message))
    return _finalize(findings)


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Sequence[str],
               select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint a path set.  Per-module rules run module by module;
    PackageRules run ONCE over every successfully parsed module (the
    lock-order inversion pair may span files).  Output order and the
    per-module fingerprint semantics match the old per-file path."""
    by_path: Dict[str, List[Finding]] = {}
    order: List[str] = []
    mods: List[ModuleCtx] = []
    for fp in iter_py_files(paths):
        rel = os.path.relpath(fp)
        if rel in by_path:
            continue
        order.append(rel)
        by_path[rel] = []
        try:
            with open(fp, encoding="utf-8") as f:
                src = f.read()
        except (OSError, UnicodeDecodeError) as e:
            by_path[rel].append(Finding("E000", rel, 1, 0,
                                        f"unreadable: {e}"))
            continue
        try:
            mods.append(ModuleCtx(rel, src))
        except SyntaxError as e:
            by_path[rel].append(Finding(
                "E000", rel, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}", snippet=""))
    rules = sorted(all_rules().items())
    for mod in mods:
        for rid, rule in rules:
            if select is not None and rid not in select:
                continue
            if isinstance(rule, PackageRule):
                continue
            for node, message in rule.check(mod):
                by_path[mod.path].append(
                    _mk_finding(mod, rid, node, message))
    for rid, rule in rules:
        if select is not None and rid not in select:
            continue
        if not isinstance(rule, PackageRule):
            continue
        for mod, node, message in rule.check_package(mods):
            by_path[mod.path].append(_mk_finding(mod, rid, node, message))
    return [f for rel in order for f in _finalize(by_path[rel])]
