"""Which code in a module runs holding which lock?

The concurrency sibling of `jitgraph.py`: where JitGraph answers "does
this function run under a JAX trace?", LockGraph answers "does this
statement run under a threading lock, and which one?".  It feeds the
R101–R106 rule pack (`conc_rules.py`).

What it resolves (pure AST, per module):

* **lock-typed attributes** — ``self.X = threading.Lock()`` /
  ``RLock()`` / ``Condition()`` in any method of a class, plus
  module-level ``NAME = threading.Lock()``.  Thread/Event/Queue-typed
  attributes are collected too (rules use the kinds to type `.join()`
  receivers and to exclude inherently thread-safe fields).
* **held regions** — ``with self._lock:`` blocks.  Every node walked
  inside one is annotated with the tuple of held lock ids
  (`held_at`); nested acquisitions record directed ``outer -> inner``
  edges (`nest_edges`) for the package-wide inversion check.
* **thread entry points** — functions referenced by
  ``threading.Thread(target=...)`` plus their intra-class call
  closure: the code that runs concurrently with the main thread.

Lock identity is *syntactic*: ``ClassName.attr_path`` for instance
attributes (``Session._ckpt_lock``, ``Session.group.lock``) and
``modstem.NAME`` for module-level locks (``metrics._LOCK`` and
``journal._LOCK`` stay distinct).  Two classes with the same name in
different modules therefore conflate — a documented over-approximation
the inversion rule inherits (its message names both sites, so a false
pair is cheap to triage).  Locks held through *local variables pulled
from containers* (``klock = self._glocks.setdefault(...)`` in
serve/server.py) are unresolvable per-file and deliberately skipped:
a missed edge is cheaper than a stream of wrong-identity ones.

A ``with self.foo.lock:`` whose attribute was never assigned a
``threading.*`` factory in this module (a *foreign* lock, e.g. the
session's ``group.lock``) still counts as a held region when its final
segment looks lock-ish (``lock``/``mutex``/``cv``/``cond``) — a with
statement on such a name is a lock acquisition in every idiom this
repo uses, and missing those regions would blind R101/R102 to the one
cross-object nesting the serving plane actually has.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import FUNCTION_NODES, ModuleCtx, function_body, shallow_walk

# canonical dotted factory -> kind
LOCK_FACTORIES: Dict[str, str] = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Event": "event",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "threading.Barrier": "barrier",
    "threading.Thread": "thread",
    "threading.Timer": "thread",
    "multiprocessing.Lock": "lock",
    "multiprocessing.RLock": "rlock",
    "queue.Queue": "queue",
    "queue.SimpleQueue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
    "collections.deque": "queue",
    "concurrent.futures.ThreadPoolExecutor": "executor",
    "concurrent.futures.ProcessPoolExecutor": "executor",
}
# kinds whose `with x:` acquires a mutual-exclusion region
HELD_KINDS = {"lock", "rlock", "condition"}
# kinds that are synchronization objects, not shared data (R103 skips)
SYNC_KINDS = {"lock", "rlock", "condition", "event", "semaphore",
              "barrier", "thread", "queue", "executor"}
# a with-context attribute that smells like a foreign lock
_LOCKISH_RE = re.compile(r"(?:^|_)(?:\w*lock|mutex|cv|cond)$", re.I)


def _mod_stem(path: str) -> str:
    return os.path.basename(path).rsplit(".py", 1)[0]


class LockGraph:
    """Per-module lock/thread analysis; built lazily by ModuleCtx."""

    def __init__(self, mod: ModuleCtx):
        self.mod = mod
        self.jit = mod.jit          # reuse its scopes/classes/methods
        self._stem = _mod_stem(mod.path)
        # id(ClassDef) -> {attr path after self. : kind}
        self.class_kinds: Dict[int, Dict[str, str]] = {}
        # module-level NAME -> kind
        self.module_kinds: Dict[str, str] = {}
        # fn node -> {local name: kind}
        self.local_kinds: Dict[ast.AST, Dict[str, str]] = {}
        # node -> tuple of held lock ids (outermost first); absent = bare
        self.held_at: Dict[ast.AST, Tuple[str, ...]] = {}
        # (lock_id, with_node, fn) per resolved acquisition
        self.regions: List[Tuple[str, ast.AST, ast.AST]] = []
        # (outer_id, inner_id, with_node, fn) per nested acquisition
        self.nest_edges: List[Tuple[str, str, ast.AST, ast.AST]] = []
        # every threading.Thread(...) creation: (call, enclosing fn|None)
        self.thread_creations: List[Tuple[ast.Call, Optional[ast.AST]]] = []
        # function nodes referenced as Thread targets
        self.thread_entries: Set[ast.AST] = set()
        # callee fn -> [(call node, caller fn)] for intra-module calls
        self.call_sites: Dict[ast.AST, List[Tuple[ast.Call, ast.AST]]] = {}
        self._collect_kinds()
        self._collect_threads()
        for fn in self.jit.functions:
            self._walk_fn(fn)
        self._collect_call_sites()

    # -- kind collection ----------------------------------------------
    def _factory_kind(self, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        d = self.mod.dotted(value.func)
        if d is None:
            return None
        kind = LOCK_FACTORIES.get(d)
        if kind is None and "." in d:
            # `futures.ThreadPoolExecutor` etc: match by final segment
            # for the unambiguous factory names only
            last = d.rsplit(".", 1)[-1]
            if last in ("ThreadPoolExecutor", "ProcessPoolExecutor"):
                kind = "executor"
        return kind

    def _collect_kinds(self) -> None:
        mod = self.mod
        # module level
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                kind = self._factory_kind(stmt.value)
                if kind:
                    self.module_kinds[stmt.targets[0].id] = kind
        # self.* attrs (any method) and function locals
        for fn in self.jit.functions:
            cls = self.jit.class_of.get(fn)
            locals_ = self.local_kinds.setdefault(fn, {})
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets, value = [node.target], node.value
                else:
                    continue
                kind = self._factory_kind(value)
                if not kind:
                    continue
                for t in targets:
                    p = mod.plain_dotted(t)
                    if p is None:
                        continue
                    if p.startswith("self.") and cls is not None:
                        self.class_kinds.setdefault(
                            id(cls), {})[p[5:]] = kind
                    elif "." not in p:
                        locals_[p] = kind

    # -- thread entry points ------------------------------------------
    @staticmethod
    def _thread_target(call: ast.Call) -> Optional[ast.AST]:
        for kw in call.keywords:
            if kw.arg == "target":
                return kw.value
        # Thread(group, target, ...)
        if len(call.args) >= 2:
            return call.args[1]
        return None

    def _resolve_fn_ref(self, at_node: ast.AST,
                        ref: ast.AST) -> Optional[ast.AST]:
        """A function reference (Name / self.m / lambda) -> def node."""
        if isinstance(ref, ast.Lambda):
            return ref
        fn = self.mod.enclosing_function(at_node)
        if isinstance(ref, ast.Name):
            scope = self.jit.scope_of.get(fn) if fn is not None else None
            if scope is not None:
                return scope.resolve(ref.id)
            for stmt in self.mod.tree.body:       # module-level call
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and stmt.name == ref.id:
                    return stmt
            return None
        if isinstance(ref, ast.Attribute) and isinstance(
                ref.value, ast.Name) and ref.value.id in ("self", "cls"):
            cls = self.jit.class_of.get(fn) if fn is not None else None
            if cls is not None:
                return self.jit.methods.get((id(cls), ref.attr))
        return None

    def _collect_threads(self) -> None:
        for node in ast.walk(self.mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if self.mod.dotted(node.func) != "threading.Thread":
                continue
            fn = self.mod.enclosing_function(node)
            self.thread_creations.append((node, fn))
            tgt = self._thread_target(node)
            if tgt is not None:
                t = self._resolve_fn_ref(node, tgt)
                if t is not None:
                    self.thread_entries.add(t)

    def thread_reachable(self) -> Set[ast.AST]:
        """Thread entry points closed over intra-class/local calls —
        the code that runs off the creating thread."""
        seen: Set[ast.AST] = set()
        todo = list(self.thread_entries)
        while todo:
            fn = todo.pop()
            if fn in seen:
                continue
            seen.add(fn)
            todo.extend(self.jit._callees(fn) - seen)
        return seen

    # -- lock resolution ----------------------------------------------
    def resolve_lock(self, fn: Optional[ast.AST],
                     expr: ast.AST) -> Optional[str]:
        """A with-context expression -> lock id, or None if it is not
        (recognizably) a lock.  Locals are skipped: their identity is
        unknowable per-file (see module docstring)."""
        p = self.mod.plain_dotted(expr)
        if p is None:
            return None
        cls = self.jit.class_of.get(fn) if fn is not None else None
        if p.startswith("self.") or p.startswith("cls."):
            path = p.split(".", 1)[1]
            kind = None
            if cls is not None:
                kind = self.class_kinds.get(id(cls), {}).get(path)
            if kind is None:
                # foreign lock heuristic (e.g. `self.group.lock`)
                if _LOCKISH_RE.search(path.rsplit(".", 1)[-1]):
                    kind = "lock"
                else:
                    return None
            if kind not in HELD_KINDS:
                return None
            cname = cls.name if cls is not None else "?"
            return f"{cname}.{path}"
        if "." in p:
            return None
        if fn is not None and p in self.local_kinds.get(fn, {}):
            return None                       # local lock: identityless
        kind = self.module_kinds.get(p)
        if kind in HELD_KINDS:
            return f"{self._stem}.{p}"
        return None

    def kind_of(self, fn: Optional[ast.AST],
                expr: ast.AST) -> Optional[str]:
        """The collected kind of an attribute/name expression (for
        typing `.join()` / `.wait()` receivers), or None."""
        p = self.mod.plain_dotted(expr)
        if p is None:
            return None
        cls = self.jit.class_of.get(fn) if fn is not None else None
        if p.startswith("self.") or p.startswith("cls."):
            if cls is None:
                return None
            return self.class_kinds.get(id(cls), {}).get(p.split(".", 1)[1])
        if "." not in p:
            if fn is not None:
                k = self.local_kinds.get(fn, {}).get(p)
                if k:
                    return k
            return self.module_kinds.get(p)
        return None

    # -- held-region walk ---------------------------------------------
    def _walk_fn(self, fn: ast.AST) -> None:
        held: List[str] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, FUNCTION_NODES) and node is not fn:
                return          # nested defs run later, not under held
            if isinstance(node, (ast.With, ast.AsyncWith)):
                entered = 0
                for item in node.items:
                    lid = self.resolve_lock(fn, item.context_expr)
                    if lid is None:
                        continue
                    self.regions.append((lid, node, fn))
                    for outer in held:
                        if outer != lid:
                            self.nest_edges.append((outer, lid, node, fn))
                    held.append(lid)
                    entered += 1
                if held:
                    self.held_at[node] = tuple(held)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                if entered:
                    del held[-entered:]
                return
            if held:
                self.held_at[node] = tuple(held)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in function_body(fn):
            visit(stmt)

    # -- intra-module call sites --------------------------------------
    def _collect_call_sites(self) -> None:
        for caller in self.jit.functions:
            scope = self.jit.scope_of.get(caller)
            cls = self.jit.class_of.get(caller)
            for node in shallow_walk(function_body(caller)):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                target = None
                if isinstance(f, ast.Name) and scope is not None:
                    target = scope.resolve(f.id)
                elif isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name) \
                        and f.value.id in ("self", "cls") \
                        and cls is not None:
                    target = self.jit.methods.get((id(cls), f.attr))
                if target is not None:
                    self.call_sites.setdefault(target, []).append(
                        (node, caller))
