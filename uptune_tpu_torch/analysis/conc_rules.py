"""ut-lint rule pack, concurrency pass: R101–R106.

The serving/store planes are thread-heavy (`serve/wire.py` handler
threads, `obs/ship.py` shipper loop, `store/store.py` cross-process
segments) and about to be replicated across K processes (ROADMAP items
1–2), where today's latent lock-order inversion or ack-before-durable
reordering becomes a fleet-wide outage.  These rules lint the lock
discipline statically from `lockgraph.py`'s per-module lock/thread
graph; `lock_guard.py` is the runtime cross-check (the TraceGuard/R005
pairing).

Scope notes shared by the pack:

* Lock identity is syntactic (`ClassName.attr`) — see lockgraph.py for
  the documented over/under-approximations.
* Buffered-file ``write``/``flush``/``readline`` and ``os.write`` are
  NOT "blocking" for R102: the repo's append discipline (one complete
  line per O_APPEND write) and its protocol framing (`serve/client.py`
  serializes request/response pairs under its lock BY DESIGN) live on
  exactly those calls.  The rule targets the calls that stall a lock
  for device-unbounded time: fsync, socket transfers, subprocess,
  sleep, thread joins.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (ModuleCtx, PackageRule, Rule, function_body, register,
                   shallow_walk)
from .lockgraph import SYNC_KINDS

# -- R101 -------------------------------------------------------------


@register
class LockOrderInversion(PackageRule):
    id = "R101"
    name = "lock-order-inversion"
    short = ("Two locks are acquired in opposite nesting orders "
             "somewhere in the linted set")
    why = ("An A->B nesting in one thread and B->A in another is a "
           "textbook deadlock: each thread holds the lock the other "
           "needs.  Per-process it is a hung server; replicated across "
           "a fleet it is a correlated outage.  The check is package-"
           "wide because the two halves usually live in different "
           "files (the session plane nests into the group plane).")

    def check_package(self, mods):
        edges: Dict[Tuple[str, str],
                    List[Tuple[ModuleCtx, ast.AST]]] = {}
        for mod in mods:
            for outer, inner, node, _fn in mod.locks.nest_edges:
                edges.setdefault((outer, inner), []).append((mod, node))
        for (a, b), sites in sorted(edges.items()):
            rev = edges.get((b, a))
            if not rev or a >= b:       # report each pair once, at the
                continue                # sites of BOTH directions
            other = rev[0]
            for mod, node in sites:
                yield (mod, node,
                       f"lock order inversion: {a} -> {b} here but "
                       f"{b} -> {a} at {other[0].path}:"
                       f"{other[1].lineno} — one consistent order or "
                       f"a deadlock")
            here = sites[0]
            for mod, node in rev:
                yield (mod, node,
                       f"lock order inversion: {b} -> {a} here but "
                       f"{a} -> {b} at {here[0].path}:"
                       f"{here[1].lineno} — one consistent order or "
                       f"a deadlock")


# -- R102 -------------------------------------------------------------

# dotted calls that block for device/disk/process-unbounded time
_BLOCKING_DOTTED = {
    "os.fsync", "os.fdatasync", "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "select.select",
}
# attribute calls that block regardless of receiver spelling
_BLOCKING_ATTRS = {"fsync", "sendall", "recv", "recv_into", "accept"}
_CLOSURE_DEPTH = 4      # intra-class call closure for hidden blocking


@register
class BlockingCallUnderLock(Rule):
    id = "R102"
    name = "blocking-call-under-lock"
    short = "A blocking call (fsync/socket/subprocess/sleep/join) runs inside a held-lock region"
    why = ("A lock held across fsync, a socket transfer, a subprocess "
           "or a sleep serializes every other thread behind a latency "
           "the lock's critical section does not need: the serving "
           "plane's tail latency becomes the disk's.  Move the "
           "blocking call outside the critical section (snapshot under "
           "the lock, block outside — the store/durable pattern).")

    def _direct(self, mod: ModuleCtx, fn) -> List[Tuple[ast.Call, str]]:
        out: List[Tuple[ast.Call, str]] = []
        lg = mod.locks
        for node in shallow_walk(function_body(fn)):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func)
            if d is not None and (d in _BLOCKING_DOTTED
                                  or d.startswith("subprocess.")):
                out.append((node, f"{d}()"))
                continue
            if isinstance(node.func, ast.Attribute):
                a = node.func.attr
                if a in _BLOCKING_ATTRS:
                    out.append((node, f".{a}()"))
                elif a == "join" and lg.kind_of(
                        fn, node.func.value) == "thread":
                    out.append((node, f".{a}()"))
        return out

    def _transitive(self, mod: ModuleCtx, fn, depth: int,
                    seen: Set) -> Optional[str]:
        """First blocking call reachable through intra-class/local
        callees of `fn` (the store's `record -> _append -> fsync`
        seam), as a description string, or None."""
        if depth <= 0 or fn in seen:
            return None
        seen.add(fn)
        direct = self._direct(mod, fn)
        if direct:
            node, desc = direct[0]
            return f"{desc} at line {node.lineno}"
        for callee in mod.jit._callees(fn):
            sub = self._transitive(mod, callee, depth - 1, seen)
            if sub is not None:
                name = getattr(callee, "name", "<lambda>")
                return f"{name}() -> {sub}"
        return None

    def check(self, mod: ModuleCtx):
        lg = mod.locks
        if not lg.regions:
            return
        for fn in mod.jit.functions:
            scope = mod.jit.scope_of.get(fn)
            cls = mod.jit.class_of.get(fn)
            for node in shallow_walk(function_body(fn)):
                if not isinstance(node, ast.Call):
                    continue
                held = lg.held_at.get(node)
                if not held:
                    continue
                hl = ", ".join(dict.fromkeys(held))
                d = mod.dotted(node.func)
                if d is not None and (d in _BLOCKING_DOTTED
                                      or d.startswith("subprocess.")):
                    yield (node, f"blocking call {d}() while holding "
                                 f"{hl}")
                    continue
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr in _BLOCKING_ATTRS:
                        yield (node, f"blocking call .{f.attr}() while "
                                     f"holding {hl}")
                        continue
                    if f.attr == "join" and lg.kind_of(
                            fn, f.value) == "thread":
                        yield (node, f"Thread.join() while holding "
                                     f"{hl}")
                        continue
                # intra-class/local callee that blocks internally
                target = None
                if isinstance(f, ast.Name) and scope is not None:
                    target = scope.resolve(f.id)
                elif isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name) \
                        and f.value.id in ("self", "cls") \
                        and cls is not None:
                    target = mod.jit.methods.get((id(cls), f.attr))
                if target is not None:
                    desc = self._transitive(mod, target,
                                            _CLOSURE_DEPTH, set())
                    if desc is not None:
                        name = getattr(target, "name", "<lambda>")
                        yield (node,
                               f"call to {name}() performs blocking "
                               f"{desc} while holding {hl}")


# -- R103 -------------------------------------------------------------


@register
class UnguardedSharedField(Rule):
    id = "R103"
    name = "unguarded-shared-field"
    short = ("A self.* field is accessed under a lock in one method "
             "but bare in thread-entry code")
    why = ("A field the class bothers to lock in one place is shared "
           "state; touching it without the lock from code that runs on "
           "another thread (a Thread target or its callees) is a data "
           "race — torn reads of compound updates, lost increments, "
           "iteration over a list mid-mutation.  Either take the lock "
           "at the bare site or make the field single-owner (never "
           "touch it under a lock at all).")

    def check(self, mod: ModuleCtx):
        lg = mod.locks
        if not lg.thread_entries:
            return
        jit = mod.jit
        # attr (first segment after self.) -> guard lock ids, per class
        guarded: Dict[int, Dict[str, Set[str]]] = {}
        for fn in jit.functions:
            cls = jit.class_of.get(fn)
            if cls is None:
                continue
            for node in shallow_walk(function_body(fn)):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    continue
                held = lg.held_at.get(node)
                if held:
                    guarded.setdefault(id(cls), {}).setdefault(
                        node.attr, set()).update(held)
        if not guarded:
            return
        thread_fns = lg.thread_reachable()
        # a method whose EVERY intra-class call site sits inside a held
        # region effectively runs locked (obs/flight.py `_rotate`)
        lock_ctx = set()
        for fn in jit.functions:
            sites = lg.call_sites.get(fn)
            if sites and all(lg.held_at.get(call)
                             for call, _caller in sites):
                lock_ctx.add(fn)
        for fn in thread_fns:
            cls = jit.class_of.get(fn)
            if cls is None or fn in lock_ctx:
                continue
            cls_guarded = guarded.get(id(cls))
            if not cls_guarded:
                continue
            kinds = lg.class_kinds.get(id(cls), {})
            init = jit.methods.get((id(cls), "__init__"))
            if fn is init:
                continue            # runs before any thread starts
            for node in shallow_walk(function_body(fn)):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    continue
                attr = node.attr
                locks = cls_guarded.get(attr)
                if not locks:
                    continue
                if kinds.get(attr) in SYNC_KINDS:
                    continue        # the lock/event itself, not data
                if (id(cls), attr) in jit.methods:
                    continue        # a method reference, not a field
                if lg.held_at.get(node):
                    continue        # this access IS under a lock
                ll = ", ".join(sorted(locks))
                yield (node,
                       f"self.{attr} accessed without a lock in "
                       f"thread-entry code but guarded by {ll} "
                       f"elsewhere in {cls.name}")


# -- R104 -------------------------------------------------------------


@register
class AckBeforeDurable(Rule):
    id = "R104"
    name = "ack-before-durable"
    short = ("A serving path returns a reply after committing state "
             "without draining it to the checkpoint log first")
    why = ("The durability contract (serve/durable.py) is that any "
           "`committed: true` a client ever observed survives a crash: "
           "the commit record must be appended BEFORE the reply is "
           "written.  A handler that commits and returns a value "
           "without a drain/append between loses exactly the epochs "
           "clients believe are safe.  Split-phase appliers follow the "
           "repo's `*_locked` convention: a method named `*_locked` "
           "that commits is the under-lock half (the caller holds the "
           "lock and owns the reply), so the drain obligation moves to "
           "its call sites — each call to such a method counts as a "
           "commit in the calling function.")

    _COMMIT_ATTRS = {"_commit", "commit"}
    _DRAIN_ATTRS = {"_drain_ckpt", "drain_ckpt"}
    _LOCKED_SUFFIX = "_locked"

    def _commit_carriers(self, mod: ModuleCtx):
        """Names of `*_locked` methods whose body commits: the locked
        half of a split-phase tell.  Exempt from the in-function check
        (they return apply results to a lock-holding caller, not a
        wire reply) — but calls TO them are commits, so every caller
        inherits the drain-before-ack obligation."""
        carriers = set()
        for fn in mod.jit.functions:
            name = getattr(fn, "name", "")
            if not name.endswith(self._LOCKED_SUFFIX):
                continue
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in self._COMMIT_ATTRS:
                    rec = mod.plain_dotted(node.func.value) or ""
                    if rec == "self" or rec.startswith("self."):
                        carriers.add(name)
                        break
        return carriers

    @staticmethod
    def _in_scope(mod: ModuleCtx) -> bool:
        for alias, target in mod.aliases.items():
            if alias == "durable" or target.endswith(".durable") \
                    or target == "durable":
                return True
        return "_drain_ckpt" in mod.source

    def check(self, mod: ModuleCtx):
        if not self._in_scope(mod):
            return
        carriers = self._commit_carriers(mod)
        for fn in mod.jit.functions:
            name = getattr(fn, "name", "")
            if name in self._COMMIT_ATTRS:
                continue            # the commit primitive itself
            if name in carriers:
                continue            # locked half; callers own the drain
            commits: List[ast.Call] = []
            drains: List[ast.Call] = []
            returns: List[ast.Return] = []
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Return) and node.value is not None \
                        and not (isinstance(node.value, ast.Constant)
                                 and node.value.value is None):
                    returns.append(node)
                    continue
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute):
                    continue
                rec = mod.plain_dotted(node.func.value) or ""
                a = node.func.attr
                if (a in self._COMMIT_ATTRS or a in carriers) and (
                        rec == "self" or rec.startswith("self.")):
                    commits.append(node)
                elif a in self._DRAIN_ATTRS:
                    drains.append(node)
                elif a == "append" and ("durable" in rec
                                        or "ckpt" in rec):
                    drains.append(node)
            for c in commits:
                acked = any(r.lineno > c.lineno for r in returns)
                drained = any(d.lineno > c.lineno for d in drains)
                if acked and not drained:
                    yield (c,
                           "commit is acknowledged (value returned) "
                           "with no checkpoint drain/append after it — "
                           "a crash here loses a committed epoch the "
                           "client saw")


# -- R105 -------------------------------------------------------------


@register
class ThreadWithoutJoin(Rule):
    id = "R105"
    name = "daemon-thread-no-stop"
    short = ("A Thread is created with no reachable join() on its "
             "handle (or a container it is tracked in)")
    why = ("An untracked thread outlives shutdown: it races teardown "
           "(writing to closed sockets/files), holds the process open, "
           "and under the fleet plane turns one process's exit into a "
           "hang.  Track the handle and join it (bounded) in stop(); "
           "a genuinely fire-and-forget daemon gets a suppression with "
           "its justification.")

    @staticmethod
    def _join_evidence(mod: ModuleCtx):
        """Module-wide join coverage: dotted receiver paths of
        `.join()` calls, plus for-loop iterables whose loop variable is
        joined in the body (`for t in self._threads: t.join()`), with
        one local-alias hop (`ts = list(self._threads)`)."""
        joined: Set[str] = set()
        # local name -> dotted source, per function (alias hop)
        aliases: Dict[Tuple[int, str], str] = {}
        for fn in mod.jit.functions:
            key = id(fn)
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    v = node.value
                    if isinstance(v, ast.Call) and isinstance(
                            v.func, ast.Name) \
                            and v.func.id in ("list", "tuple", "sorted") \
                            and len(v.args) == 1:
                        v = v.args[0]
                    src = mod.plain_dotted(v)
                    if src is not None:
                        aliases[(key, node.targets[0].id)] = src
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "join":
                p = mod.plain_dotted(node.func.value)
                if p is not None:
                    joined.add(p)
            elif isinstance(node, (ast.For, ast.AsyncFor)) \
                    and isinstance(node.target, ast.Name):
                it = node.iter
                if isinstance(it, ast.Call) and isinstance(
                        it.func, ast.Name) \
                        and it.func.id in ("list", "tuple", "sorted") \
                        and len(it.args) == 1:
                    it = it.args[0]
                p = mod.plain_dotted(it)
                if p is None:
                    continue
                tname = node.target.id
                body_joins = any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "join"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == tname
                    for b in node.body for n in ast.walk(b))
                if body_joins:
                    joined.add(p)
                    fn = mod.enclosing_function(node)
                    if fn is not None and "." not in p:
                        src = aliases.get((id(fn), p))
                        if src:
                            joined.add(src)
        return joined

    @staticmethod
    def _handle(mod: ModuleCtx, call: ast.Call):
        """(kind, path) for the Thread's handle: ('name', p) for a
        direct assignment target, ('container', p) when appended/
        stored into a container, (None, None) when untracked."""
        node, parent = call, mod.parents.get(call)
        while parent is not None:
            if isinstance(parent, ast.Assign) \
                    and len(parent.targets) == 1:
                p = mod.plain_dotted(parent.targets[0])
                if p is not None:
                    return "name", p
                return None, None
            if isinstance(parent, ast.Call) and isinstance(
                    parent.func, ast.Attribute) \
                    and parent.func.attr in ("append", "add") \
                    and node in parent.args:
                p = mod.plain_dotted(parent.func.value)
                if p is not None:
                    return "container", p
                return None, None
            if isinstance(parent, (ast.ListComp, ast.List, ast.Tuple,
                                   ast.Starred, ast.IfExp)):
                node, parent = parent, mod.parents.get(parent)
                continue
            if isinstance(parent, ast.Attribute):
                # Thread(...).start() chain: no handle survives
                return None, None
            break
        return None, None

    def check(self, mod: ModuleCtx):
        lg = mod.locks
        if not lg.thread_creations:
            return
        joined = self._join_evidence(mod)

        # containers that thread handles are appended to, per handle
        def appended_to(fn, hname: str) -> List[str]:
            out = []
            if fn is None:
                return out
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr in ("append", "add") \
                        and any(isinstance(a, ast.Name)
                                and a.id == hname for a in node.args):
                    p = mod.plain_dotted(node.func.value)
                    if p is not None:
                        out.append(p)
            return out

        msg = ("Thread started without a reachable join(): track the "
               "handle and join it on shutdown (or suppress with the "
               "daemon's lifecycle justification)")
        for call, fn in lg.thread_creations:
            kind, path = self._handle(mod, call)
            if kind == "name":
                if path in joined:
                    continue
                if any(c in joined for c in appended_to(fn, path)):
                    continue
                yield (call, msg)
            elif kind == "container":
                if path not in joined:
                    yield (call, msg)
            else:
                yield (call, msg)


# -- R106 -------------------------------------------------------------


@register
class ConditionWaitNoPredicate(Rule):
    id = "R106"
    name = "condition-wait-no-predicate"
    short = "Condition.wait() is called outside a while loop"
    why = ("Condition waits wake spuriously and notify_all() wakes "
           "every waiter for a predicate only one can consume: a "
           "wait() not re-checked in a `while predicate:` loop "
           "proceeds on state that is not there.  `wait_for()` "
           "carries its own predicate and is exempt.")

    def check(self, mod: ModuleCtx):
        lg = mod.locks
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "wait"):
                continue
            fn = mod.enclosing_function(node)
            if lg.kind_of(fn, node.func.value) != "condition":
                continue            # Event.wait / unknown receivers
            in_while = False
            for anc in mod.ancestors(node):
                if isinstance(anc, ast.While):
                    in_while = True
                    break
                if anc is fn:
                    break
            if not in_while:
                yield (node,
                       "Condition.wait() outside a while-predicate "
                       "loop: spurious wakeups proceed on a predicate "
                       "that does not hold (use `while pred: cv.wait()`"
                       " or cv.wait_for(pred))")
