"""Which functions in a module run under a JAX trace?

Roots are found three ways:

* **decorators** — `@jax.jit`, `@jit`, `@partial(jax.jit, ...)`,
  `@jax.pmap`, `@jax.vmap`, `@jax.checkpoint` / `@jax.remat`;
* **higher-order call sites** — a function object passed to
  `jax.jit(f)`, `jax.lax.scan(f, ...)`, `while_loop`, `fori_loop`,
  `cond`, `switch`, `lax.map`, `associative_scan`, `vmap`, `pmap`,
  `grad` / `value_and_grad`, `shard_map` (name or lambda, local or
  module-level or `self.method`);
* **repo convention** — methods named `propose` / `observe` on any
  class: technique operators are jitted centrally by the driver
  (`driver/driver.py` `_propose_jit`/`_observe_jit`) and run inside the
  fused engine's `lax.scan` step, so a per-file analysis cannot see
  their jit wrapper.  The set is `HOT_METHOD_NAMES`.

Reachability then closes over intra-module calls: plain `g(...)` in the
enclosing scope chain, `self.m(...)` / `cls.m(...)` within the class.
Cross-module calls are invisible (per-file analysis) — the convention
set exists precisely to cover the one cross-module jit seam this repo
has.

Taint: within a traced function, the *parameters* are the traced
values (minus `self`/`cls` and the by-convention static `space` handle),
propagated forward through assignments.  Rules use taint to avoid
flagging host-side math on closure constants inside jitted bodies
(e.g. `float(np.log2(d))` over a static dimension is fine; `float(x)`
over a parameter is a device sync).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import FUNCTION_NODES, ModuleCtx, function_body, shallow_walk

# canonical dotted callables whose function argument(s) get traced
JIT_WRAPPERS = {
    "jax.jit", "jax.pmap", "jax.vmap", "jax.grad", "jax.value_and_grad",
    "jax.checkpoint", "jax.remat", "jax.pjit",
}
# dotted name -> positional indices of the traced callee(s)
LAX_HOF: Dict[str, Tuple[int, ...]] = {
    "jax.lax.scan": (0,),
    "jax.lax.while_loop": (0, 1),
    "jax.lax.fori_loop": (2,),
    "jax.lax.cond": (1, 2),
    "jax.lax.switch": (1, 2, 3, 4, 5, 6, 7, 8),
    "jax.lax.map": (0,),
    "jax.lax.associative_scan": (0,),
    "jax.experimental.shard_map.shard_map": (0,),
    "jax.checkpoint": (0,),
}
# this repo jits these methods from another module (driver/engine) —
# but only on Technique classes (techniques/ modules, or classes whose
# base name ends in 'Technique'): surrogate managers also have an
# `observe`, and theirs is host-side by design
HOT_METHOD_NAMES = {"propose", "observe"}
# parameters that are host-side handles by convention, not traced values
NONTRACED_PARAMS = {"self", "cls", "space", "mesh"}
# parameter NAMES that are static shape/config scalars by repo
# convention (they parameterize shapes, so they cannot be traced):
# n_cat, n_cont, num_steps, dim, steps, axis, ...
STATIC_PARAM_RE = re.compile(
    r"^(n|num|dim|ndim|size|steps|axis|length|count|rank|width|depth"
    r"|stride|beta|lr|lam|sense)(_\w+)*$")
# attribute reads that yield STATIC metadata even on traced arrays
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "weak_type",
                "sharding", "aval"}
# calls whose result is static regardless of argument taint
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr",
                "callable", "id", "repr"}


def _last_segment(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1]


def _is_jit_wrapper(mod: ModuleCtx, node: ast.AST) -> bool:
    d = mod.dotted(node)
    if d is None:
        return False
    if d in JIT_WRAPPERS:
        return True
    # bare `jit`/`pmap` names with no visible import (fixtures, exec'd
    # snippets) still count: a false jit context is cheaper than a
    # missed one for every rule in the pack
    return d in ("jit", "pmap", "pjit")


def _decorator_is_jit(mod: ModuleCtx, dec: ast.AST) -> bool:
    if _is_jit_wrapper(mod, dec):
        return True
    if isinstance(dec, ast.Call):
        # @partial(jax.jit, static_argnums=...) / @jax.jit(...)-style
        fd = mod.dotted(dec.func)
        if fd in ("functools.partial", "partial") and dec.args:
            return _is_jit_wrapper(mod, dec.args[0])
        return _is_jit_wrapper(mod, dec.func)
    return False


class _Scope:
    """One function (or module/class) scope: locally defined functions
    by name, for resolving callees."""

    def __init__(self, node, parent: Optional["_Scope"], cls=None):
        self.node = node
        self.parent = parent
        self.cls = cls                       # enclosing ClassDef if any
        self.local_funcs: Dict[str, ast.AST] = {}

    def resolve(self, name: str):
        s = self
        while s is not None:
            if name in s.local_funcs:
                return s.local_funcs[name]
            s = s.parent
        return None


class JitGraph:
    def __init__(self, mod: ModuleCtx):
        self.mod = mod
        self.functions: List[ast.AST] = []       # all function-like defs
        self.scope_of: Dict[ast.AST, _Scope] = {}
        self.class_of: Dict[ast.AST, Optional[ast.ClassDef]] = {}
        self.methods: Dict[Tuple[int, str], ast.AST] = {}  # (id(cls), name)
        self.roots: Set[ast.AST] = set()
        self._collect()
        self.reachable: Set[ast.AST] = self._close()
        self._taint_cache: Dict[ast.AST, Set[str]] = {}

    # -- collection ---------------------------------------------------
    def _collect(self) -> None:
        mod = self.mod
        module_scope = _Scope(mod.tree, None)

        def visit(node, scope: _Scope, cls, direct):
            # `cls` is the class whose instance `self` refers to here —
            # it flows INTO nested functions (a scan body defined in a
            # method still calls self.step on the same instance);
            # `direct` marks immediate class children (real methods).
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, scope, child, True)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    self._register(child, scope, cls, direct)
                    inner = _Scope(child, scope, cls)
                    self.scope_of[child] = inner
                    visit(child, inner, cls, False)
                elif isinstance(child, ast.Lambda):
                    self.functions.append(child)
                    self.class_of[child] = cls
                    inner = _Scope(child, scope, cls)
                    self.scope_of[child] = inner
                    visit(child, inner, cls, False)
                else:
                    visit(child, scope, cls, direct)

        visit(mod.tree, module_scope, None, False)

        # roots from HOF call sites (after all defs are registered)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                self._roots_from_call(node)

    def _register(self, fn, scope: _Scope, cls, direct: bool) -> None:
        self.functions.append(fn)
        self.class_of[fn] = cls
        scope.local_funcs[fn.name] = fn
        if cls is not None and direct:
            self.methods[(id(cls), fn.name)] = fn
        if any(_decorator_is_jit(self.mod, d) for d in fn.decorator_list):
            self.roots.add(fn)
        if cls is not None and direct and fn.name in HOT_METHOD_NAMES \
                and self._is_technique_class(cls):
            self.roots.add(fn)

    def _is_technique_class(self, cls: ast.ClassDef) -> bool:
        path = self.mod.path.replace("\\", "/")
        if "/techniques/" in path or path.endswith("techniques.py"):
            return True
        for base in cls.bases:
            d = self.mod.plain_dotted(base) or ""
            if d.rsplit(".", 1)[-1].endswith("Technique"):
                return True
        return False

    def _resolve_callable_arg(self, call: ast.Call, arg: ast.AST):
        """A positional arg of a jit/HOF call -> function node if it
        names one we know (local/module function, lambda, self.m)."""
        if isinstance(arg, ast.Lambda):
            return arg
        fn_scope = self._enclosing_scope(call)
        if isinstance(arg, ast.Name) and fn_scope is not None:
            return fn_scope.resolve(arg.id)
        if isinstance(arg, ast.Attribute) and isinstance(
                arg.value, ast.Name) and arg.value.id in ("self", "cls"):
            cls = self._enclosing_class(call)
            if cls is not None:
                return self.methods.get((id(cls), arg.attr))
        return None

    def _roots_from_call(self, call: ast.Call) -> None:
        mod = self.mod
        d = mod.dotted(call.func)
        idxs: Tuple[int, ...] = ()
        if d is not None and (d in JIT_WRAPPERS
                              or _last_segment(d) == "shard_map"):
            idxs = (0,)
        elif d is not None:
            hof = LAX_HOF.get(d)
            if hof is None and d.startswith("lax."):
                hof = LAX_HOF.get("jax." + d)
            if hof is None and _last_segment(d) in (
                    "scan", "while_loop", "fori_loop", "cond", "switch"):
                hof = LAX_HOF.get("jax.lax." + _last_segment(d))
            if hof is not None:
                idxs = hof
        if not idxs:
            return
        for i in idxs:
            if i < len(call.args):
                target = self._resolve_callable_arg(call, call.args[i])
                if target is not None:
                    self.roots.add(target)

    def _enclosing_scope(self, node) -> Optional[_Scope]:
        fn = self.mod.enclosing_function(node)
        if fn is None:
            return None
        return self.scope_of.get(fn)

    def _enclosing_class(self, node) -> Optional[ast.ClassDef]:
        for anc in self.mod.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
            if isinstance(anc, FUNCTION_NODES):
                cls = self.class_of.get(anc)
                if cls is not None:
                    return cls
        return None

    # -- reachability -------------------------------------------------
    def _callees(self, fn) -> Set[ast.AST]:
        out: Set[ast.AST] = set()
        scope = self.scope_of.get(fn)
        cls = self.class_of.get(fn)
        for node in shallow_walk(function_body(fn)):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and scope is not None:
                t = scope.resolve(f.id)
                if t is not None:
                    out.add(t)
            elif isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name) and f.value.id in ("self", "cls") \
                    and cls is not None:
                t = self.methods.get((id(cls), f.attr))
                if t is not None:
                    out.add(t)
        return out

    def _close(self) -> Set[ast.AST]:
        seen: Set[ast.AST] = set()
        todo = list(self.roots)
        while todo:
            fn = todo.pop()
            if fn in seen:
                continue
            seen.add(fn)
            todo.extend(self._callees(fn) - seen)
        return seen

    # -- taint --------------------------------------------------------
    def tainted_names(self, fn) -> Set[str]:
        """Names holding (potentially) traced values inside `fn`:
        parameters minus the by-convention host handles and static
        shape/config scalars, closed forward over assignments.  Reads
        that yield static metadata (`x.shape`, `x.ndim`, `len(x)`) do
        NOT propagate taint — shape math on traced arrays is host-side
        by construction."""
        cached = self._taint_cache.get(fn)
        if cached is not None:
            return cached
        args = fn.args
        params = [a.arg for a in (
            list(getattr(args, "posonlyargs", [])) + args.args
            + args.kwonlyargs)]
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                params.append(extra.arg)
        tainted = {p for p in params
                   if p not in NONTRACED_PARAMS
                   and not STATIC_PARAM_RE.match(p)}

        def target_names(t) -> Set[str]:
            return {n.id for n in ast.walk(t)
                    if isinstance(n, ast.Name)}

        def assign(value, targets) -> bool:
            if value is None or not _expr_tainted(value, tainted):
                return False
            new: Set[str] = set()
            for t in targets:
                new |= target_names(t) - tainted
            if new:
                tainted.update(new)
                return True
            return False

        def for_pairs(node):
            """(target, source-expr) pairs: zip/enumerate iterate
            positionally, so only targets fed by tainted iterables
            become tainted."""
            it, tgt = node.iter, node.target
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
                if it.func.id == "enumerate" and it.args \
                        and isinstance(tgt, ast.Tuple) \
                        and len(tgt.elts) == 2:
                    return [(tgt.elts[1], it.args[0])]
                if it.func.id == "zip" \
                        and isinstance(tgt, ast.Tuple) \
                        and len(tgt.elts) == len(it.args) \
                        and not any(isinstance(a, ast.Starred)
                                    for a in it.args):
                    return list(zip(tgt.elts, it.args))
            return [(tgt, it)]

        body = function_body(fn)
        for _ in range(20):
            changed = False
            for node in shallow_walk(body):
                if isinstance(node, ast.Assign):
                    changed |= assign(node.value, node.targets)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                       ast.NamedExpr)):
                    changed |= assign(node.value, [node.target])
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    for t, src in for_pairs(node):
                        changed |= assign(src, [t])
            if not changed:
                break
        self._taint_cache[fn] = tainted
        return tainted

    def is_tainted_expr(self, fn, expr) -> bool:
        return _expr_tainted(expr, self.tainted_names(fn))


def _expr_tainted(expr: ast.AST, tainted: Set[str]) -> bool:
    """Does `expr` reference a tainted name OUTSIDE static-metadata
    contexts (`.shape`/`.ndim`/... attribute reads, `len()` etc.)?"""
    if isinstance(expr, ast.Attribute) and expr.attr in STATIC_ATTRS:
        return False
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in STATIC_CALLS:
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, FUNCTION_NODES):
        return False
    return any(_expr_tainted(c, tainted)
               for c in ast.iter_child_nodes(expr))
