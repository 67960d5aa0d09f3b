"""The ut-lint rule pack: the five JAX hazards that cost this codebase
TPU throughput.  See docs/LINT.md for the full rationale per rule.

R001 host-sync-under-jit      device->host transfer inside traced code
R002 prng-key-reuse           a PRNG key consumed twice without split
R003 traced-control-flow      Python if/while on traced values under jit
R004 side-effect-under-jit    print/file-IO/global mutation under jit
R005 retrace-churn            jit wrappers constructed per call/iteration
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import FUNCTION_NODES, ModuleCtx, Rule, function_body, \
    register, shallow_walk

# ---------------------------------------------------------------------
_HOST_CASTS = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
_NUMPY_PULLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
_DEVICE_GET = {"jax.device_get"}


@register
class HostSyncUnderJit(Rule):
    id = "R001"
    name = "host-sync-under-jit"
    short = ("device->host transfer (float()/.item()/np.asarray/"
             "device_get) inside a traced function")
    why = ("Each sync serializes the XLA stream: the fused engine's "
           "~10^5 acq/s collapses to host roundtrip rate. Keep values "
           "on device (jnp ops) or sync outside the jitted region.")

    def check(self, mod: ModuleCtx) -> Iterator:
        jit = mod.jit
        for fn in jit.reachable:
            for node in shallow_walk(function_body(fn)):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                # float(x) / int(x) / bool(x) on a traced value
                if isinstance(f, ast.Name) and f.id in _HOST_CASTS \
                        and len(node.args) == 1 \
                        and jit.is_tainted_expr(fn, node.args[0]):
                    yield node, (
                        f"{f.id}() on a traced value forces a host sync "
                        f"under jit; keep it a jnp array (or compute the "
                        f"scalar outside the traced region)")
                    continue
                # x.item() / x.tolist() / x.block_until_ready()
                if isinstance(f, ast.Attribute) \
                        and f.attr in _SYNC_METHODS \
                        and jit.is_tainted_expr(fn, f.value):
                    yield node, (
                        f".{f.attr}() on a traced value forces a host "
                        f"sync under jit")
                    continue
                d = mod.dotted(f)
                if d in _NUMPY_PULLS and node.args \
                        and jit.is_tainted_expr(fn, node.args[0]):
                    yield node, (
                        f"{d}() materializes a traced value on the host "
                        f"under jit; use jnp.asarray / keep the array on "
                        f"device")
                elif d in _DEVICE_GET and node.args \
                        and jit.is_tainted_expr(fn, node.args[0]):
                    yield node, (
                        "jax.device_get() inside a traced function is a "
                        "host sync; move it outside the jitted region")


# ---------------------------------------------------------------------
# jax.random functions that READ a key (first positional argument).
# split() counts: feeding one key to two split() calls yields identical
# child streams — the same corruption as sampler reuse.  fold_in() does
# NOT: it derives a stream decorrelated by explicit extra data, and
# `fold_in(key, i)` across loop indices is the standard idiom (the
# multi-chip scorer's per-shard keys depend on it).
_KEY_FACTORY = {"PRNGKey", "key"}
_KEY_NONCONSUMING = {"fold_in", "key_data", "wrap_key_data", "clone",
                     "key_impl", "default_prng_impl"}


class _KeyState:
    FRESH, CONSUMED = 0, 1


@register
class PRNGKeyReuse(Rule):
    id = "R002"
    name = "prng-key-reuse"
    short = "a PRNG key consumed twice without an intervening split"
    why = ("Reused keys give technique populations identical "
           "perturbations: arms stop being independent and the bandit "
           "credits correlated noise. Always split (or fold_in) before "
           "each consumer.")

    def check(self, mod: ModuleCtx) -> Iterator:
        # module scope first: scripts consume keys at top level, and a
        # module-level reuse replays streams across the whole process
        yield from self._check_stmts(mod, list(mod.tree.body))
        for fn in mod.jit.functions:
            if isinstance(fn, ast.Lambda):
                continue
            yield from self._check_stmts(mod, function_body(fn))

    # -- helpers ------------------------------------------------------
    def _random_attr(self, mod: ModuleCtx, func) -> Optional[str]:
        """'split' / 'uniform' / ... when `func` is jax.random.<attr>."""
        d = mod.dotted(func)
        if d is None or not d.startswith("jax.random."):
            return None
        return d.rsplit(".", 1)[-1]

    def _consumed_key(self, mod: ModuleCtx, call: ast.Call
                      ) -> Optional[ast.AST]:
        attr = self._random_attr(mod, call.func)
        if attr is None or attr in _KEY_FACTORY \
                or attr in _KEY_NONCONSUMING:
            return None
        if call.args:
            return call.args[0]
        for kw in call.keywords:
            if kw.arg == "key":
                return kw.value
        return None

    def _is_key_factory(self, mod: ModuleCtx, node) -> bool:
        """A PRNGKey(...) call with a CONSTANT seed.  PRNGKey(seed)
        over a parameter/attribute yields a different stream per
        caller — the canonical `split(PRNGKey(seed))` init idiom must
        not be flagged."""
        if not isinstance(node, ast.Call):
            return False
        attr = self._random_attr(mod, node.func)
        if attr not in _KEY_FACTORY:
            return False
        vals = list(node.args) + [k.value for k in node.keywords]
        return bool(vals) and all(isinstance(v, ast.Constant)
                                  for v in vals)

    # -- the tiny abstract interpreter --------------------------------
    def _check_stmts(self, mod: ModuleCtx, stmts: List[ast.AST]
                     ) -> Iterator:
        findings: List[Tuple[ast.AST, str]] = []
        state: Dict[str, int] = {}

        def consume(name: str, node: ast.AST) -> None:
            if state.get(name) == _KeyState.CONSUMED:
                findings.append((node, (
                    f"PRNG key '{name}' is consumed again without an "
                    f"intervening jax.random.split/fold_in — identical "
                    f"random streams")))
            state[name] = _KeyState.CONSUMED

        def rebind(target: ast.AST) -> None:
            for n in ast.walk(target):
                d = mod.plain_dotted(n)
                if d is not None and d in state:
                    state[d] = _KeyState.FRESH

        def consume_calls(nodes: List[ast.AST]) -> None:
            for node in shallow_walk(nodes):
                if not isinstance(node, ast.Call):
                    continue
                key_arg = self._consumed_key(mod, node)
                if key_arg is not None:
                    d = mod.plain_dotted(key_arg)
                    if d is not None:
                        consume(d, node)

        def visit_expr(expr: ast.AST) -> None:
            comps: List[ast.AST] = []
            for node in shallow_walk([expr]):
                if isinstance(node, (ast.ListComp, ast.SetComp,
                                     ast.GeneratorExp, ast.DictComp)):
                    comps.append(node)
                if not isinstance(node, ast.Call):
                    continue
                key_arg = self._consumed_key(mod, node)
                if key_arg is not None:
                    d = mod.plain_dotted(key_arg)
                    if d is not None:
                        consume(d, node)
                # constant key consumed inline: PRNGKey(..) as a direct
                # argument of another call — every invocation of the
                # enclosing function replays the same stream
                for a in list(node.args) + [k.value for k in
                                            node.keywords]:
                    if self._is_key_factory(mod, a):
                        findings.append((a, (
                            "jax.random.PRNGKey(<constant>) consumed "
                            "inline: this code replays the same random "
                            "stream on every execution; split from a "
                            "stored key instead")))
            # second symbolic iteration over each comprehension's
            # per-iteration parts (element + filters): a key consumed
            # in the body but split outside the comprehension surfaces
            # on this pass, same as the two-pass For/While handling.
            # Generator targets rebind first — `for k in split(key, n)`
            # yields a FRESH k each iteration, not reuse.
            for comp in comps:
                for g in comp.generators:
                    rebind(g.target)
                body = ([comp.key, comp.value]
                        if isinstance(comp, ast.DictComp)
                        else [comp.elt])
                body += [i for g in comp.generators for i in g.ifs]
                consume_calls(body)

        def exec_stmts(stmts: List[ast.AST]) -> None:
            for s in stmts:
                if isinstance(s, FUNCTION_NODES + (ast.ClassDef,)):
                    continue
                if isinstance(s, ast.Assign):
                    visit_expr(s.value)
                    for t in s.targets:
                        rebind(t)
                elif isinstance(s, (ast.AnnAssign, ast.AugAssign)):
                    if s.value is not None:
                        visit_expr(s.value)
                    rebind(s.target)
                elif isinstance(s, ast.If):
                    visit_expr(s.test)
                    pre = dict(state)
                    exec_stmts(s.body)
                    after_body = dict(state)
                    state.clear()
                    state.update(pre)
                    exec_stmts(s.orelse)
                    # merge: consumed wins (either path may have run)
                    for k in set(after_body) | set(state):
                        state[k] = max(state.get(k, 0),
                                       after_body.get(k, 0))
                elif isinstance(s, (ast.For, ast.AsyncFor)):
                    visit_expr(s.iter)
                    # two symbolic iterations: reuse across iterations
                    # (a key consumed in the body but split outside the
                    # loop) surfaces on the second pass
                    for _ in range(2):
                        rebind(s.target)
                        exec_stmts(s.body)
                    exec_stmts(s.orelse)
                elif isinstance(s, ast.While):
                    for _ in range(2):
                        visit_expr(s.test)
                        exec_stmts(s.body)
                    exec_stmts(s.orelse)
                elif isinstance(s, ast.Try):
                    exec_stmts(s.body)
                    for h in s.handlers:
                        exec_stmts(h.body)
                    exec_stmts(s.orelse)
                    exec_stmts(s.finalbody)
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    for item in s.items:
                        visit_expr(item.context_expr)
                    exec_stmts(s.body)
                elif isinstance(s, ast.Return):
                    if s.value is not None:
                        visit_expr(s.value)
                elif isinstance(s, ast.Expr):
                    visit_expr(s.value)
                else:
                    for child in ast.iter_child_nodes(s):
                        if isinstance(child, ast.expr):
                            visit_expr(child)

        exec_stmts(stmts)
        yield from findings


# ---------------------------------------------------------------------
def _is_none_check(test: ast.AST) -> bool:
    """`x is None` / `x is not None`, possibly under not/and/or — the
    standard static-argument dispatch pattern inside jitted bodies."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in test.ops)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_none_check(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_is_none_check(v) for v in test.values)
    return False


@register
class TracedControlFlow(Rule):
    id = "R003"
    name = "traced-control-flow"
    short = "Python if/while on a traced value inside a jitted body"
    why = ("Branching on a traced value either raises a "
           "TracerBoolConversionError or — when it slips through via a "
           "concretized aux value — forces a blocking host sync and a "
           "retrace per branch. Use jnp.where / lax.cond / "
           "lax.while_loop.")

    def check(self, mod: ModuleCtx) -> Iterator:
        jit = mod.jit
        jnp_prefixes = ("jax.numpy.", "jax.lax.", "jnp.")
        for fn in jit.reachable:
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, (ast.If, ast.While)):
                    test = node.test
                elif isinstance(node, ast.IfExp):
                    test = node.test
                else:
                    continue
                # strip `x is None` operands out of and/or chains: the
                # static-dispatch half of `if x is None and n:` must not
                # taint the whole test
                operands: List[ast.AST] = []
                todo = [test]
                while todo:
                    t = todo.pop()
                    if isinstance(t, ast.BoolOp):
                        todo.extend(t.values)
                    elif not _is_none_check(t):
                        operands.append(t)
                hazard = False
                for op in operands:
                    # a jnp/lax call in the test is always device-valued
                    for sub in ast.walk(op):
                        if isinstance(sub, ast.Call):
                            d = mod.dotted(sub.func)
                            if d is not None \
                                    and d.startswith(jnp_prefixes):
                                hazard = True
                                break
                    if hazard or jit.is_tainted_expr(fn, op):
                        hazard = True
                        break
                if hazard:
                    kw = ("if" if isinstance(node, (ast.If, ast.IfExp))
                          else "while")
                    yield node, (
                        f"Python `{kw}` on a traced value inside a "
                        f"jitted body; use jnp.where / lax.cond / "
                        f"lax.while_loop (or hoist the decision out of "
                        f"the traced region)")


# ---------------------------------------------------------------------
_LOGGER_NAMES = {"log", "logger", "logging"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "critical",
                "exception"}


@register
class SideEffectUnderJit(Rule):
    id = "R004"
    name = "side-effect-under-jit"
    short = "print / file IO / logging / global mutation under jit"
    why = ("Side effects run at TRACE time only: they silently vanish "
           "on cached executions, and print() on a traced value syncs. "
           "Use jax.debug.print/jax.debug.callback, or move the effect "
           "to the host loop.")

    def check(self, mod: ModuleCtx) -> Iterator:
        for fn in mod.jit.reachable:
            for node in shallow_walk(function_body(fn)):
                if isinstance(node, ast.Global):
                    yield node, (
                        "global mutation inside a jitted body happens "
                        "at trace time only (stale on every cached "
                        "call); return the value instead")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id == "print":
                    yield node, (
                        "print() under jit runs only at trace time; "
                        "use jax.debug.print(...)")
                elif isinstance(f, ast.Name) and f.id == "open":
                    yield node, (
                        "file IO under jit runs only at trace time; "
                        "move it to the host loop or use "
                        "jax.debug.callback")
                elif isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name) \
                        and f.value.id in _LOGGER_NAMES \
                        and f.attr in _LOG_METHODS:
                    yield node, (
                        f"{f.value.id}.{f.attr}() under jit runs only "
                        f"at trace time; use jax.debug.print or log "
                        f"from the host loop")


# ---------------------------------------------------------------------
@register
class RetraceChurn(Rule):
    id = "R005"
    name = "retrace-churn"
    short = "a jit wrapper constructed per call / per loop iteration"
    why = ("jax.jit's compile cache keys on the FUNCTION OBJECT: a "
           "wrapper rebuilt each call or iteration never hits the "
           "cache, so every invocation pays a full retrace+compile. "
           "Hoist the jit to definition time, or store it in a keyed "
           "cache (dict/attribute).")

    _wrappers = {"jax.jit", "jax.pmap", "jax.pjit", "jit", "pmap"}

    def _is_jit_call(self, mod: ModuleCtx, node) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = mod.dotted(node.func)
        return d in self._wrappers

    def check(self, mod: ModuleCtx) -> Iterator:
        jit = mod.jit
        for node in ast.walk(mod.tree):
            if not self._is_jit_call(mod, node):
                continue
            parent = mod.parents.get(node)
            # (c) immediate invocation: jax.jit(f)(x) — a fresh wrapper
            # per execution; at module level it runs once, so only flag
            # inside a function
            if isinstance(parent, ast.Call) and parent.func is node \
                    and mod.enclosing_function(node) is not None:
                yield node, (
                    "jax.jit(f)(...) builds a fresh wrapper per call — "
                    "the compile cache never hits; jit once at "
                    "definition time and reuse the wrapper")
                continue
            # (b) jit construction inside a traced function.  A
            # parameterized decorator `@jax.jit(donate_argnums=0)` is
            # definition-time jitting of the function it decorates —
            # the churn question applies to the function ENCLOSING the
            # decorated def, not the def itself
            fn = mod.enclosing_function(node)
            if fn is not None and any(
                    node is d for d in
                    getattr(fn, "decorator_list", [])):
                fn = mod.enclosing_function(fn)
            if fn is not None and fn in jit.reachable:
                yield node, (
                    "constructing a jit wrapper inside a traced "
                    "function re-traces it on every outer trace; hoist "
                    "it out of the jitted region")
                continue
            # (a) jit in a loop, unless stored under a key (attribute /
            # subscript target = an explicit wrapper cache)
            in_loop = any(isinstance(a, (ast.For, ast.AsyncFor,
                                         ast.While, ast.comprehension))
                          for a in mod.ancestors(node))
            if not in_loop:
                continue
            stored_keyed = False
            for anc in mod.ancestors(node):
                if isinstance(anc, ast.Assign):
                    if all(isinstance(t, (ast.Attribute, ast.Subscript))
                           for t in anc.targets):
                        stored_keyed = True
                    break
                if isinstance(anc, (ast.For, ast.AsyncFor, ast.While,
                                    *FUNCTION_NODES)):
                    break
            if not stored_keyed:
                yield node, (
                    "jit wrapper constructed inside a loop: each "
                    "iteration pays a fresh trace+compile; hoist it out "
                    "of the loop or store it in a keyed cache "
                    "(self._jit[name] = jax.jit(...))")
