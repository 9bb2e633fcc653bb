"""Local (per-function) taint dataflow shared by the contract checkers.

``cow-mutation`` and ``frozen-bytes`` are the same analysis with
different sources and sinks: values flowing out of a known
*snapshot-returning* API are tainted, taint propagates through local
aliases / subscripts / loops, and a *mutation* of a tainted value is a
finding. The flow is deliberately function-local and forward-only —
single pass in source order, branches merged by union — which trades a
little recall for near-zero false positives on the shapes this codebase
actually writes (the waiver mechanism covers the true write boundaries).

Taint kinds:

- ``ELEM``: the value itself is a shared snapshot (mutating it corrupts
  the store / cache / every other reader),
- ``COLL``: a freshly-built container whose *elements* are shared
  (mutating the container is fine; mutating an element is not).
"""

from __future__ import annotations

import ast
from typing import Optional

from .base import Finding, SourceFile, expr_text

ELEM = "elem"
COLL = "coll"

Taint = Optional[str]

#: in-place mutators on dicts/lists/sets: calling one on a tainted value
#: is a mutation sink
MUTATOR_METHODS = frozenset({
    "setdefault", "update", "pop", "popitem", "clear",
    "append", "extend", "insert", "remove", "sort", "reverse",
    "add", "discard",
})

#: calls that return a private copy — taint does not flow through them
SAFE_CALLS = frozenset({"deepcopy", "copy"})


class TaintScanner:
    """One checker pass over one file. Subclasses define the sources
    (what taints) and refine the sinks (what counts as mutation)."""

    rule = "taint"
    #: function name -> index of the argument it mutates in place
    arg_mutators: dict[str, int] = {}
    #: flag ``name += ...`` on an ELEM-tainted bare name (bytes contract)
    flag_aug_name = False

    def __init__(self, f: SourceFile):
        self.f = f
        self.findings: list[Finding] = []

    # ------------------------------------------------------------- hooks

    def taint_of_call(self, call: ast.Call, env: dict[str, Taint]) -> Taint:
        """Taint of a call expression (source detection)."""
        return None

    def taint_of_attribute(self, node: ast.Attribute,
                           env: dict[str, Taint]) -> Taint:
        return None

    def tuple_call_taints(self, call: ast.Call,
                          n_targets: int) -> list[Taint] | None:
        """Taints for ``a, b = call(...)`` unpacking (source detection)."""
        return None

    def describe_mutation(self, text: str) -> str:
        return f"in-place mutation of shared value {text!r}"

    # -------------------------------------------------------------- run

    def run(self) -> list[Finding]:
        for fn in ast.walk(self.f.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_block(fn.body, {})
        self._scan_block(
            [s for s in self.f.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))],
            {})
        return self.findings

    # ------------------------------------------------------- taint eval

    def taint(self, node: ast.AST, env: dict[str, Taint]) -> Taint:
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Call):
            return self.taint_of_call(node, env)
        if isinstance(node, ast.Attribute):
            return self.taint_of_attribute(node, env)
        if isinstance(node, ast.Subscript):
            base = self.taint(node.value, env)
            if base in (COLL, ELEM):
                return ELEM
            return None
        if isinstance(node, ast.BoolOp):
            ts = [self.taint(v, env) for v in node.values]
            if ELEM in ts:
                return ELEM
            if COLL in ts:
                return COLL
            return None
        if isinstance(node, ast.IfExp):
            ts = [self.taint(node.body, env), self.taint(node.orelse, env)]
            return ELEM if ELEM in ts else (COLL if COLL in ts else None)
        if isinstance(node, ast.NamedExpr):
            t = self.taint(node.value, env)
            env[node.target.id] = t
            return t
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            if len(node.generators) == 1:
                gen = node.generators[0]
                it = self.taint(gen.iter, env)
                inner = dict(env)
                if it in (COLL, ELEM):
                    for n in ast.walk(gen.target):
                        if isinstance(n, ast.Name):
                            inner[n.id] = ELEM
                t_elt = self.taint(node.elt, inner)
                return COLL if t_elt == ELEM else None
            return None
        if isinstance(node, ast.Starred):
            return self.taint(node.value, env)
        return None

    # --------------------------------------------------------- statements

    def _scan_block(self, stmts: list[ast.stmt], env: dict[str, Taint]) -> None:
        for st in stmts:
            self._scan_stmt(st, env)

    def _scan_stmt(self, st: ast.stmt, env: dict[str, Taint]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # separate scope, scanned on its own
        if isinstance(st, ast.Assign):
            self._handle_assign(st.targets, st.value, env)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            self._handle_assign([st.target], st.value, env)
        elif isinstance(st, ast.AugAssign):
            self._check_target_mutation(st.target, env, aug=True)
            self._scan_value(st.value, env)
        elif isinstance(st, ast.Expr):
            self._scan_value(st.value, env)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            it = self.taint(st.iter, env)
            self._scan_value(st.iter, env)
            if it in (COLL, ELEM):
                for n in ast.walk(st.target):
                    if isinstance(n, ast.Name):
                        env[n.id] = ELEM
            else:
                for n in ast.walk(st.target):
                    if isinstance(n, ast.Name):
                        env[n.id] = None
            self._scan_block(st.body, env)
            self._scan_block(st.orelse, env)
        elif isinstance(st, ast.While):
            self._scan_block(st.body, env)
            self._scan_block(st.orelse, env)
        elif isinstance(st, ast.If):
            self._scan_block(st.body, env)
            self._scan_block(st.orelse, env)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._scan_value(item.context_expr, env)
                if item.optional_vars is not None and isinstance(
                        item.optional_vars, ast.Name):
                    env[item.optional_vars.id] = self.taint(
                        item.context_expr, env)
            self._scan_block(st.body, env)
        elif isinstance(st, ast.Try):
            self._scan_block(st.body, env)
            for h in st.handlers:
                self._scan_block(h.body, env)
            self._scan_block(st.orelse, env)
            self._scan_block(st.finalbody, env)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                if isinstance(tgt, ast.Subscript):
                    if self.taint(tgt.value, env) == ELEM:
                        self._flag(tgt, f"del on shared value "
                                        f"{expr_text(tgt.value)!r}")
                elif isinstance(tgt, ast.Name):
                    env[tgt.id] = None
        elif isinstance(st, ast.Return) and st.value is not None:
            self._scan_value(st.value, env)

    def _handle_assign(self, targets: list[ast.expr], value: ast.expr,
                       env: dict[str, Taint]) -> None:
        self._scan_value(value, env)
        # tuple-unpack sources: `items, rv = store.list(...)`
        if (len(targets) == 1 and isinstance(targets[0], ast.Tuple)
                and isinstance(value, ast.Call)):
            elts = targets[0].elts
            taints = self.tuple_call_taints(value, len(elts))
            if taints is not None:
                for tgt, t in zip(elts, taints):
                    if isinstance(tgt, ast.Name):
                        env[tgt.id] = t
                return
        t = self.taint(value, env)
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                env[tgt.id] = t
            elif isinstance(tgt, (ast.Subscript, ast.Attribute)):
                self._check_target_mutation(tgt, env)
            elif isinstance(tgt, ast.Tuple):
                for n in tgt.elts:
                    if isinstance(n, ast.Name):
                        env[n.id] = ELEM if t in (COLL, ELEM) else None

    def _check_target_mutation(self, tgt: ast.expr, env: dict[str, Taint],
                               aug: bool = False) -> None:
        if isinstance(tgt, (ast.Subscript, ast.Attribute)):
            if self.taint(tgt.value, env) == ELEM:
                self._flag(tgt, self.describe_mutation(expr_text(tgt.value)))
        elif isinstance(tgt, ast.Name):
            if aug and self.flag_aug_name and env.get(tgt.id) == ELEM:
                self._flag(tgt, self.describe_mutation(tgt.id))
            elif not aug:
                env[tgt.id] = None

    def _scan_value(self, node: ast.expr, env: dict[str, Taint]) -> None:
        """Mutation sinks inside an expression statement / value."""
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            fn = call.func
            if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
                if self.taint(fn.value, env) == ELEM:
                    self._flag(call, self.describe_mutation(
                        expr_text(fn.value)) + f" via .{fn.attr}()")
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            idx = self.arg_mutators.get(name)
            if idx is not None and idx < len(call.args):
                if self.taint(call.args[idx], env) == ELEM:
                    self._flag(call, f"{name}() mutates its argument "
                                     f"{expr_text(call.args[idx])!r}, which "
                                     f"is a shared value")

    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            self.rule, self.f.path, getattr(node, "lineno", 0), message))
