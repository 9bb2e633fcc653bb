"""lock-order: extract the lock acquisition graph, fail on cycles.

The codebase mixes asyncio with real threads (store-I/O pool, applier
pool, REST clients, the profiler), synchronized by a handful of
``threading.Lock``s. Deadlock needs two locks taken in opposite orders
on two threads — a property no unit test reliably exercises. This
checker builds the static acquisition graph: a ``with lockA:`` body that
acquires (directly, or via a same-class method call one level deep)
``lockB`` adds edge A→B; any cycle in the union graph across the repo is
a potential deadlock and fails the lint. The runtime sanitizer
(``KCP_SANITIZE=1``) asserts the same acyclicity over *observed*
acquisition pairs, catching orders the static pass cannot see.

Lock identity: ``module.Class.attr`` for ``self.x = threading.Lock()``,
``module.name`` for module-level locks — and the literal name for locks
made through ``sanitize.make_lock("...")``, so static nodes line up with
the runtime tracker's.
"""

from __future__ import annotations

import ast
import os

from .base import Finding, RepoChecker, SourceFile, attr_chain
from .asyncdiscipline import THREADING_LOCK_CTORS


def _modname(path: str) -> str:
    return os.path.splitext(path)[0].replace("/", ".")


def _lock_ctor_name(value: ast.expr) -> str | None:
    """For ``threading.Lock()`` returns ""; for ``make_lock("x")``
    returns "x"; else None."""
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func)
    if (chain.startswith("threading.")
            and chain.split(".")[-1] in THREADING_LOCK_CTORS):
        return ""
    if chain.endswith("make_lock"):
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
        return ""
    return None


class _ClassLocks:
    def __init__(self) -> None:
        self.attr_ids: dict[str, str] = {}  # attr -> lock node id


class LockOrderChecker(RepoChecker):
    name = "lock-order"

    def check_repo(self, files: list[SourceFile],
                   repo_root: str) -> list[Finding]:
        findings: list[Finding] = []
        edges: dict[str, dict[str, tuple[str, int]]] = {}
        # method -> set of lock ids it acquires anywhere (for one-level
        # call propagation inside a held region)
        method_locks: dict[tuple[str, str, str], set[str]] = {}
        per_class: dict[tuple[str, str], _ClassLocks] = {}

        for f in files:
            mod = _modname(f.path)
            for cls in [n for n in ast.walk(f.tree)
                        if isinstance(n, ast.ClassDef)]:
                cl = per_class.setdefault((mod, cls.name), _ClassLocks())
                for node in ast.walk(cls):
                    if not isinstance(node, ast.Assign):
                        continue
                    named = _lock_ctor_name(node.value)
                    if named is None:
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            cl.attr_ids[tgt.attr] = (
                                named or f"{mod}.{cls.name}.{tgt.attr}")
            # module-level locks
            mod_locks: dict[str, str] = {}
            for node in f.tree.body:
                if isinstance(node, ast.Assign):
                    named = _lock_ctor_name(node.value)
                    if named is None:
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            mod_locks[tgt.id] = named or f"{mod}.{tgt.id}"
            f._mod_locks = mod_locks  # type: ignore[attr-defined]

        # pass 2: acquisition scan
        for f in files:
            mod = _modname(f.path)
            mod_locks = f._mod_locks  # type: ignore[attr-defined]
            for cls_name, fn in self._functions(f.tree):
                cl = per_class.get((mod, cls_name or ""), _ClassLocks())
                acquired: set[str] = set()
                self._scan(fn.body, [], cl, mod_locks, f, edges, acquired,
                           calls_out=[])
                method_locks[(mod, cls_name or "", fn.name)] = acquired

        # pass 3: one-level propagation through same-class calls made
        # while holding a lock
        for f in files:
            mod = _modname(f.path)
            mod_locks = f._mod_locks  # type: ignore[attr-defined]
            for cls_name, fn in self._functions(f.tree):
                cl = per_class.get((mod, cls_name or ""), _ClassLocks())
                calls_out: list[tuple[str, str, int]] = []
                self._scan(fn.body, [], cl, mod_locks, f, {}, set(),
                           calls_out=calls_out)
                for held, callee, lineno in calls_out:
                    for lock in method_locks.get((mod, cls_name or "", callee),
                                                 ()):
                        if lock != held:
                            edges.setdefault(held, {}).setdefault(
                                lock, (f.path, lineno))

        findings.extend(self._find_cycles(edges))
        return findings

    @staticmethod
    def _functions(tree: ast.Module
                   ) -> "list[tuple[str | None, ast.FunctionDef | ast.AsyncFunctionDef]]":
        out: list = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        out.append((node.name, sub))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((None, node))
        return out

    def _lock_id(self, expr: ast.expr, cl: _ClassLocks,
                 mod_locks: dict[str, str]) -> str | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return cl.attr_ids.get(expr.attr)
        if isinstance(expr, ast.Name):
            return mod_locks.get(expr.id)
        return None

    def _scan(self, stmts: list, held: list[str], cl: _ClassLocks,
              mod_locks: dict[str, str], f: SourceFile,
              edges: dict[str, dict[str, tuple[str, int]]],
              acquired: set[str],
              calls_out: list[tuple[str, str, int]]) -> None:
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                new = []
                for item in st.items:
                    lock = self._lock_id(item.context_expr, cl, mod_locks)
                    if lock is not None:
                        acquired.add(lock)
                        for h in held:
                            if h != lock:
                                edges.setdefault(h, {}).setdefault(
                                    lock, (f.path, st.lineno))
                        new.append(lock)
                self._scan(st.body, held + new, cl, mod_locks, f, edges,
                           acquired, calls_out)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            else:
                # record same-class calls made while holding a lock
                if held:
                    for call in ast.walk(st):
                        if isinstance(call, ast.Call) and \
                                isinstance(call.func, ast.Attribute) and \
                                isinstance(call.func.value, ast.Name) and \
                                call.func.value.id == "self":
                            for h in held:
                                calls_out.append(
                                    (h, call.func.attr, call.lineno))
                for child_body in self._sub_bodies(st):
                    self._scan(child_body, held, cl, mod_locks, f, edges,
                               acquired, calls_out)

    @staticmethod
    def _sub_bodies(st: ast.stmt) -> "list[list[ast.stmt]]":
        out: list = []
        for attr in ("body", "orelse", "finalbody"):
            body = getattr(st, attr, None)
            if body and isinstance(body, list) and \
                    isinstance(body[0], ast.stmt):
                out.append(body)
        for h in getattr(st, "handlers", []) or []:
            out.append(h.body)
        return out

    def _find_cycles(self, edges: dict[str, dict[str, tuple[str, int]]]
                     ) -> list[Finding]:
        findings: list[Finding] = []
        WHITE, GREY, BLACK = 0, 1, 2
        color: dict[str, int] = {}
        stack: list[str] = []
        reported: set[frozenset[str]] = set()

        def visit(n: str) -> None:
            color[n] = GREY
            stack.append(n)
            for m in edges.get(n, {}):
                c = color.get(m, WHITE)
                if c == GREY:
                    cycle = stack[stack.index(m):] + [m]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        path, line = edges[n][m]
                        findings.append(Finding(
                            self.name, path, line,
                            "lock acquisition cycle: "
                            + " -> ".join(cycle)
                            + " (two threads taking these in opposite "
                              "order deadlock)"))
                elif c == WHITE:
                    visit(m)
            stack.pop()
            color[n] = BLACK

        for n in list(edges):
            if color.get(n, WHITE) == WHITE:
                visit(n)
        return findings
