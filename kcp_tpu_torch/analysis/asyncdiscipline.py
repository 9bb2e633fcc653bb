"""async-discipline: blocking calls in ``async def`` and awaits under
threading locks.

The serving loop is one asyncio thread shared by every request, watch
stream, controller tick, and health probe. A single ``time.sleep`` /
blocking ``open`` / synchronous socket call inside ``async def`` freezes
all of them for its duration — the store pool exists exactly because
one blocking backend call stalls the world. The second shape is
the asyncio+thread hybrid deadlock: ``await`` while holding a
``threading.Lock`` parks the coroutine with the lock held; any *thread*
that then blocks on that lock can never be released by the loop it is
blocking.
"""

from __future__ import annotations

import ast

from .base import FileChecker, Finding, SourceFile, attr_chain

#: dotted-call chains that block the calling thread
BLOCKING_CHAINS = (
    "time.sleep",
    "socket.create_connection",
    "socket.socket",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.delete",
    "requests.request",
)

THREADING_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
                        "BoundedSemaphore")


def _collect_threading_locks(tree: ast.Module) -> set[str]:
    """Names/attrs assigned from ``threading.Lock()`` (or the sanitizer's
    ``make_lock(...)`` factory) anywhere in the module."""
    locks: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        chain = attr_chain(node.value.func)
        is_lock = (
            (chain.startswith("threading.")
             and chain.split(".")[-1] in THREADING_LOCK_CTORS)
            or chain.endswith("make_lock")
        )
        if not is_lock:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                locks.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                locks.add(tgt.attr)
    return locks


def _body_nodes(fn: ast.AsyncFunctionDef) -> list[ast.AST]:
    """All nodes lexically inside the async function, not descending into
    nested function/lambda scopes (those run elsewhere)."""
    out: list[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            out.append(child)
            walk(child)

    for st in fn.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        out.append(st)
        walk(st)
    return out


class AsyncDisciplineChecker(FileChecker):
    name = "async-discipline"

    def check(self, f: SourceFile) -> list[Finding]:
        findings: list[Finding] = []
        locks = _collect_threading_locks(f.tree)
        for fn in ast.walk(f.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            nodes = _body_nodes(fn)
            for node in nodes:
                if isinstance(node, ast.Call):
                    self._check_call(node, fn, f, findings)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    self._check_with(node, fn, f, locks, findings)
        return findings

    def _check_call(self, call: ast.Call, fn: ast.AsyncFunctionDef,
                    f: SourceFile, findings: list[Finding]) -> None:
        chain = attr_chain(call.func)
        if isinstance(call.func, ast.Name) and call.func.id == "open":
            findings.append(Finding(
                self.name, f.path, call.lineno,
                f"blocking file open() inside async def {fn.name!r} — "
                f"offload to a thread (run_in_executor) or open before "
                f"entering the loop"))
            return
        for blocked in BLOCKING_CHAINS:
            if chain == blocked or chain.endswith("." + blocked):
                findings.append(Finding(
                    self.name, f.path, call.lineno,
                    f"blocking call {chain}() inside async def "
                    f"{fn.name!r} stalls the whole serving loop — use the "
                    f"asyncio equivalent or run_in_executor"))
                return

    def _check_with(self, node: ast.With | ast.AsyncWith,
                    fn: ast.AsyncFunctionDef, f: SourceFile,
                    locks: set[str], findings: list[Finding]) -> None:
        held = []
        for item in node.items:
            expr = item.context_expr
            name = ""
            if isinstance(expr, ast.Attribute):
                name = expr.attr
            elif isinstance(expr, ast.Name):
                name = expr.id
            if name in locks:
                held.append(name)
        if not held:
            return
        for inner in ast.walk(node):
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(inner, ast.Await):
                findings.append(Finding(
                    self.name, f.path, inner.lineno,
                    f"await while holding threading lock "
                    f"{held[0]!r} in async def {fn.name!r} — the "
                    f"asyncio+thread hybrid deadlock shape (park the "
                    f"lock-protected work in a thread, or use an "
                    f"asyncio.Lock)"))
                return
