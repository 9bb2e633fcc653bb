"""Runtime sanitizer (``KCP_SANITIZE=1``; the port's copy of
``kcp_tpu.analysis.sanitize``): the data contracts crash
loudly at the violating line instead of corrupting silently.

Three enforcement surfaces, all off (near-zero cost: one module-attr
read per site) unless enabled:

- **CoW snapshots freeze**: every object the store commits is deep-
  converted to :class:`FrozenDict`/:class:`FrozenList` proxies whose
  mutators raise :class:`ContractViolation` naming the contract. Since
  ``list`` results, informer caches, and watch ``Event`` payloads all
  share the stored snapshot, ANY in-place mutation by any consumer
  raises at the mutation site with a full traceback. ``get()`` (and any
  ``copy.deepcopy``) still hands back a plain, mutable copy — the
  sanctioned edit path is unchanged.
- **Frozen bytes verify on hit**: the encode-once caches re-encode on
  every cache hit and compare against the cached bytes; a scribbled or
  stale entry raises instead of serving corrupt bytes to every watcher.
  (Python ``bytes`` are immutable, so the attack surface is the cache
  *slots* — an overwritten ``_enc_line`` or ``_enc_bytes`` entry.)
- **Lock-order tracking**: locks built through :func:`make_lock` record
  held->acquired pairs per thread into one global digraph and assert the
  same acyclicity the static ``lock-order`` checker proves — but over
  *observed* orders, including cross-module ones the AST cannot see. A
  cycle raises at the second lock's acquire, before it can deadlock.

Enable with ``KCP_SANITIZE=1`` (read once), or programmatically via
:func:`enable` in tests. Every named lock of the port comes from
:func:`make_lock`.
"""

from __future__ import annotations

import copy as _copy
import os
import threading
from typing import Any, Iterable

__all__ = [
    "ContractViolation",
    "FrozenDict",
    "FrozenList",
    "enabled",
    "enable",
    "freeze",
    "thaw",
    "make_lock",
    "TrackedLock",
    "lock_edges",
    "reset_lock_tracking",
]


class ContractViolation(AssertionError):
    """A sanitizer-detected violation of a cross-layer contract. The
    message names the contract and the sanctioned alternative."""

    def __init__(self, contract: str, message: str):
        super().__init__(f"[{contract}] {message}")
        self.contract = contract


_ENABLED: bool | None = None


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("KCP_SANITIZE", "").lower() in (
            "1", "true", "on")
    return _ENABLED


def enable(on: bool = True) -> None:
    """Programmatic toggle (tests, chaos harnesses)."""
    global _ENABLED
    _ENABLED = bool(on)


# ---------------------------------------------------------------------------
# CoW snapshot freeze proxies
# ---------------------------------------------------------------------------

_COW_MSG = (
    "CoW snapshot mutated in place — list results, informer caches and "
    "watch Event payloads share references with storage "
    "(docs/operations.md 'CoW contract'); re-get() or copy.deepcopy "
    "before editing, then write through update()"
)


def _raise_cow(*_args: Any, **_kwargs: Any) -> Any:
    raise ContractViolation("cow-mutation", _COW_MSG)


class FrozenDict(dict):
    """A dict whose mutators raise; deep copies thaw to plain dicts so
    the sanctioned edit path (``get`` -> mutate -> ``update``) still
    hands out mutable objects."""

    __setitem__ = _raise_cow
    __delitem__ = _raise_cow
    setdefault = _raise_cow
    update = _raise_cow
    pop = _raise_cow
    popitem = _raise_cow
    clear = _raise_cow
    __ior__ = _raise_cow

    def __deepcopy__(self, memo: dict) -> dict:
        return {k: _copy.deepcopy(v, memo) for k, v in self.items()}

    def __reduce__(self):
        return (dict, (dict(self),))


class FrozenList(list):
    __setitem__ = _raise_cow
    __delitem__ = _raise_cow
    append = _raise_cow
    extend = _raise_cow
    insert = _raise_cow
    remove = _raise_cow
    pop = _raise_cow
    clear = _raise_cow
    sort = _raise_cow
    reverse = _raise_cow
    __iadd__ = _raise_cow
    __imul__ = _raise_cow

    def __deepcopy__(self, memo: dict) -> list:
        return [_copy.deepcopy(v, memo) for v in self]

    def __reduce__(self):
        return (list, (list(self),))


def freeze(obj: Any) -> Any:
    """Deep-convert dicts/lists to frozen proxies (scalars unchanged)."""
    if type(obj) is dict or type(obj) is FrozenDict:
        return FrozenDict((k, freeze(v)) for k, v in obj.items())
    if type(obj) is list or type(obj) is FrozenList:
        return FrozenList(freeze(v) for v in obj)
    return obj


def thaw(obj: Any) -> Any:
    """Deep-convert frozen proxies back to plain containers."""
    if isinstance(obj, dict):
        return {k: thaw(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [thaw(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Lock-order tracking
# ---------------------------------------------------------------------------

class _HeldStacks(threading.local):
    def __init__(self) -> None:
        self.stack: list[str] = []


_HELD = _HeldStacks()
_GRAPH_LOCK = threading.Lock()  # guards the edge graph only, never user code
_EDGES: dict[str, set[str]] = {}


def lock_edges() -> dict[str, set[str]]:
    """Snapshot of the observed acquisition graph (tests/debugging)."""
    with _GRAPH_LOCK:
        return {k: set(v) for k, v in _EDGES.items()}


def reset_lock_tracking() -> None:
    with _GRAPH_LOCK:
        _EDGES.clear()
    _HELD.stack.clear()


def _path_exists(src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst in the edge graph (caller holds _GRAPH_LOCK)."""
    seen = {src}
    stack: list[tuple[str, list[str]]] = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class TrackedLock:
    """A ``threading.Lock`` recording held->acquired pairs; acquiring in
    an order that closes a cycle in the global graph raises BEFORE the
    deadlock can happen."""

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def _check_order(self) -> None:
        held = _HELD.stack
        if not held:
            return
        with _GRAPH_LOCK:
            for h in held:
                if h == self.name:
                    continue
                outs = _EDGES.setdefault(h, set())
                if self.name in outs:
                    continue
                path = _path_exists(self.name, h)
                if path is not None:
                    raise ContractViolation(
                        "lock-order",
                        f"acquiring {self.name!r} while holding {h!r} "
                        f"inverts the established order "
                        f"{' -> '.join(path)} — two threads taking these "
                        f"in opposite orders deadlock; acquire locks in "
                        f"one global order")
                outs.add(self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _HELD.stack.append(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def make_lock(name: str) -> "threading.Lock | TrackedLock":
    """The lock factory for the port's locks: a plain ``threading.Lock``
    normally, a :class:`TrackedLock` under the sanitizer. The ``name``
    doubles as the lock's node id in both the runtime graph and the
    static ``lock-order`` checker, so the two passes agree."""
    if enabled():
        return TrackedLock(name)
    return threading.Lock()


# ---------------------------------------------------------------------------
# Frozen-bytes verification helpers (called from the encode caches)
# ---------------------------------------------------------------------------

def verify_bytes(cached: bytes, fresh: bytes, what: str) -> None:
    """Raise if a cached encoding no longer matches a fresh encode of
    its source snapshot — someone scribbled on the cache slot or mutated
    the snapshot behind the cache's back."""
    if cached != fresh:
        raise ContractViolation(
            "frozen-bytes",
            f"cached {what} diverged from a fresh encode "
            f"({len(cached)}B cached vs {len(fresh)}B fresh) — a cache "
            f"slot was overwritten or its snapshot mutated; cached bytes "
            f"are frozen shared state")


def freeze_iter(items: Iterable[Any]) -> list[Any]:
    """Freeze each element of an iterable (test helper)."""
    return [freeze(x) for x in items]
