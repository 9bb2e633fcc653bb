"""Runtime sanitizer (``KCP_SANITIZE=1``; the port's copy of
``kcp_tpu.analysis.sanitize``): the data contracts crash
loudly at the violating line instead of corrupting silently.

Enforcement surfaces, all off (near-zero cost: one module-attr
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
The port's copy carries the first two; lock-order tracking stays with
the reference (the port's locks come from ``utils/locks.make_lock``).

Enable with ``KCP_SANITIZE=1`` (read once), or programmatically via
:func:`enable` in tests.
"""

from __future__ import annotations

import copy as _copy
import os
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
