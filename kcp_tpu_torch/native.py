"""ctypes loader for the repo's native library (the port's copy of
``kcp_tpu/native/__init__.py``).

It compiles the sources under ``native/`` at the repo root with ``g++``
(``native/Makefile``'s flags) into ``build/kcp_tpu_torch/`` when no
library built from these very sources and flags is there, loads it, and
declares the symbols the port calls: the work queue (``wq_*``,
:class:`kcp_tpu_torch.reconciler.fairqueue.FairWorkQueue`), the durable
WAL engine (``ws_*``, :class:`WalEngine`, the store's native backend) and
the slot-vocabulary encoder (``enc_*``, :class:`NativeBucket`, the fast
path of :class:`kcp_tpu_torch.ops.encode.BucketEncoder`, and its hashes,
:func:`fnv1a_native` and :func:`hash_value_native`) and the schema
tokenizer (``enc_tokenize_schemas`` and the ``kcptok`` extension, the two
native tiers of :func:`kcp_tpu_torch.ops.schemahash.tokenize_schemas`).
If the build or the load fails, :func:`load` returns ``None`` and every
caller falls back to its pure-Python path. ``KCP_TPU_NO_NATIVE=1`` forces
that fallback.

The loader never writes under ``native/``: the reference's loader runs
``make`` there, and processes of both packages would otherwise build the
same objects in place while others load them. A library's file name
carries a hash of the sources, the flags and (for the extension) the
interpreter's ABI, so a changed source builds anew whatever the files'
times say. Processes share one build through an ``flock`` on
``BUILD_DIR/native.lock``; each compiles to a file of its own and moves
it into place, so a library path that exists is whole.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import sysconfig
import time
from typing import Iterator

from .analysis.sanitize import make_lock

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_DIR, "native")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "kcp_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
# native/Makefile's OBJS; kcptok.cc is the extension's alone
_LIB_SOURCES = ("jsoncanon.cc", "walstore.cc", "encode.cc", "workqueue.cc")

_lock = make_lock("native.load")
_lib: ctypes.CDLL | None = None
_load_attempted = False
#: what each library's build did: {"path", "seconds"} (0.0 where a library
#: built from these very sources was reused; a wait for another process's
#: build counts), or {"error"} where the build or the load failed
build_info: dict[str, dict] = {}


def _source_key(*extra: str) -> str:
    """A hash of every ``*.cc`` and ``*.h`` under ``native/``, the flags
    and ``extra``."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_NATIVE_DIR)):
        if name.endswith((".cc", ".h")):
            h.update(name.encode() + b"\0")
            with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
                h.update(f.read())
    h.update("\0".join((*CXX_FLAGS, *extra)).encode())
    return h.hexdigest()[:16]


def _build(stem: str, sources: tuple, flags: tuple = (), abi: str = "") -> str:
    """The path of ``BUILD_DIR/<stem>-<key>.so``, compiled from ``sources``
    with ``CXX_FLAGS + flags`` unless it is there; raises where the
    compiler fails. The check and the build hold the build directory's
    lock, so one process builds and the others wait and load its file."""
    path = os.path.join(BUILD_DIR, f"{stem}-{_source_key(*flags, abi)}.so")
    if os.path.exists(path):
        build_info[stem] = {"path": path, "seconds": 0.0}
        return path
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                # the compiler's own temporaries stay in the build directory too
                subprocess.run(
                    ["g++", *CXX_FLAGS, *flags, "-o", tmp,
                     *(os.path.join(_NATIVE_DIR, s) for s in sources)],
                    check=True, capture_output=True, timeout=120,
                    env={**os.environ, "TMPDIR": BUILD_DIR})
                os.replace(tmp, path)
            finally:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(tmp)
    build_info[stem] = {"path": path, "seconds": time.perf_counter() - t0}
    return path


def _declare(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ws_open.restype = ctypes.c_void_p
    lib.ws_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ws_close.argtypes = [ctypes.c_void_p]
    lib.ws_last_error.restype = ctypes.c_char_p
    lib.ws_last_error.argtypes = [ctypes.c_void_p]
    lib.ws_put.restype = ctypes.c_int
    lib.ws_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
    lib.ws_del.restype = ctypes.c_int
    lib.ws_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
    lib.ws_get.restype = ctypes.c_int
    lib.ws_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.POINTER(u8p), u32p]
    lib.ws_rv.restype = ctypes.c_uint64
    lib.ws_rv.argtypes = [ctypes.c_void_p]
    lib.ws_count.restype = ctypes.c_uint64
    lib.ws_count.argtypes = [ctypes.c_void_p]
    lib.ws_flush.restype = ctypes.c_int
    lib.ws_flush.argtypes = [ctypes.c_void_p]
    lib.ws_batch_begin.restype = ctypes.c_int
    lib.ws_batch_begin.argtypes = [ctypes.c_void_p]
    lib.ws_batch_commit.restype = ctypes.c_int
    lib.ws_batch_commit.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ws_batch_abort.restype = ctypes.c_int
    lib.ws_batch_abort.argtypes = [ctypes.c_void_p]
    lib.ws_epoch.restype = ctypes.c_uint64
    lib.ws_epoch.argtypes = [ctypes.c_void_p]
    lib.ws_set_epoch.restype = ctypes.c_int
    lib.ws_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ws_set_rv.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ws_snapshot.restype = ctypes.c_int
    lib.ws_snapshot.argtypes = [ctypes.c_void_p]
    lib.ws_snapshot_begin.restype = ctypes.c_int
    lib.ws_snapshot_begin.argtypes = [ctypes.c_void_p]
    lib.ws_snapshot_add.restype = ctypes.c_int
    lib.ws_snapshot_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.c_char_p, ctypes.c_uint32]
    lib.ws_snapshot_commit.restype = ctypes.c_int
    lib.ws_snapshot_commit.argtypes = [ctypes.c_void_p]
    lib.ws_index_release.argtypes = [ctypes.c_void_p]
    lib.ws_scan.restype = ctypes.c_void_p
    lib.ws_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.ws_scan_next.restype = ctypes.c_int
    lib.ws_scan_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p), u32p,
                                 ctypes.POINTER(u8p), u32p]
    lib.ws_scan_free.argtypes = [ctypes.c_void_p]

    lib.enc_bucket_new.restype = ctypes.c_void_p
    lib.enc_bucket_new.argtypes = [ctypes.c_uint32]
    lib.enc_bucket_free.argtypes = [ctypes.c_void_p]
    lib.enc_bucket_encode.restype = ctypes.c_int
    lib.enc_bucket_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, u32p]
    lib.enc_bucket_nslots.restype = ctypes.c_uint32
    lib.enc_bucket_nslots.argtypes = [ctypes.c_void_p]
    lib.enc_bucket_path.restype = ctypes.c_int
    lib.enc_bucket_path.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_char_p), u32p]
    lib.enc_bucket_add_path.restype = ctypes.c_int
    lib.enc_bucket_add_path.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.enc_hash_value.restype = ctypes.c_uint32
    lib.enc_hash_value.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.enc_fnv1a.restype = ctypes.c_uint32
    lib.enc_fnv1a.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.enc_hash_pair.restype = ctypes.c_uint32
    lib.enc_hash_pair.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                  ctypes.c_size_t]
    lib.enc_tokenize_schemas.restype = ctypes.c_int
    lib.enc_tokenize_schemas.argtypes = [
        ctypes.c_char_p, u64p, ctypes.c_uint32, ctypes.c_uint32, u32p]
    lib.wq_new.restype = ctypes.c_void_p
    lib.wq_new.argtypes = []
    lib.wq_free.restype = None
    lib.wq_free.argtypes = [ctypes.c_void_p]
    lib.wq_add.restype = None
    lib.wq_add.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.wq_add_after.restype = None
    lib.wq_add_after.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_uint32, ctypes.c_double, ctypes.c_double]
    lib.wq_add_rate_limited.restype = ctypes.c_uint32
    lib.wq_add_rate_limited.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_uint32, ctypes.c_double]
    lib.wq_num_requeues.restype = ctypes.c_uint32
    lib.wq_num_requeues.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.wq_forget.restype = None
    lib.wq_forget.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.wq_promote.restype = ctypes.c_double
    lib.wq_promote.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.wq_drain.restype = ctypes.c_uint32
    lib.wq_drain.argtypes = [ctypes.c_void_p, ctypes.c_double, u64p, ctypes.c_uint32]
    lib.wq_done.restype = None
    lib.wq_done.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.wq_len.restype = ctypes.c_uint64
    lib.wq_len.argtypes = [ctypes.c_void_p]
    lib.wq_live.restype = ctypes.c_int
    lib.wq_live.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.wq_release.restype = ctypes.c_int
    lib.wq_release.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.wq_add_many.restype = None
    lib.wq_add_many.argtypes = [ctypes.c_void_p, u64p, u32p, ctypes.c_uint32]
    lib.wq_complete_many.restype = None
    lib.wq_complete_many.argtypes = [ctypes.c_void_p, u64p, u8p,
                                     ctypes.c_uint32, u8p]


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if os.environ.get("KCP_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        try:
            lib = ctypes.CDLL(_build("libkcpnative", _LIB_SOURCES))
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError, AttributeError) as e:
            build_info["libkcpnative"] = {"error": repr(e)}
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


class WalEngine:
    """Durable WAL storage engine handle (native walstore.cc).

    Keys and values are bytes; the store layers its
    ``/<resource>/<cluster>/<ns>/<name>`` scheme on top with NUL-joined
    key tuples so prefix scans follow the etcd range-scan idiom
    (docs/investigations/logical-clusters.md:70-74 in the reference).
    """

    def __init__(self, path: str, sync_every: int = 256):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.ws_open(path.encode(), sync_every)
        if not self._h:
            raise OSError(f"ws_open({path!r}) failed")

    def put(self, key: bytes, val: bytes, rv: int) -> None:
        if self._lib.ws_put(self._h, key, len(key), val, len(val), rv) != 0:
            raise OSError(self._lib.ws_last_error(self._h).decode())

    def delete(self, key: bytes, rv: int) -> None:
        if self._lib.ws_del(self._h, key, len(key), rv) != 0:
            raise OSError(self._lib.ws_last_error(self._h).decode())

    def get(self, key: bytes) -> bytes | None:
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_uint32()
        if self._lib.ws_get(self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen)):
            return ctypes.string_at(val, vlen.value)
        return None

    @property
    def rv(self) -> int:
        return self._lib.ws_rv(self._h)

    @property
    def epoch(self) -> int:
        """Replication epoch persisted in the log (0 = never stamped)."""
        return self._lib.ws_epoch(self._h)

    def set_epoch(self, epoch: int) -> None:
        """Durably stamp a replication epoch (fsynced before return —
        fences and promotions must not be lost to a crash)."""
        if self._lib.ws_set_epoch(self._h, epoch) != 0:
            raise OSError(self._lib.ws_last_error(self._h).decode())

    def set_rv(self, rv: int) -> None:
        """Advance the RV watermark without a mutation record (snapshot
        resync: objects arrive with their own RVs, the barrier carries
        the authoritative watermark)."""
        self._lib.ws_set_rv(self._h, rv)

    def __len__(self) -> int:
        return self._lib.ws_count(self._h)

    def append_batch(self, ops, fsync: bool = False) -> None:
        """Append one group-commit window of records as ONE buffered
        write + at most one fsync. ``ops`` is an iterable of
        ``(key, val, rv)`` tuples — ``val is None`` means delete. With
        ``fsync=False`` the engine's ``sync_every`` batching still
        applies (the KCP_WAL_SYNC=flush policy); a failed commit leaves
        NONE of the window's records in the log."""
        lib = self._lib
        if lib.ws_batch_begin(self._h) != 0:
            raise OSError(lib.ws_last_error(self._h).decode())
        try:
            for key, val, rv in ops:
                if val is None:
                    self.delete(key, rv)
                else:
                    self.put(key, val, rv)
        except BaseException:
            lib.ws_batch_abort(self._h)
            raise
        if lib.ws_batch_commit(self._h, 1 if fsync else 0) != 0:
            raise OSError(lib.ws_last_error(self._h).decode())

    def flush(self) -> None:
        if self._lib.ws_flush(self._h) != 0:
            raise OSError("fsync failed")

    def snapshot(self) -> None:
        if self._lib.ws_snapshot(self._h) != 0:
            raise OSError("snapshot failed")

    def snapshot_stream(self, items) -> None:
        """Compact by streaming (key, value) pairs from the caller —
        used in journal-only mode where the engine keeps no value copy."""
        if self._lib.ws_snapshot_begin(self._h) != 0:
            raise OSError("snapshot begin failed")
        for key, val in items:
            if self._lib.ws_snapshot_add(self._h, key, len(key), val, len(val)) != 0:
                raise OSError("snapshot add failed")
        if self._lib.ws_snapshot_commit(self._h) != 0:
            raise OSError("snapshot commit failed")

    def release_index(self) -> None:
        """Switch to journal-only mode: drop the engine's in-memory copy
        (the host holds the authoritative objects; get/scan go dark)."""
        self._lib.ws_index_release(self._h)

    def scan(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        cur = self._lib.ws_scan(self._h, prefix, len(prefix))
        try:
            key = ctypes.POINTER(ctypes.c_uint8)()
            val = ctypes.POINTER(ctypes.c_uint8)()
            klen = ctypes.c_uint32()
            vlen = ctypes.c_uint32()
            while self._lib.ws_scan_next(cur, ctypes.byref(key), ctypes.byref(klen),
                                         ctypes.byref(val), ctypes.byref(vlen)):
                yield ctypes.string_at(key, klen.value), ctypes.string_at(val, vlen.value)
        finally:
            self._lib.ws_scan_free(cur)

    def close(self) -> None:
        if self._h:
            self._lib.ws_close(self._h)
            self._h = None


class NativeBucket:
    """Native slot-vocabulary encoder (twin of ops.encode.BucketEncoder)."""

    OVERFLOW = -1

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.capacity = capacity
        self._h = lib.enc_bucket_new(capacity)

    def encode_json(self, json_bytes: bytes, out) -> int:
        """Encode one object's JSON into out (uint32[capacity] numpy).

        Returns 0 ok, -1 overflow, -2/-3 parse errors.
        """
        import numpy as np

        if out.size < self.capacity:
            raise ValueError(
                f"out has {out.size} elements; bucket capacity is {self.capacity}"
            )
        direct = out.flags["C_CONTIGUOUS"] and out.dtype == np.uint32
        buf = out if direct else np.zeros(self.capacity, dtype=np.uint32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        rc = self._lib.enc_bucket_encode(self._h, json_bytes, len(json_bytes), ptr)
        if not direct and rc == 0:
            out[: self.capacity] = buf
        return rc

    @property
    def nslots(self) -> int:
        return self._lib.enc_bucket_nslots(self._h)

    def slot_paths(self) -> list[str]:
        out = []
        path = ctypes.c_char_p()
        plen = ctypes.c_uint32()
        for slot in range(self.nslots):
            if self._lib.enc_bucket_path(self._h, slot, ctypes.byref(path), ctypes.byref(plen)):
                out.append(path.value[:plen.value].decode())
        return out

    def add_path(self, path: str) -> int:
        return self._lib.enc_bucket_add_path(self._h, path.encode(), len(path.encode()))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.enc_bucket_free(self._h)
        except Exception:
            pass


def hash_value_native(json_bytes: bytes) -> int:
    lib = load()
    assert lib is not None
    return lib.enc_hash_value(json_bytes, len(json_bytes))


def fnv1a_native(data: bytes, seed: int = 0x811C9DC5) -> int:
    lib = load()
    assert lib is not None
    return lib.enc_fnv1a(data, len(data), seed)


_tok_mod = None
_tok_tried = False


def load_tokenizer():
    """Load (building if needed) the ``kcptok`` CPython extension, or None.

    Separate from :func:`load` because the extension needs Python's
    headers at build time; its absence must not disable the main library.
    None means callers use the next tier down (the JSON-blob native path,
    then the Python walk).
    """
    global _tok_mod, _tok_tried
    if os.environ.get("KCP_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _tok_tried:
            return _tok_mod
        _tok_tried = True
        try:
            # compiled against THIS interpreter's headers and named by its ABI
            path = _build("kcptok", ("kcptok.cc",),
                          (f"-I{sysconfig.get_paths()['include']}",),
                          sysconfig.get_config_var("SOABI") or "")
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader("kcptok", path)
            spec = importlib.util.spec_from_loader("kcptok", loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _tok_mod = mod
        except Exception as e:  # noqa: BLE001 — any failure means the next tier
            build_info["kcptok"] = {"error": repr(e)}
            _tok_mod = None
        return _tok_mod


def tokenize_schemas_native(blobs: list[bytes], max_tokens: int):
    """Tokenize a batch of canonical-JSON schemas in one native call.

    Returns a ``[len(blobs), max_tokens]`` uint32 numpy array, or None
    when the library is unavailable or any blob fails to parse (callers
    fall back to the Python walk).
    """
    lib = load()
    if lib is None:
        return None
    import numpy as np

    n = len(blobs)
    if n == 0:
        return np.zeros((0, max_tokens), dtype=np.uint32)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    lengths = np.fromiter((len(b) for b in blobs), dtype=np.uint64, count=n)
    np.cumsum(lengths, out=offsets[1:])
    data = b"".join(blobs)
    out = np.empty((n, max_tokens), dtype=np.uint32)
    rc = lib.enc_tokenize_schemas(
        data,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        max_tokens,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out if rc == 0 else None
