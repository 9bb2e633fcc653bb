"""ctypes loader for the work-queue half of the repo's native library.

The port's copy of the ``wq_*`` part of ``kcp_tpu/native/__init__.py``:
it builds ``native/libkcpnative.so`` at the repo root with ``make`` when
the library is missing or older than its sources, loads it, and
declares only the work-queue symbols that
:class:`kcp_tpu_torch.reconciler.fairqueue.FairWorkQueue` calls. If the
build or the load fails, :func:`load` returns ``None`` and callers fall
back to the pure-Python queue. ``KCP_TPU_NO_NATIVE=1`` forces that
fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from .utils.locks import make_lock

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")
_LIB_NAME = "libkcpnative.so"

_lock = make_lock("native.load")
_lib: ctypes.CDLL | None = None
_load_attempted = False


def _sources_newer_than_lib(lib_path: str) -> bool:
    lib_mtime = os.path.getmtime(lib_path)
    for fn in os.listdir(_NATIVE_DIR):
        if (fn.endswith((".cc", ".h"))
                and os.path.getmtime(os.path.join(_NATIVE_DIR, fn)) > lib_mtime):
            return True
    return False


def _declare(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
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
        lib_path = os.path.join(_NATIVE_DIR, _LIB_NAME)
        try:
            if not os.path.exists(lib_path) or _sources_newer_than_lib(lib_path):
                subprocess.run(
                    ["make", "-s", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
            # each CDLL object keeps its own function objects, so these
            # declarations never touch another loader's of the same file
            lib = ctypes.CDLL(lib_path)
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError, AttributeError):
            _lib = None
        return _lib
