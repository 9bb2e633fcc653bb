"""Hand-written CUDA kernels of the reconcile tick, and their plain
PyTorch versions.

``decide_and_match`` fuses the two row-major lanes of the reconcile step
— the spec/status three-way diff (:func:`~kcp_tpu_torch.ops.diff.sync_decisions`)
and the label-selector fan-out (:func:`~kcp_tpu_torch.ops.labelmatch.fanout_match`)
— into one pass over the resident mirrors. It replaces the Pallas TPU
kernel ``kcp_tpu/ops/pallas_kernels.py:decide_and_match``; the CUDA source
is ``kcp_tpu_torch/csrc/decide_match.cu`` (design and byte bound there).

Dispatch is by the device of the tensors:

- CUDA tensors launch the kernel, or raise (bad dtype, shape, layout,
  device, a build failure or a refused launch). There is no fallback.
- CPU tensors take :func:`decide_and_match_plain`, the un-fused
  composition, which is also what the kernel is checked against.

The kernel is compiled with ``nvcc`` at first use into
``build/kcp_tpu_torch/`` at the repo root (a plain C entry point, loaded
with ctypes) and rebuilt when its source is newer than the library.
``decide_and_match.launches`` counts kernel launches; nothing else
touches it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from ..utils.locks import make_lock
from .diff import sync_decisions
from .labelmatch import fanout_match

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "decide_match.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kcp_tpu_torch")
_LIB_PATH = os.path.join(BUILD_DIR, "libdecide_match.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = make_lock("cuda_kernels.build")
_lib: ctypes.CDLL | None = None
# what the last build did: seconds, compiler output (ptxas register and
# shared-memory report), or None when an up-to-date library was reused
build_info: dict = {}


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
            shutil.which("nvcc")]
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): cannot build "
                       "the decide_and_match kernel")


def build() -> str:
    """Compile ``csrc/decide_match.cu`` into the build directory unless an
    up-to-date library is already there; returns the library path."""
    with _build_lock:
        if (os.path.exists(_LIB_PATH)
                and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
            build_info.update(seconds=0.0, log=None)
            return _LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=(proc.stdout + proc.stderr).strip())
        return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.kcp_decide_match.argtypes = [vp, vp, vp, vp, vp, ll, vp, vp,
                                         vp, vp, vp, ll, ci, ci, ci, vp]
        lib.kcp_decide_match.restype = ci
        _lib = lib
    return _lib


def decide_and_match_plain(up_vals, up_exists, down_vals, down_exists,
                           status_mask, pair_hashes, sel_hashes):
    """The un-fused lanes: (decision u8 [B], upsync bool [B], match
    counts int32 [C] over resident up rows)."""
    d = sync_decisions(up_vals, up_exists, down_vals, down_exists, status_mask)
    match = fanout_match(pair_hashes, sel_hashes) & up_exists[:, None]
    return d.decision, d.status_upsync, match.sum(dim=0, dtype=torch.int32)


def _check(up_vals, up_exists, down_vals, down_exists, status_mask,
           pair_hashes, sel_hashes) -> None:
    named = {"up_vals": up_vals, "up_exists": up_exists,
             "down_vals": down_vals, "down_exists": down_exists,
             "status_mask": status_mask, "pair_hashes": pair_hashes,
             "sel_hashes": sel_hashes}
    dev = up_vals.device
    want = {"up_vals": torch.int32, "down_vals": torch.int32,
            "up_exists": torch.bool, "down_exists": torch.bool,
            "status_mask": torch.bool, "pair_hashes": torch.int32,
            "sel_hashes": torch.int32}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"decide_and_match: {name} on {t.device}, up_vals on {dev}")
        if t.dtype != want[name]:
            raise TypeError(f"decide_and_match: {name} is {t.dtype}, want {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"decide_and_match: {name} is not contiguous")
    if up_vals.ndim != 2:
        raise ValueError(f"decide_and_match: up_vals must be [B, S], got {tuple(up_vals.shape)}")
    b, s = up_vals.shape
    if down_vals.shape != (b, s):
        raise ValueError(f"decide_and_match: down_vals {tuple(down_vals.shape)} != {(b, s)}")
    for name in ("up_exists", "down_exists"):
        if named[name].shape != (b,):
            raise ValueError(f"decide_and_match: {name} must be [{b}]")
    if status_mask.shape not in ((s,), (b, s)):
        raise ValueError(f"decide_and_match: status_mask must be [S] or [B, S], "
                         f"got {tuple(status_mask.shape)}")
    if pair_hashes.ndim != 2 or pair_hashes.shape[0] != b:
        raise ValueError(f"decide_and_match: pair_hashes must be [B, L], "
                         f"got {tuple(pair_hashes.shape)}")
    if sel_hashes.ndim != 1:
        raise ValueError(f"decide_and_match: sel_hashes must be [C], "
                         f"got {tuple(sel_hashes.shape)}")


def decide_and_match(up_vals, up_exists, down_vals, down_exists, status_mask,
                     pair_hashes, sel_hashes):
    """Fused decision + fan-out: (decision u8 [B], upsync bool [B],
    match_counts int32 [C]).

    ``status_mask`` may be the bucket-wide [S] form or the serving core's
    per-row [B, S] form. Any B works, including ragged fleet sums."""
    dev = up_vals.device
    if dev.type == "cpu":
        return decide_and_match_plain(up_vals, up_exists, down_vals, down_exists,
                                      status_mask, pair_hashes, sel_hashes)
    if dev.type != "cuda":
        raise ValueError(f"decide_and_match: unsupported device {dev}")
    _check(up_vals, up_exists, down_vals, down_exists, status_mask,
           pair_hashes, sel_hashes)
    b, s = up_vals.shape
    l, c = pair_hashes.shape[1], sel_hashes.shape[0]
    decision = torch.empty(b, dtype=torch.uint8, device=dev)
    upsync = torch.empty(b, dtype=torch.bool, device=dev)
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    if b == 0:
        return decision, upsync, counts
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kcp_decide_match(
            up_vals.data_ptr(), down_vals.data_ptr(), up_exists.data_ptr(),
            down_exists.data_ptr(), status_mask.data_ptr(),
            s if status_mask.ndim == 2 else 0,
            pair_hashes.data_ptr(), sel_hashes.data_ptr(),
            decision.data_ptr(), upsync.data_ptr(), counts.data_ptr(),
            b, s, l, c, stream)
    if rc != 0:
        raise RuntimeError(f"decide_and_match: kernel launch failed with CUDA "
                           f"error {rc}")
    decide_and_match.launches += 1
    return decision, upsync, counts


decide_and_match.launches = 0
