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

``decide_and_match_sharded`` is the mesh form (it replaces
``kcp_tpu/ops/pallas_kernels.py:decide_and_match_sharded``, a
``shard_map`` of the Pallas kernel plus a ``psum`` of the counts): one
launch of the same kernel per row shard, on that shard's device, over the
shard's rows with its slot columns gathered to full S; the [C] counts of
shards that share a device accumulate into one zeroed buffer (the kernel
adds into the counts it is given), and the per-device sums are added on
the mesh's lead device. ``decide_and_match_sharded.launches`` counts
those per-shard launches.
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


def _launch(up_vals, up_exists, down_vals, down_exists, status_mask,
            pair_hashes, sel_hashes, counts):
    """Launch the kernel on the tensors' card; it ADDS each selector's
    hits into ``counts`` (int32 [C] on the same device). Returns
    (decision, upsync, launched); B=0 launches nothing."""
    _check(up_vals, up_exists, down_vals, down_exists, status_mask,
           pair_hashes, sel_hashes)
    dev = up_vals.device
    b, s = up_vals.shape
    l, c = pair_hashes.shape[1], sel_hashes.shape[0]
    if counts.device != dev or counts.dtype != torch.int32 or counts.shape != (c,):
        raise ValueError(f"decide_and_match: counts must be int32 [{c}] on {dev}")
    decision = torch.empty(b, dtype=torch.uint8, device=dev)
    upsync = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return decision, upsync, False
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
    return decision, upsync, True


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
    counts = torch.zeros(sel_hashes.shape[0], dtype=torch.int32, device=dev)
    decision, upsync, launched = _launch(
        up_vals, up_exists, down_vals, down_exists, status_mask,
        pair_hashes, sel_hashes, counts)
    decide_and_match.launches += launched
    return decision, upsync, counts


decide_and_match.launches = 0


def decide_and_match_shards(shards, lead: torch.device):
    """The per-shard core of :func:`decide_and_match_sharded`.

    ``shards`` holds one 7-tuple per row shard — (up_vals, up_exists,
    down_vals, down_exists, status_mask, pair_hashes, sel_hashes), each
    the shard's rows with full S, on the shard's device. Returns the
    per-shard decision and upsync lanes and the global [C] counts on
    ``lead``. CPU shards take the plain version; CUDA shards launch the
    kernel, accumulating into one zeroed [C] buffer per device."""
    acc: dict[torch.device, torch.Tensor] = {}
    decisions, upsyncs = [], []
    for args in shards:
        dev = args[0].device
        c = args[6].shape[0]
        if dev not in acc:
            acc[dev] = torch.zeros(c, dtype=torch.int32, device=dev)
        if dev.type == "cpu":
            d, u, cnt = decide_and_match_plain(*args)
            acc[dev] += cnt
        elif dev.type == "cuda":
            d, u, launched = _launch(*args, acc[dev])
            decide_and_match_sharded.launches += launched
        else:
            raise ValueError(f"decide_and_match_sharded: unsupported device {dev}")
        decisions.append(d)
        upsyncs.append(u)
    # the psum: partial counts of the other devices come to the lead
    # (stream-ordered copies) and add there
    parts = list(acc.values())
    counts = parts[0].to(lead)
    for part in parts[1:]:
        counts = counts + part.to(lead)
    return decisions, upsyncs, counts


def decide_and_match_sharded(mesh, up_vals, up_exists, down_vals, down_exists,
                             status_mask, pair_hashes, sel_hashes):
    """The fused pass on a sharded bucket: (decision u8 [B] and upsync
    bool [B] as row-sharded :class:`~kcp_tpu_torch.parallel.mesh.ShardedTensor`s,
    match counts int32 [C] on the mesh's lead device).

    Arguments are ShardedTensors laid out as ``shard_state`` lays out a
    state, or whole tensors, which are sharded here with that layout.
    Every row shard runs the kernel (or, on the CPU, the plain version)
    over its local rows with its slot columns gathered to full S. Any B
    works, including one that does not split evenly over the row shards:
    the split is uneven (``parallel.mesh.row_bounds``), never padded, so
    the reference's TPU gates (the XLA-lane fallback for a slots axis or
    for local rows off a multiple of 128) do not exist here."""
    from ..parallel import mesh as pm

    layouts = (pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS,
               pm.ROWS if status_mask.ndim == 2 else pm.SLOT_MASK,
               pm.FLAGS, pm.REPLICATED)
    args = [a if isinstance(a, pm.ShardedTensor) else pm.ShardedTensor.put(a, mesh, lay)
            for a, lay in zip((up_vals, up_exists, down_vals, down_exists,
                               status_mask, pair_hashes, sel_hashes), layouts)]
    shards = [tuple(a.row_block(i) for a in args)
              for i in range(pm.row_factor(mesh))]
    decisions, upsyncs, counts = decide_and_match_shards(shards, mesh.lead)
    b = args[0].shape[0]
    rows = [[d] for d in decisions]
    return (pm.ShardedTensor(mesh, pm.FLAGS, (b,), rows),
            pm.ShardedTensor(mesh, pm.FLAGS, (b,), [[u] for u in upsyncs]),
            counts)


decide_and_match_sharded.launches = 0
