"""Hand-written CUDA kernels of the reconcile tick, and their plain
PyTorch versions.

``decide_and_match`` fuses the two row-major lanes of the reconcile step
— the spec/status three-way diff (:func:`~kcp_tpu_torch.ops.diff.sync_decisions`)
and the label-selector fan-out (:func:`~kcp_tpu_torch.ops.labelmatch.fanout_match`)
— into one pass over the resident mirrors. Its fleet form (``seg_ids=``,
``seg_capacity=``) also returns the fleet step's per-segment live-row
counts. It replaces the Pallas TPU kernel
``kcp_tpu/ops/pallas_kernels.py:decide_and_match``; the CUDA source is
``kcp_tpu_torch/csrc/decide_match.cu`` (design and byte bound there).

Dispatch is by the device of the tensors:

- CUDA tensors launch the kernel, or raise (bad dtype, shape, layout,
  device, a build failure or a refused launch). There is no fallback.
- CPU tensors take :func:`decide_and_match_plain`, the un-fused
  composition, which is also what the kernel is checked against.

The kernel runs a persistent grid over row tiles fed by bulk copies into
a ring in shared memory; :func:`_tile_plan` makes the plan (tile rows,
ring depth, grid, bulk or plain-load path) on the host and the kernel
takes it as arguments. ``last_plan`` holds the plan of the latest launch.

The kernel is compiled with ``nvcc`` at first use into
``build/kcp_tpu_torch/`` at the repo root (a plain C entry point, loaded
with ctypes). The library's file name carries a hash of every file under
``csrc/`` and of ``NVCC_FLAGS``, so a change to any of them builds anew.
``decide_and_match.launches`` counts kernel launches; nothing else
touches it.

``decide_and_match_sharded`` is the mesh form (it replaces
``kcp_tpu/ops/pallas_kernels.py:decide_and_match_sharded``, a
``shard_map`` of the Pallas kernel plus a ``psum`` of the counts): one
launch of the same kernel per row shard, on that shard's device, over the
shard's rows with its slot columns gathered to full S; the [C] (and
[seg_capacity]) counts of shards that share a device accumulate into one
zeroed buffer (the kernel adds into the counts it is given), and the
per-device sums are added on the mesh's lead device.
``decide_and_match_sharded.launches`` counts those per-shard launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

import torch

from ..utils.locks import make_lock
from .diff import sync_decisions
from .labelmatch import fanout_match

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kcp_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The plan's budget (H100: 228 KB of shared memory per SM, 227 KB at most
# for one block, 1 KB of each block's share kept by the system).
SMEM_PER_SM = 233472
SMEM_BLOCK_MAX = 232448
SMEM_RESERVED = 1024
# Chosen by a sweep at the serving shape on an H100 (PERF.md §6,
# ``python3 -m kcp_tpu_torch.chip_probe sweep``): a second block per SM
# beat a deeper ring for a lone block, whose own consumers pace it;
# larger tiles, deeper rings or a third block gained nothing.
STAGE_TARGET = 24 * 1024  # bytes of one ring stage the tile size aims at
MAX_STAGES = 2
BLOCKS_PER_SM = 2

_build_lock = make_lock("cuda_kernels.build")
_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}
# what the last build did: seconds, compiler output (ptxas register and
# shared-memory report), or None when an up-to-date library was reused
build_info: dict = {}
last_plan: "TilePlan | None" = None


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
            shutil.which("nvcc")]
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): cannot build "
                       "the decide_and_match kernel")


def _source_key() -> str:
    """A hash of every file under ``csrc/`` and of the compiler flags."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC)):
        path = os.path.join(_CSRC, name)
        if os.path.isfile(path):
            h.update(name.encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the ``csrc/*.cu`` sources into the build directory unless a
    library built from these very sources and flags is already there;
    returns the library path."""
    with _build_lock:
        lib = os.path.join(BUILD_DIR, f"libdecide_match-{_source_key()}.so")
        if os.path.exists(lib):
            build_info.update(seconds=0.0, log=None)
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        sources = sorted(os.path.join(_CSRC, n) for n in os.listdir(_CSRC)
                         if n.endswith(".cu"))
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=(proc.stdout + proc.stderr).strip())
        return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.kcp_decide_match.argtypes = [vp, vp, vp, vp, vp, ll, vp, vp, vp,
                                         vp, vp, vp, vp, ll, ci, ci, ci, ci,
                                         ci, ci, ll, ci, vp]
        lib.kcp_decide_match.restype = ci
        lib.kcp_sm_count.argtypes = [ctypes.POINTER(ci)]
        lib.kcp_sm_count.restype = ci
        _lib = lib
    return _lib


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _sm_count(dev: torch.device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount), once per card."""
    idx = _index(dev)
    if idx not in _sms:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = _load().kcp_sm_count(ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"decide_and_match: SM count query failed with CUDA error {rc}")
        _sms[idx] = out.value
    return _sms[idx]


# ---------------------------------------------------------------------------
# The tile plan
# ---------------------------------------------------------------------------

# the kernel's inputs in the order of a stage's byte ranges
RANGES = ("up_vals", "down_vals", "status_mask", "up_exists", "down_exists",
          "pair_hashes", "seg_ids")


class TilePlan(NamedTuple):
    tile: int  # T rows per tile, a multiple of 16
    stages: int  # ring depth in shared memory (0 on the plain-load path)
    grid: int  # persistent blocks
    bulk: bool  # full tiles come through bulk copies
    bulk_tiles: int  # tiles [0, bulk_tiles) are bulk-copied
    tiles: int  # ceil(B / T); the rest go through the plain-load path
    tail_rows: int  # rows the plain-load path reads
    ranges: tuple  # bytes of each input per tile, in RANGES order (0: not loaded)
    smem: int  # shared-memory bytes per block


def _smem_bytes(t: int, s: int, c: int, cap: int, bmask: bool, stages: int,
                stage_bytes: int) -> int:
    """A block's shared memory (``smem_layout`` in the CUDA source):
    mbarriers, two [T] row-flag buffers, selectors and the [C] and [cap]
    histograms, the bucket-wide mask, then the ring."""
    head = 128 + 8 * t + 8 * c + 4 * cap + (s if bmask else 0)
    return -(-head // 128) * 128 + stages * stage_bytes


def _tile_plan(b: int, s: int, l: int, c: int, mask_per_row: bool,
               ptrs: tuple, fleet: bool, seg_capacity: int = 0,
               sms: int = 132) -> TilePlan:
    """The launch plan for B rows of S slots, L pair hashes, C selectors.

    ``ptrs`` are the inputs' device addresses in :data:`RANGES` order. A
    stage holds T rows of every input, T the largest multiple of 16 whose
    stage stays within ``STAGE_TARGET`` bytes; the ring holds up to
    ``MAX_STAGES`` of them within the block's share of shared memory
    (``BLOCKS_PER_SM`` blocks share an SM). Full tiles take the bulk path
    when every loaded input starts on a 16-byte boundary and two stages
    fit; the last partial tile, and every tile otherwise, take the
    plain-load path."""
    row_bytes = _row_bytes(s, l, mask_per_row, fleet)
    aligned = all(p % 16 == 0 for p, n in zip(ptrs, row_bytes) if n)
    return _plan(b, s, l, c, bool(mask_per_row), aligned, bool(fleet),
                 seg_capacity if fleet else 0, sms)


def _row_bytes(s: int, l: int, mask_per_row: bool, fleet: bool) -> tuple:
    return (4 * s, 4 * s, s if mask_per_row else 0, 1, 1, 4 * l, 4 if fleet else 0)


@functools.lru_cache(maxsize=256)
def _plan(b, s, l, c, per_row, aligned, fleet, cap, sms) -> TilePlan:
    row_bytes = _row_bytes(s, l, per_row, fleet)
    per_tile_row = sum(row_bytes)
    budget = min(SMEM_BLOCK_MAX, SMEM_PER_SM // BLOCKS_PER_SM) - SMEM_RESERVED
    if _smem_bytes(16, s, c, cap, False, 0, 0) > budget:
        raise ValueError(f"decide_and_match: C={c} selectors and seg_capacity={cap} "
                         f"do not fit the kernel's shared memory")
    t = max(16, STAGE_TARGET // per_tile_row // 16 * 16)
    free = budget - _smem_bytes(t, s, c, cap, not per_row, 0, 0)
    stages = min(MAX_STAGES, max(0, free) // (t * per_tile_row))
    bulk = aligned and stages >= 2 and b >= t
    if not bulk:
        stages = 0
    tiles = -(-b // t)
    bulk_tiles = b // t if bulk else 0
    return TilePlan(
        tile=t, stages=stages, grid=max(1, min(sms * BLOCKS_PER_SM, tiles)), bulk=bulk,
        bulk_tiles=bulk_tiles, tiles=tiles, tail_rows=b - bulk_tiles * t,
        ranges=tuple(n * t for n in row_bytes),
        smem=_smem_bytes(t, s, c, cap, bulk and not per_row, stages, t * per_tile_row))


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def segment_counts_plain(seg_ids: torch.Tensor, up_exists: torch.Tensor,
                         seg_capacity: int) -> torch.Tensor:
    """int32 [seg_capacity]: resident up rows per segment. A negative id
    counts from the end (id + cap); ids outside [0, cap) drop, as the
    reference's drop-mode add does."""
    cap = seg_capacity
    seg = torch.where(seg_ids < 0, seg_ids + cap, seg_ids)
    seg = torch.where((seg >= 0) & (seg < cap), seg, cap)
    counts = torch.zeros(cap + 1, dtype=torch.int32, device=seg_ids.device)
    counts.index_add_(0, seg.long(), up_exists.to(torch.int32))
    return counts[:cap]


def decide_and_match_plain(up_vals, up_exists, down_vals, down_exists,
                           status_mask, pair_hashes, sel_hashes,
                           seg_ids=None, seg_capacity=None):
    """The un-fused lanes: (decision u8 [B], upsync bool [B], match
    counts int32 [C] over resident up rows), and with ``seg_ids`` the
    per-segment counts int32 [seg_capacity] as a fourth output."""
    d = sync_decisions(up_vals, up_exists, down_vals, down_exists, status_mask)
    match = fanout_match(pair_hashes, sel_hashes) & up_exists[:, None]
    out = (d.decision, d.status_upsync, match.sum(dim=0, dtype=torch.int32))
    if seg_ids is None:
        return out
    return (*out, segment_counts_plain(seg_ids, up_exists, seg_capacity))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _check(up_vals, up_exists, down_vals, down_exists, status_mask,
           pair_hashes, sel_hashes, seg_ids=None) -> None:
    named = {"up_vals": up_vals, "up_exists": up_exists,
             "down_vals": down_vals, "down_exists": down_exists,
             "status_mask": status_mask, "pair_hashes": pair_hashes,
             "sel_hashes": sel_hashes}
    if seg_ids is not None:
        named["seg_ids"] = seg_ids
    dev = up_vals.device
    want = {"up_vals": torch.int32, "down_vals": torch.int32,
            "up_exists": torch.bool, "down_exists": torch.bool,
            "status_mask": torch.bool, "pair_hashes": torch.int32,
            "sel_hashes": torch.int32, "seg_ids": torch.int32}
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
    for name in ("up_exists", "down_exists", "seg_ids"):
        if name in named and named[name].shape != (b,):
            raise ValueError(f"decide_and_match: {name} must be [{b}], "
                             f"got {tuple(named[name].shape)}")
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
            pair_hashes, sel_hashes, counts, seg_ids=None, seg_counts=None):
    """Launch the kernel on the tensors' card; it ADDS each selector's
    hits into ``counts`` (int32 [C] on the same device) and, with
    ``seg_ids``, each segment's resident up rows into ``seg_counts``
    (int32 [seg_capacity]). Returns (decision, upsync, launched); B=0
    launches nothing."""
    global last_plan
    _check(up_vals, up_exists, down_vals, down_exists, status_mask,
           pair_hashes, sel_hashes, seg_ids)
    dev = up_vals.device
    b, s = up_vals.shape
    l, c = pair_hashes.shape[1], sel_hashes.shape[0]
    if counts.device != dev or counts.dtype != torch.int32 or counts.shape != (c,):
        raise ValueError(f"decide_and_match: counts must be int32 [{c}] on {dev}")
    fleet = seg_ids is not None
    if fleet and (seg_counts is None or seg_counts.device != dev
                  or seg_counts.dtype != torch.int32 or seg_counts.ndim != 1):
        raise ValueError(f"decide_and_match: seg_counts must be int32 [seg_capacity] on {dev}")
    cap = seg_counts.shape[0] if fleet else 0
    decision = torch.empty(b, dtype=torch.uint8, device=dev)
    upsync = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return decision, upsync, False
    lib = _load()
    seg_ptr = seg_ids.data_ptr() if fleet else None
    ptrs = (up_vals.data_ptr(), down_vals.data_ptr(), status_mask.data_ptr(),
            up_exists.data_ptr(), down_exists.data_ptr(), pair_hashes.data_ptr(),
            seg_ptr or 0)
    plan = last_plan = _tile_plan(b, s, l, c, status_mask.ndim == 2, ptrs, fleet, cap,
                                  _sm_count(dev))
    up_p, down_p, mask_p, upe_p, dne_p, pair_p, _ = ptrs
    idx = _index(dev)
    # switching the current device costs more host time than the launch
    # itself, so only a launch on another card switches
    switch = idx != torch.cuda.current_device()
    with torch.cuda.device(idx) if switch else contextlib.nullcontext():
        rc = lib.kcp_decide_match(
            up_p, down_p, upe_p, dne_p, mask_p, s if status_mask.ndim == 2 else 0,
            pair_p, sel_hashes.data_ptr(), seg_ptr,
            decision.data_ptr(), upsync.data_ptr(), counts.data_ptr(),
            seg_counts.data_ptr() if fleet else None,
            b, s, l, c, cap, plan.tile, plan.stages, plan.bulk_tiles, plan.grid,
            torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decide_and_match: kernel launch failed with CUDA "
                           f"error {rc}")
    return decision, upsync, True


def _seg_capacity(seg_ids, seg_capacity) -> int | None:
    if seg_ids is None:
        return None
    if seg_capacity is None or int(seg_capacity) < 0:
        raise ValueError("decide_and_match: seg_ids needs seg_capacity >= 0")
    return int(seg_capacity)


def decide_and_match(up_vals, up_exists, down_vals, down_exists, status_mask,
                     pair_hashes, sel_hashes, seg_ids=None, seg_capacity=None):
    """Fused decision + fan-out: (decision u8 [B], upsync bool [B],
    match_counts int32 [C]).

    The fleet form: with ``seg_ids`` (int32 [B]) and ``seg_capacity``, a
    fourth output, the int32 [seg_capacity] count of resident up rows per
    segment (:func:`segment_counts_plain`).

    ``status_mask`` may be the bucket-wide [S] form or the serving core's
    per-row [B, S] form. Any B works, including ragged fleet sums."""
    cap = _seg_capacity(seg_ids, seg_capacity)
    dev = up_vals.device
    if dev.type == "cpu":
        return decide_and_match_plain(up_vals, up_exists, down_vals, down_exists,
                                      status_mask, pair_hashes, sel_hashes,
                                      seg_ids, cap)
    if dev.type != "cuda":
        raise ValueError(f"decide_and_match: unsupported device {dev}")
    counts = torch.zeros(sel_hashes.shape[0], dtype=torch.int32, device=dev)
    seg_counts = None if cap is None else torch.zeros(cap, dtype=torch.int32, device=dev)
    decision, upsync, launched = _launch(
        up_vals, up_exists, down_vals, down_exists, status_mask,
        pair_hashes, sel_hashes, counts, seg_ids, seg_counts)
    decide_and_match.launches += launched
    if seg_counts is None:
        return decision, upsync, counts
    return decision, upsync, counts, seg_counts


decide_and_match.launches = 0


def decide_and_match_shards(shards, lead: torch.device, seg_capacity=None):
    """The per-shard core of :func:`decide_and_match_sharded`.

    ``shards`` holds one tuple per row shard — (up_vals, up_exists,
    down_vals, down_exists, status_mask, pair_hashes, sel_hashes), plus
    the shard's seg_ids block in the fleet form (``seg_capacity`` given) —
    each the shard's rows with full S, on the shard's device. Returns the
    per-shard decision and upsync lanes, the global [C] counts on
    ``lead`` and, in the fleet form, the global [seg_capacity] counts on
    ``lead`` (else None). CPU shards take the plain version; CUDA shards
    launch the kernel, accumulating into one zeroed buffer per device."""
    fleet = seg_capacity is not None
    acc: dict[torch.device, torch.Tensor] = {}
    seg_acc: dict[torch.device, torch.Tensor] = {}
    decisions, upsyncs = [], []
    for args in shards:
        dev = args[0].device
        if dev not in acc:
            acc[dev] = torch.zeros(args[6].shape[0], dtype=torch.int32, device=dev)
            if fleet:
                seg_acc[dev] = torch.zeros(seg_capacity, dtype=torch.int32, device=dev)
        seg = args[7] if fleet else None
        if dev.type == "cpu":
            out = decide_and_match_plain(*args[:7], seg, seg_capacity)
            d, u = out[0], out[1]
            acc[dev] += out[2]
            if fleet:
                seg_acc[dev] += out[3]
        elif dev.type == "cuda":
            d, u, launched = _launch(*args[:7], acc[dev], seg, seg_acc.get(dev))
            decide_and_match_sharded.launches += launched
        else:
            raise ValueError(f"decide_and_match_sharded: unsupported device {dev}")
        decisions.append(d)
        upsyncs.append(u)
    return (decisions, upsyncs, _sum_on(acc, lead),
            _sum_on(seg_acc, lead) if fleet else None)


def _sum_on(parts: dict, lead: torch.device) -> torch.Tensor:
    """The psum: per-device partial counts come to the lead (stream-ordered
    copies) and add there."""
    vals = list(parts.values())
    total = vals[0].to(lead)
    for part in vals[1:]:
        total = total + part.to(lead)
    return total


def decide_and_match_sharded(mesh, up_vals, up_exists, down_vals, down_exists,
                             status_mask, pair_hashes, sel_hashes,
                             seg_ids=None, seg_capacity=None):
    """The fused pass on a sharded bucket: (decision u8 [B] and upsync
    bool [B] as row-sharded :class:`~kcp_tpu_torch.parallel.mesh.ShardedTensor`s,
    match counts int32 [C] on the mesh's lead device), and in the fleet
    form (``seg_ids``, ``seg_capacity``) the per-segment counts on the
    lead as a fourth output.

    Arguments are ShardedTensors laid out as ``shard_state`` lays out a
    state (``seg_ids`` as the row flags), or whole tensors, which are
    sharded here with that layout. Every row shard runs the kernel (or,
    on the CPU, the plain version) over its local rows with its slot
    columns gathered to full S. Any B works, including one that does not
    split evenly over the row shards: the split is uneven
    (``parallel.mesh.row_bounds``), never padded, so the reference's TPU
    gates (the XLA-lane fallback for a slots axis or for local rows off a
    multiple of 128) do not exist here."""
    from ..parallel import mesh as pm

    cap = _seg_capacity(seg_ids, seg_capacity)
    tensors = [up_vals, up_exists, down_vals, down_exists, status_mask,
               pair_hashes, sel_hashes]
    layouts = [pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS,
               pm.ROWS if status_mask.ndim == 2 else pm.SLOT_MASK,
               pm.FLAGS, pm.REPLICATED]
    if cap is not None:
        tensors.append(seg_ids)
        layouts.append(pm.FLAGS)
    args = [a if isinstance(a, pm.ShardedTensor) else pm.ShardedTensor.put(a, mesh, lay)
            for a, lay in zip(tensors, layouts)]
    shards = [tuple(a.row_block(i) for a in args)
              for i in range(pm.row_factor(mesh))]
    decisions, upsyncs, counts, seg_counts = decide_and_match_shards(
        shards, mesh.lead, cap)
    b = args[0].shape[0]
    out = (pm.ShardedTensor(mesh, pm.FLAGS, (b,), [[d] for d in decisions]),
           pm.ShardedTensor(mesh, pm.FLAGS, (b,), [[u] for u in upsyncs]),
           counts)
    return out if cap is None else (*out, seg_counts)


decide_and_match_sharded.launches = 0
