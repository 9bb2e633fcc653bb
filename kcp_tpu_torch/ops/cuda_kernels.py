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
a ring in shared memory. One launch takes a group of up to
:data:`MAX_SHARDS` row shards on one card (a single call is a group of
one); :func:`_group_plan` makes the plan (tile rows, ring depth, grid,
each shard's bulk and plain-load tiles) on the host and the kernel takes
it as arguments. ``last_plan`` holds the plan of the latest launch.

The kernel is compiled with ``nvcc`` at first use into
``build/kcp_tpu_torch/`` at the repo root (a plain C entry point, loaded
with ctypes). The library's file name carries a hash of every file under
``csrc/`` and of ``NVCC_FLAGS``, so a change to any of them builds anew.
``decide_and_match.launches`` counts kernel launches, and
``decide_and_match.by_thread`` the launches of each calling thread (a
server's loop runs on a thread of its own, so a fleet of servers in one
process reads its launches per server); nothing else touches either.

``decide_and_match_sharded`` is the mesh form (it replaces
``kcp_tpu/ops/pallas_kernels.py:decide_and_match_sharded``, a
``shard_map`` of the Pallas kernel plus a ``psum`` of the counts): one
grouped launch of the same kernel per device, over every row shard this
process holds there, each with its slot columns gathered to full S (a
device holding more than :data:`MAX_SHARDS` shards takes one launch per
:data:`MAX_SHARDS`). The kernel sums the [C] (and [seg_capacity]) counts
of the group's shards in its histograms, which is the ``psum`` over
co-resident shards; the per-device sums are added on the mesh's lead
device. On a mesh whose row shards span the processes of a
``torch.distributed`` group, a process launches only over its own row
shards and one ``all_reduce`` on the group adds the other processes'
counts. ``decide_and_match_sharded.launches`` (and ``.by_thread``)
counts those grouped launches: one per device a call.

``wire_scatter`` (``kcp_tpu_torch/csrc/wire_scatter.cu``, built into the
same library) is the unsharded packed step's side lanes and delta scatters
on the card, read straight off the wire: a ``"stamps"`` launch (segment
stamps, the acks copy, mask stamps) and a ``"deltas"`` launch (both
sides' deltas and the count of them). Its CPU form is
:func:`~kcp_tpu_torch.ops.diff.scatter_rows_drop` and the step functions
around it; the wrapper itself takes CUDA tensors only.
``wire_scatter.launches`` (and ``.by_thread``) counts its launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

from ..analysis.sanitize import make_lock
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
MAX_SHARDS = 16  # row shards one launch takes (kMaxShards in the CUDA source)

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
                       "the port's CUDA kernels")


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
        lib.kcp_decide_match.argtypes = [vp, ci, ll, vp, vp, vp, ci, ci, ci, ci,
                                         ci, ci, ci, vp]
        lib.kcp_decide_match.restype = ci
        lib.kcp_sm_count.argtypes = [ctypes.POINTER(ci)]
        lib.kcp_sm_count.restype = ci
        lib.kcp_wire_scatter.argtypes = [ci, vp, ci, ci, ll, vp, vp, vp, vp, vp, vp, vp,
                                         ci, vp, vp]
        lib.kcp_wire_scatter.restype = ci
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


class ShardTiles(NamedTuple):
    rows: int
    bulk_tiles: int  # its full tiles through the ring (0: every tile plain)
    tiles: int  # ceil(rows / T)
    bulk_first: int  # global index of its first bulk tile
    plain_first: int  # its first plain-path tile among the group's


class TilePlan(NamedTuple):
    tile: int  # T rows per tile, a multiple of 16
    stages: int  # ring depth in shared memory (0 on the plain-load path)
    grid: int  # persistent blocks
    bulk: bool  # some full tiles come through bulk copies
    bulk_tiles: int  # global tiles [0, bulk_tiles) are bulk-copied
    tiles: int  # every shard's ceil(rows / T); the rest go through plain loads
    tail_rows: int  # rows the plain-load path reads
    ranges: tuple  # bytes of each input per tile, in RANGES order (0: not loaded)
    smem: int  # shared-memory bytes per block
    shards: tuple  # a ShardTiles per shard, in launch order


def _smem_bytes(t: int, c: int, cap: int, stages: int, stage_bytes: int) -> int:
    """A block's shared memory (``smem_layout`` in the CUDA source):
    mbarriers, two [T] row-flag buffers, selectors and the [C] and [cap]
    histograms, then the ring."""
    head = 128 + 8 * t + 8 * c + 4 * cap
    return -(-head // 128) * 128 + stages * stage_bytes


def _aligned(ptrs: tuple, row_bytes: tuple) -> bool:
    """Every input the ring loads starts on a 16-byte boundary."""
    return all(p % 16 == 0 for p, n in zip(ptrs, row_bytes) if n)


def _row_bytes(s: int, l: int, mask_per_row: bool, fleet: bool) -> tuple:
    return (4 * s, 4 * s, s if mask_per_row else 0, 1, 1, 4 * l, 4 if fleet else 0)


@functools.lru_cache(maxsize=256)
def _group_plan(shards: tuple, s: int, l: int, c: int, per_row: bool, fleet: bool,
                cap: int, sms: int) -> TilePlan:
    """The launch plan for a group of row shards of S slots, L pair
    hashes, C selectors: ``shards`` holds (rows, aligned) per shard in
    launch order, ``aligned`` whether every input the ring loads starts
    on a 16-byte boundary.

    A stage holds T rows of every input, T the largest multiple of 16
    whose stage stays within ``STAGE_TARGET`` bytes; the ring holds up to
    ``MAX_STAGES`` of them within the block's share of shared memory
    (``BLOCKS_PER_SM`` blocks share an SM). A shard's full tiles take the
    bulk path when it is aligned and two stages fit; its last partial
    tile, and every tile of a shard otherwise, take the plain-load path.
    The global tile order is every bulk tile (shard by shard), then every
    plain-path tile (shard by shard); the grid is min(SMs x
    ``BLOCKS_PER_SM``, tiles)."""
    row_bytes = _row_bytes(s, l, per_row, fleet)
    per_tile_row = sum(row_bytes)
    budget = min(SMEM_BLOCK_MAX, SMEM_PER_SM // BLOCKS_PER_SM) - SMEM_RESERVED
    if _smem_bytes(16, c, cap, 0, 0) > budget:
        raise ValueError(f"decide_and_match: C={c} selectors and seg_capacity={cap} "
                         f"do not fit the kernel's shared memory")
    t = max(16, STAGE_TARGET // per_tile_row // 16 * 16)
    free = budget - _smem_bytes(t, c, cap, 0, 0)
    depth = min(MAX_STAGES, max(0, free) // (t * per_tile_row))
    tiles, bulk_tiles, plain_tiles = [], 0, 0
    for rows, aligned in shards:
        n = -(-rows // t)
        bulk = rows // t if aligned and depth >= 2 else 0
        tiles.append(ShardTiles(rows, bulk, n, bulk_tiles, plain_tiles))
        bulk_tiles += bulk
        plain_tiles += n - bulk
    stages = depth if bulk_tiles else 0
    total = bulk_tiles + plain_tiles
    return TilePlan(
        tile=t, stages=stages, grid=max(1, min(sms * BLOCKS_PER_SM, total)),
        bulk=bulk_tiles > 0, bulk_tiles=bulk_tiles, tiles=total,
        tail_rows=sum(rows for rows, _ in shards) - bulk_tiles * t,
        ranges=tuple(n * t for n in row_bytes),
        smem=_smem_bytes(t, c, cap, stages, t * per_tile_row), shards=tuple(tiles))


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


def decide_and_match_group_plain(shards, seg_capacity=None):
    """The grouped launch's plain version: :func:`decide_and_match_plain`
    per shard (each a tuple as :func:`decide_and_match_shards` takes it),
    the counts summed over the group. Returns (per-shard decisions,
    per-shard upsyncs, counts int32 [C], and the summed [seg_capacity]
    counts with ``seg_capacity``, else None)."""
    fleet = seg_capacity is not None
    outs = [decide_and_match_plain(*args[:7], args[7] if fleet else None, seg_capacity)
            for args in shards]
    counts = torch.stack([o[2] for o in outs]).sum(dim=0, dtype=torch.int32)
    seg_counts = (torch.stack([o[3] for o in outs]).sum(dim=0, dtype=torch.int32)
                  if fleet else None)
    return [o[0] for o in outs], [o[1] for o in outs], counts, seg_counts


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


def _descriptors(ptrs, plan: TilePlan, decisions, upsyncs) -> list:
    """The group's shard descriptors as the kernel reads them
    (``KcpShardDesc``, eleven words a shard): its up, down,
    up_exists, down_exists, mask, pair and seg (0 outside the fleet form)
    addresses, its decision and upsync outputs, rows and bulk tiles.
    ``ptrs`` holds each shard's input addresses in :data:`RANGES` order."""
    words = []
    for (up, down, mask, upe, dne, pair, seg), dec, ups, tiles in zip(
            ptrs, decisions, upsyncs, plan.shards):
        words += (up, down, upe, dne, mask, pair, seg, dec.data_ptr(), ups.data_ptr(),
                  tiles.rows, tiles.bulk_tiles)
    return words


def _launch(group, counts, seg_counts=None):
    """One launch of the kernel over ``group``: 1 to :data:`MAX_SHARDS`
    row shards on one card, each a tuple (up_vals, up_exists, down_vals,
    down_exists, status_mask, pair_hashes, sel_hashes), plus its seg_ids
    in the fleet form (``seg_counts`` given). The shards share S, L, C and
    the mask's form, and the selectors, which are the first shard's (a
    replicated [C]). The kernel ADDS every shard's selector hits into
    ``counts`` (int32 [C] on the same card) and, in the fleet form, every
    shard's resident up rows per segment into ``seg_counts`` (int32
    [seg_capacity]). Returns (decisions, upsyncs, launched): each shard's
    lanes, views of one buffer over the group's rows; no rows launch
    nothing."""
    global last_plan
    if not 1 <= len(group) <= MAX_SHARDS:
        raise ValueError(f"decide_and_match: {len(group)} shards in one launch "
                         f"(1 to {MAX_SHARDS})")
    fleet = seg_counts is not None
    first = group[0]
    dev = first[0].device
    s, l, c = first[0].shape[-1], first[5].shape[-1], first[6].shape[0]
    per_row = first[4].ndim == 2
    for args in group:
        if len(args) != 7 + fleet:
            raise ValueError(f"decide_and_match: a shard has {len(args)} inputs, "
                             f"want {7 + fleet}")
        _check(*args)
        if (args[0].device != dev or args[0].shape[1] != s or args[5].shape[1] != l
                or args[6].shape[0] != c or (args[4].ndim == 2) != per_row):
            raise ValueError("decide_and_match: the shards of one launch differ in "
                             "device, S, L, C or the mask's form")
    if counts.device != dev or counts.dtype != torch.int32 or counts.shape != (c,):
        raise ValueError(f"decide_and_match: counts must be int32 [{c}] on {dev}")
    if fleet and (seg_counts.device != dev or seg_counts.dtype != torch.int32
                  or seg_counts.ndim != 1):
        raise ValueError(f"decide_and_match: seg_counts must be int32 [seg_capacity] on {dev}")
    cap = seg_counts.shape[0] if fleet else 0
    sizes = [args[0].shape[0] for args in group]
    decision = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    upsync = torch.empty(sum(sizes), dtype=torch.bool, device=dev)
    if len(group) == 1:
        decisions, upsyncs = [decision], [upsync]
    else:
        decisions, upsyncs = list(decision.split(sizes)), list(upsync.split(sizes))
    if not sum(sizes):
        return decisions, upsyncs, 0
    lib = _load()
    row_bytes = _row_bytes(s, l, per_row, fleet)
    ptrs = [(a[0].data_ptr(), a[2].data_ptr(), a[4].data_ptr(), a[1].data_ptr(),
             a[3].data_ptr(), a[5].data_ptr(), a[7].data_ptr() if fleet else 0)
            for a in group]
    plan = last_plan = _group_plan(
        tuple((n, _aligned(p, row_bytes)) for n, p in zip(sizes, ptrs)),
        s, l, c, per_row, fleet, cap, _sm_count(dev))
    words = _descriptors(ptrs, plan, decisions, upsyncs)
    idx = _index(dev)
    # switching the current device costs more host time than the launch
    # itself, so only a launch on another card switches
    switch = idx != torch.cuda.current_device()
    with torch.cuda.device(idx) if switch else contextlib.nullcontext():
        rc = lib.kcp_decide_match(
            (ctypes.c_longlong * len(words))(*words), len(group), s if per_row else 0,
            first[6].data_ptr(), counts.data_ptr(),
            seg_counts.data_ptr() if fleet else None, s, l, c, cap, plan.tile,
            plan.stages, plan.grid, torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decide_and_match: kernel launch failed with CUDA "
                           f"error {rc}")
    return decisions, upsyncs, 1


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
    args = (up_vals, up_exists, down_vals, down_exists, status_mask, pair_hashes,
            sel_hashes)
    (decision,), (upsync,), launched = _launch(
        [args if cap is None else (*args, seg_ids)], counts, seg_counts)
    _count(decide_and_match, launched)
    if seg_counts is None:
        return decision, upsync, counts
    return decision, upsync, counts, seg_counts


decide_and_match.launches = 0
decide_and_match.by_thread = {}
_COUNT_LOCK = make_lock("cuda_kernels.launch_count")


def _count(wrapper, launched: int) -> None:
    """Add a wrapper's launches to its count and to the calling thread's
    share of it, under a lock: the loops of several servers launch from
    their own threads at once."""
    if launched:
        tid = threading.get_ident()
        with _COUNT_LOCK:
            wrapper.launches += launched
            wrapper.by_thread[tid] = wrapper.by_thread.get(tid, 0) + launched


# ---------------------------------------------------------------------------
# The wire's side lanes and delta scatters
# ---------------------------------------------------------------------------

_WIRE_STAGES = {"stamps": 0, "deltas": 1}


def _wire_arg(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
              dev: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"wire_scatter: {name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"wire_scatter: {name} must be {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wire_scatter: {name} is not contiguous")
    if t.device != dev:
        raise ValueError(f"wire_scatter: {name} on {t.device}, packed on {dev}")


def wire_scatter(stage: str, packed, up_vals, up_exists, down_vals, down_exists,
                 status_mask=None, seg_ids=None, acks=None):
    """One launch of ``csrc/wire_scatter.cu`` over the int32 [D, S+2] wire,
    in place on the resident mirrors (design and semantics there).

    ``stage="stamps"``: the segment stamps into ``seg_ids`` (int32 [B], or
    None), the acks copy (``acks`` int32 [A], -1 padding, or None) and the
    mask stamps into a per-row ``status_mask`` (bool [B, S]; a bucket-wide
    [S] mask takes none); returns None. ``stage="deltas"``: the delta
    scatters into the up and down mirrors, after the stamps; returns the
    int32 [1] count of the wire's valid delta entries (``stats[7]``).

    Byte for byte what :func:`~kcp_tpu_torch.ops.diff.scatter_rows_drop`
    does in ``reconcile_step_packed``'s CPU path. CUDA tensors only: every
    argument is checked (dtype, shape, contiguity, device) before the
    library is loaded, and CPU tensors are refused. ``wire_scatter.launches``
    (and ``.by_thread``) counts launches: two a packed step."""
    code = _WIRE_STAGES.get(stage)
    if code is None:
        raise ValueError(f"wire_scatter: stage {stage!r}, want one of {sorted(_WIRE_STAGES)}")
    dev = packed.device
    if packed.dtype != torch.int32 or packed.ndim != 2 or packed.shape[1] < 2:
        raise TypeError(f"wire_scatter: packed must be int32 [D, S+2], got {packed.dtype} "
                        f"{list(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("wire_scatter: packed is not contiguous")
    d, s = packed.shape[0], packed.shape[1] - 2
    b = up_vals.shape[0]
    _wire_arg("up_vals", up_vals, torch.int32, (b, s), dev)
    _wire_arg("up_exists", up_exists, torch.bool, (b,), dev)
    _wire_arg("down_vals", down_vals, torch.int32, (b, s), dev)
    _wire_arg("down_exists", down_exists, torch.bool, (b,), dev)
    mask = seg = ack = 0
    n_acks = 0
    if code == 0:
        if status_mask is not None and status_mask.ndim == 2:
            _wire_arg("status_mask", status_mask, torch.bool, (b, s), dev)
            mask = status_mask.data_ptr()
        if seg_ids is not None:
            _wire_arg("seg_ids", seg_ids, torch.int32, (b,), dev)
            seg = seg_ids.data_ptr()
        if acks is not None:
            if acks.ndim != 1:
                raise ValueError(f"wire_scatter: acks must be [A], got {list(acks.shape)}")
            _wire_arg("acks", acks, torch.int32, tuple(acks.shape), dev)
            n_acks = acks.shape[0]
            ack = acks.data_ptr()
    if dev.type != "cuda":
        raise ValueError(f"wire_scatter: tensors on {dev}; the kernel takes CUDA tensors "
                         f"(the CPU path is ops.diff.scatter_rows_drop)")
    applied = torch.empty(1, dtype=torch.int32, device=dev) if code else None
    lib = _load()
    idx = _index(dev)
    # switching the current device costs more host time than the launch
    # itself, so only a launch on another card switches
    switch = idx != torch.cuda.current_device()
    with torch.cuda.device(idx) if switch else contextlib.nullcontext():
        rc = lib.kcp_wire_scatter(
            code, packed.data_ptr(), d, s, b, up_vals.data_ptr(), up_exists.data_ptr(),
            down_vals.data_ptr(), down_exists.data_ptr(), mask, seg, ack, n_acks,
            applied.data_ptr() if code else 0,
            torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wire_scatter: {stage} launch failed with CUDA error {rc}")
    _count(wire_scatter, 1)
    return applied


wire_scatter.launches = 0
wire_scatter.by_thread = {}


def decide_and_match_shards(shards, lead: torch.device, seg_capacity=None, mesh=None):
    """The per-shard core of :func:`decide_and_match_sharded`.

    ``shards`` holds one tuple per row shard of this process — (up_vals,
    up_exists, down_vals, down_exists, status_mask, pair_hashes,
    sel_hashes), plus the shard's seg_ids block in the fleet form
    (``seg_capacity`` given) — each the shard's rows with full S, on the
    shard's device. Returns the per-shard decision and upsync lanes, the
    global [C] counts on ``lead`` and, in the fleet form, the global
    [seg_capacity] counts on ``lead`` (else None). The shards are grouped
    by device: a CPU group takes :func:`decide_and_match_group_plain`; a
    CUDA group is one launch of the kernel over all of its shards (one
    per :data:`MAX_SHARDS` shards), each shard's lanes views of one
    buffer, its counts summed in the kernel into one zeroed buffer per
    device. On a ``mesh`` whose row shards span processes, the counts of
    the other processes' shards join through one ``all_reduce`` on the
    group (the reference's ``psum``)."""
    fleet = seg_capacity is not None
    by_dev: dict[torch.device, list[int]] = {}
    for i, args in enumerate(shards):
        by_dev.setdefault(args[0].device, []).append(i)
    acc: dict[torch.device, torch.Tensor] = {}
    seg_acc: dict[torch.device, torch.Tensor] = {}
    decisions, upsyncs = [None] * len(shards), [None] * len(shards)
    for dev, where in by_dev.items():
        group = [shards[i] for i in where]
        if dev.type == "cpu":
            decs, ups, acc[dev], seg = decide_and_match_group_plain(group, seg_capacity)
            if fleet:
                seg_acc[dev] = seg
        elif dev.type == "cuda":
            acc[dev] = torch.zeros(group[0][6].shape[0], dtype=torch.int32, device=dev)
            if fleet:
                seg_acc[dev] = torch.zeros(seg_capacity, dtype=torch.int32, device=dev)
            decs, ups = [], []
            for k in range(0, len(group), MAX_SHARDS):
                d, u, launched = _launch(group[k:k + MAX_SHARDS], acc[dev], seg_acc.get(dev))
                _count(decide_and_match_sharded, launched)
                decs += d
                ups += u
        else:
            raise ValueError(f"decide_and_match_sharded: unsupported device {dev}")
        for i, d, u in zip(where, decs, ups):
            decisions[i], upsyncs[i] = d, u
    counts = _sum_on(acc, lead)
    seg_counts = _sum_on(seg_acc, lead) if fleet else None
    if mesh is not None and mesh.process is not None:
        from ..parallel.mesh import all_sum

        c = counts.shape[0]
        both = all_sum(mesh, counts if seg_counts is None else torch.cat([counts, seg_counts]))
        counts, seg_counts = both[:c], (both[c:] if fleet else None)
    return decisions, upsyncs, counts, seg_counts


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
    sharded here with that layout. The row shards of this process that
    share a card run in one launch of the kernel (on the CPU, the plain
    version), each over its rows with its slot columns gathered to full
    S. Any B works, including one that does not
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
    shards = [tuple(a.row_block(i) for a in args) for i in mesh.local_rows]
    decisions, upsyncs, counts, seg_counts = decide_and_match_shards(
        shards, mesh.lead, cap, mesh=mesh)
    b = args[0].shape[0]

    def rows(lanes):
        blocks = [None] * pm.row_factor(mesh)
        for i, t in zip(mesh.local_rows, lanes):
            blocks[i] = [t]
        return pm.ShardedTensor(mesh, pm.FLAGS, (b,), blocks)

    out = (rows(decisions), rows(upsyncs), counts)
    return out if cap is None else (*out, seg_counts)


decide_and_match_sharded.launches = 0
decide_and_match_sharded.by_thread = {}
