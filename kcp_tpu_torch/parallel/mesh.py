"""Device meshes and sharded reconcile state (the port of
``kcp_tpu.parallel.mesh``).

The scale dimension of the control plane is object count x logical
cluster count: the reconcile batch is a [B, S] mirror whose B rows span
every object of every tenant. The layout is the reference's:

- ``tenants`` axis (data-parallel): rows are range-sharded, so each row
  shard owns a contiguous block of tenants' objects and every row-local
  lane (scatter, decision, placement) needs no communication;
- ``slots`` axis: the [B, S] columns of wide buckets split over it; the
  decision reduces over slots, so a row shard gathers its columns first
  (the reference's ``P(row, None)`` kernel in-spec);
- ``hosts`` axis (:func:`make_multihost_mesh`): a major axis that rows
  fold over together with ``tenants``, so tenant blocks nest in host
  blocks.

Where the reference annotates ``NamedSharding``s and lets XLA insert the
collectives, the port holds each shard as its own tensor on its own
device (:class:`ShardedTensor`) and the sharded step
(``models/reconcile_model.py``) reduces the cross-shard quantities on the
mesh's lead device itself. In a ``torch.distributed`` group of more than
one process (``make_multihost_mesh(..., process=rank)``), the ``hosts``
index is the rank: a process holds only its own hosts block of row shards
(:attr:`Mesh.local_rows`), a remote row shard has no tensor and no device
here, and what crosses row shards goes through :func:`all_sum` and
:func:`gather_blocks` on the group. A mesh's device list may repeat a device: the
tests build 8 x ``cpu`` meshes, the card smoke 4 x ``cuda:0``, and an entry
point whose ``--device`` names one card (``kcp start --mesh 4 --device
cuda:0``, :func:`mesh_on`) holds every row shard there. Every shard is
still a separate allocation. The fused kernel takes the row shards of one
card in one launch (``ops.cuda_kernels.decide_and_match_shards``): on a
repeated device a launch covers several shards, on a host with a card per
row shard each launch covers one shard (the card smoke runs the latter
where it sees two cards or more). In a group of processes, a mesh built
without ``devices=`` takes this process's own cards, and on an NCCL group
no other (``distributed.rank_plan``).
Copies between devices go through
``Tensor.to``, whose cross-device path orders the two devices' current
streams with events; between shards of one device it is a no-op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

HOSTS_AXIS = "hosts"
TENANTS_AXIS = "tenants"
SLOTS_AXIS = "slots"

# the process-wide serving mesh: set once at startup, read by
# FusedCore.for_current_loop when no explicit mesh is threaded through —
# so every sync engine in the process serves sharded without each call
# site re-plumbing it
_SERVING_MESH: "Mesh | None" = None


class Mesh:
    """A grid of ``torch.device``s with named axes (``hosts``/``tenants``/
    ``slots``). ``devices`` is a numpy object array shaped like the axes.

    ``process`` is this process's rank on a mesh whose ``hosts`` axis spans
    the processes of a ``torch.distributed`` group (its remote entries are
    None), and None on a mesh held whole by one process."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 process: int | None = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"device grid of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process = process
        rf, sf = row_factor(self), slot_factor(self)
        # [row shard][slot shard] -> device; row shards follow the
        # (hosts, tenants) fold in C order
        self.grid: list[list[torch.device | None]] = [
            list(r) for r in devices.reshape(rf, sf)]
        #: the row shards this process holds, in row order
        self.local_rows = [i for i in range(rf) if self.grid[i][0] is not None]
        self.lead = self.grid[self.local_rows[0]][0]

    @property
    def local_devices(self) -> tuple:
        """This process's devices, each once, in grid order."""
        return tuple(dict.fromkeys(d for d in self.devices.flat if d is not None))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.process == other.process
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __repr__(self) -> str:
        where = "" if self.process is None else f", process={self.process}"
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{where})")


def _visible_devices() -> list[torch.device]:
    """Every visible CUDA device: the default device list of a mesh."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a mesh defaults to the visible CUDA devices and there are none; "
            "pass devices= (e.g. [torch.device('cpu')] * 8) to build one on "
            "the host")
    return [torch.device("cuda", i) for i in range(n)]


def _as_devices(devices) -> list[torch.device]:
    return [torch.device(d) for d in devices]


def _group() -> tuple[int, int]:
    """(world size, rank) of the formed ``torch.distributed`` group, or
    (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def set_serving_mesh(mesh: "Mesh | str | None") -> "Mesh | None":
    """Install the process-default serving mesh (a Mesh or a spec string
    like ``"8"``, ``"4x2"``, ``"2x2x2"`` over the visible CUDA devices).
    None clears it."""
    global _SERVING_MESH
    _SERVING_MESH = mesh_from_spec(mesh) if isinstance(mesh, str) else mesh
    return _SERVING_MESH


def get_serving_mesh() -> "Mesh | None":
    return _SERVING_MESH


def mesh_from_spec(spec: str, devices: list | None = None) -> Mesh:
    """Build a mesh from a spec string.

    ``"8"`` -> (tenants=8, slots=1); ``"4x2"`` -> (tenants=4, slots=2);
    ``"2x2x2"`` -> (hosts=2, tenants=2, slots=2); ``"auto"`` ->
    ``distributed.pod_serving_mesh`` (hosts-major over the processes of a
    ``torch.distributed`` group of more than one, else flat tenants over
    this process's devices). ``devices`` defaults to the visible CUDA
    devices, in a group of more than one process to this process's own
    (``distributed.rank_plan``), and may repeat a device. In such a group,
    a 3-D spec whose hosts equal the world size spans the processes:
    ``devices`` are then this process's own (tenants x slots of them).
    """
    if spec.strip().lower() == "auto":
        from .distributed import pod_serving_mesh

        return pod_serving_mesh(devices=devices)
    dims = _spec_dims(spec)
    world, rank = _group()
    if devices is not None:
        devs = _as_devices(devices)
    else:  # every visible card, or in a group this process's own
        from .distributed import _own_cards

        devs = _own_cards(world, rank)
    if len(dims) == 3 and world > 1 and dims[0] == world:
        h, t, s = dims
        return make_multihost_mesh(hosts=h, tenants=t, slots=s, devices=devs[:t * s],
                                   process=rank)
    n = int(np.prod(dims))
    if len(devs) < n:
        raise ValueError(
            f"mesh spec {spec!r} needs {n} devices, have {len(devs)}; "
            f"shrink the spec or pass devices= with {n} entries (a device "
            f"may repeat, e.g. [torch.device('cuda:0')] * {n})")
    if len(dims) == 1:
        return make_mesh(n_devices=dims[0], slots=1, devices=devs)
    if len(dims) == 2:
        return make_mesh(n_devices=n, tenants=dims[0], slots=dims[1], devices=devs)
    h, t, s = dims
    return make_multihost_mesh(hosts=h, tenants=t, slots=s, devices=devs[:n])


def _spec_dims(spec: str) -> list[int]:
    parts = spec.lower().replace("*", "x").split("x")
    if not parts or any(not p.strip().isdigit() for p in parts):
        raise ValueError(f"bad mesh spec {spec!r}: want N, NxM or NxMxK")
    dims = [int(p) for p in parts]
    if any(d < 1 for d in dims) or len(dims) > 3:
        raise ValueError(f"bad mesh spec {spec!r}: want N, NxM or NxMxK")
    return dims


def mesh_on(spec: str, device: "str | torch.device | None" = None) -> Mesh:
    """The mesh of ``spec`` for an entry point's ``device`` argument:
    ``None`` (or a bare ``"cuda"``) spreads it over the visible CUDA
    devices (in a group, this process's own); a named device (``"cpu"``,
    ``"cuda:1"``) holds every shard. ``init_distributed`` given the same
    ``device`` picks the backend that fits (``distributed.rank_plan``)."""
    if device is None or torch.device(device) == torch.device("cuda"):
        return mesh_from_spec(spec)
    if spec.strip().lower() == "auto":
        return mesh_from_spec(spec, devices=[device])
    return mesh_from_spec(spec, devices=[device] * int(np.prod(_spec_dims(spec))))


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_mesh(n_devices: int | None = None, tenants: int | None = None,
              slots: int = 1, devices: list | None = None) -> Mesh:
    """A 2D (tenants, slots) mesh over the first ``n_devices`` devices."""
    devs = _as_devices(devices) if devices is not None else _visible_devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available")
        devs = devs[:n_devices]
    n = len(devs)
    if tenants is None:
        tenants = n // slots
    if tenants * slots != n:
        raise ValueError(f"mesh {tenants}x{slots} != {n} devices")
    return Mesh(_grid(devs, (tenants, slots)), (TENANTS_AXIS, SLOTS_AXIS))


def make_multihost_mesh(hosts: int, tenants: int | None = None, slots: int = 1,
                        devices: list | None = None, process: int | None = None) -> Mesh:
    """A 3D (hosts, tenants, slots) mesh with hosts as the major axis.

    With ``process`` (a rank of a ``torch.distributed`` group of ``hosts``
    processes), ``devices`` are this process's own, its hosts block is
    the rank's, and the other blocks are remote (None in the grid)."""
    devs = _as_devices(devices) if devices is not None else _visible_devices()
    n = len(devs) * (hosts if process is not None else 1)
    if n % hosts:
        raise ValueError(f"{n} devices not divisible into {hosts} hosts")
    per_host = n // hosts
    if tenants is None:
        tenants = per_host // slots
    if tenants * slots != per_host:
        raise ValueError(f"per-host mesh {tenants}x{slots} != {per_host} devices")
    if process is None:
        return Mesh(_grid(devs, (hosts, tenants, slots)),
                    (HOSTS_AXIS, TENANTS_AXIS, SLOTS_AXIS))
    if not 0 <= process < hosts:
        raise ValueError(f"process {process} is not a hosts index of {hosts}")
    _check_own_cards(devs)
    grid = np.full((hosts, tenants, slots), None, dtype=object)
    grid[process] = _grid(devs, (tenants, slots))
    return Mesh(grid, (HOSTS_AXIS, TENANTS_AXIS, SLOTS_AXIS), process=process)


def _check_own_cards(devs: list[torch.device]) -> None:
    """On an NCCL group, this process's row shards lie on its own cards
    (``distributed.rank_plan``): NCCL refuses a card that two ranks use,
    and takes no CPU tensor."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_backend() != "nccl":
        return
    from .distributed import rank_plan

    world, rank = _group()
    own = rank_plan(world, rank).devices
    indices = {o.index for o in own}
    bad = [str(d) for d in devs if d.type != "cuda"
           or (d.index if d.index is not None else torch.cuda.current_device()) not in indices]
    if bad:
        raise ValueError(
            f"process {rank} of an NCCL group holds its row shards on its own cards "
            f"{[str(o) for o in own]}, not on {bad}; pass no devices, or form the group "
            f"with init_distributed(device=...) naming the card the processes share (gloo)")


def row_factor(mesh: Mesh) -> int:
    """Product of the row-axis sizes (hosts x tenants) — the shard count
    of every B/R dimension. THE single source for row-axis arithmetic."""
    dims = mesh.shape
    return dims.get(HOSTS_AXIS, 1) * dims.get(TENANTS_AXIS, 1)


def slot_factor(mesh: Mesh) -> int:
    """Size of the slots axis (1 when absent)."""
    return mesh.shape.get(SLOTS_AXIS, 1)


# ---------------------------------------------------------------------------
# Sharded tensors
# ---------------------------------------------------------------------------


class Layout(NamedTuple):
    """How one tensor lies on a mesh: dim 0 split over the row axes
    (``rows``) or replicated on every row shard, the last dim split over
    ``slots`` (``cols``) or whole."""

    rows: bool
    cols: bool


ROWS = Layout(rows=True, cols=True)  # [B, S] mirrors and per-row masks
FLAGS = Layout(rows=True, cols=False)  # [B], [B, L], [R], [R, P]
SLOT_MASK = Layout(rows=False, cols=True)  # bucket-wide [S] status mask
REPLICATED = Layout(rows=False, cols=False)  # [C] selectors


def row_bounds(n: int, shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of ``n`` rows over ``shards`` shards:
    ceil(n / shards) rows each, the remainder on the last ones (empty
    when n < shards). Uneven splits are allowed — the sharded step takes
    any B, as the reference's XLA lanes do."""
    per = -(-n // shards) if n else 0
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(shards)]


def _col_bounds(s: int, shards: int) -> list[tuple[int, int]]:
    if s % shards:
        raise ValueError(f"{s} slot columns do not split over a slots axis "
                         f"of {shards}; use a slot width divisible by it")
    w = s // shards
    return [(j * w, (j + 1) * w) for j in range(shards)]


class ShardedTensor:
    """One logical tensor held as per-shard tensors on a mesh.

    ``blocks[i][j]`` is row shard ``i``'s column block ``j`` on device
    ``mesh.grid[i][j]``. A replicated-rows layout keeps one copy per row
    shard (each row shard reads its own); a whole-columns layout keeps
    one block per row shard, on the row shard's lead device. Blocks are
    separate tensors, never views of one tensor.
    """

    def __init__(self, mesh: Mesh, layout: Layout, shape: tuple[int, ...],
                 blocks: list[list[torch.Tensor]]):
        self.mesh = mesh
        self.layout = layout
        self.shape = tuple(shape)
        self.blocks = blocks
        rf = row_factor(mesh)
        self.bounds = (row_bounds(self.shape[0], rf) if layout.rows
                       else [(0, self.shape[0] if self.shape else 0)] * rf)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def put(cls, t: torch.Tensor, mesh: Mesh, layout: Layout) -> "ShardedTensor":
        """Split ``t`` (on any device) into blocks on the mesh's devices."""
        rf, sf = row_factor(mesh), slot_factor(mesh)
        layout = Layout(layout.rows, layout.cols and sf > 1)
        rows = row_bounds(t.shape[0], rf) if layout.rows else [(0, t.shape[0])] * rf
        cols = _col_bounds(t.shape[-1], sf) if layout.cols else [(0, None)]
        blocks: list = [None] * rf  # a remote row shard holds nothing here
        for i in mesh.local_rows:
            a, z = rows[i]
            part = t[a:z]
            blocks[i] = [
                part[..., c0:c1].to(mesh.grid[i][j], copy=True).contiguous()
                for j, (c0, c1) in enumerate(cols)]
        return cls(mesh, layout, tuple(t.shape), blocks)

    def row_block(self, i: int) -> torch.Tensor:
        """Row shard ``i`` with its full last dim, on the row shard's lead
        device: the block itself when columns are whole (so in-place
        updates reach the shard), else a gather of its column blocks."""
        blks = self.blocks[i]
        if blks is None:
            raise ValueError(f"row shard {i} lives in another process "
                             f"(this one is hosts index {self.mesh.process})")
        if len(blks) == 1:
            return blks[0]
        dev = blks[0].device
        return torch.cat([b.to(dev) for b in blks], dim=-1)

    def write_row_block(self, i: int, full: torch.Tensor) -> None:
        """Scatter a full-width row block back into its column blocks
        (a no-op when columns are whole: ``full`` is the block)."""
        blks = self.blocks[i]
        if len(blks) == 1:
            return
        w = blks[0].shape[-1]
        for j, b in enumerate(blks):
            b.copy_(full[..., j * w:(j + 1) * w])

    def full(self, device: torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the mesh's lead); the
        row shards of other processes come through :func:`gather_blocks`."""
        dev = self.mesh.lead if device is None else device
        if not self.layout.rows:
            return self.row_block(self.mesh.local_rows[0]).to(dev)
        parts = gather_blocks(self.mesh, {i: (self.row_block(i).to(self.mesh.lead),)
                                          for i in self.mesh.local_rows},
                              [hi - lo for lo, hi in self.bounds])
        return torch.cat([p[0].to(dev) for p in parts], dim=0)

    def clone(self) -> "ShardedTensor":
        return ShardedTensor(self.mesh, self.layout, self.shape,
                             [None if r is None else [b.clone() for b in r]
                              for r in self.blocks])

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, layout={self.layout}, "
                f"{len(self.blocks)}x{len(self.blocks[0])} blocks)")


# ---------------------------------------------------------------------------
# Across processes: what the reference's XLA collectives do over DCN
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend takes it: gloo takes CPU tensors
    only, so a card's tensor is staged through host memory."""
    import torch.distributed as dist

    return t.cpu() if t.is_cuda and dist.get_backend() == "gloo" else t


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's processes (the reference's ``psum``
    over ``hosts``), on ``t``'s device; ``t`` itself on a mesh that one
    process holds whole."""
    if mesh.process is None:
        return t
    import torch.distributed as dist

    buf = _wire(t).clone()
    dist.all_reduce(buf)
    return buf.to(t.device)


def gather_blocks(mesh: Mesh, local: dict, sizes: list[int]) -> list[tuple]:
    """Every row shard's blocks, in row order: ``local`` maps each of this
    process's row shards to a tuple of tensors whose dim 0 is the shard's
    ``sizes[i]`` rows (trailing dims and dtypes the same for every shard).

    On a mesh one process holds whole, the tuples as given. Across
    processes, one ``all_gather`` on the group: each process packs its
    blocks as int32 columns, each padded to the largest shard's rows
    (``all_gather`` takes equal sizes; ``row_bounds`` splits unevenly), and
    every row shard comes back cut to its size, on the mesh's lead, in its
    dtype. Every process calls it at the same point with the same sizes."""
    if mesh.process is None:
        return [local[i] for i in range(len(sizes))]
    import torch.distributed as dist

    lead = mesh.lead
    proto = local[mesh.local_rows[0]]
    tails = [tuple(t.shape[1:]) for t in proto]
    widths = [int(np.prod(tl)) for tl in tails]
    rows = max(sizes)
    packed = torch.zeros((len(mesh.local_rows), rows, sum(widths)), dtype=torch.int32,
                         device=lead)
    for k, i in enumerate(mesh.local_rows):
        cols = [t.to(lead).reshape(sizes[i], w).to(torch.int32)
                for t, w in zip(local[i], widths)]
        if sizes[i]:
            packed[k, :sizes[i]] = torch.cat(cols, dim=1)
    mine = _wire(packed)
    world = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(world, mine)
    every = torch.cat(world).to(lead)  # [row shards, rows, columns]
    out, at = [], np.cumsum([0] + widths)
    for i, n in enumerate(sizes):
        blk = every[i, :n]
        out.append(tuple(blk[:, a:z].reshape((n, *tl)).to(t.dtype)
                         for a, z, tl, t in zip(at[:-1], at[1:], tails, proto)))
    return out


def state_sharding_tree(mesh: Mesh, row_status_mask: bool = False):
    """A ReconcileState of :class:`Layout`s — THE single source of truth
    for how reconcile state lies on a mesh (used by :func:`shard_state`
    and the serving core).

    rows [B, S]     -> (rows over hosts x tenants, columns over slots)
    flags [B]       -> rows
    slot mask [S]   -> columns over slots, on every row shard
    placement [R,*] -> rows (of R)
    labels [B, L]   -> rows
    selectors [C]   -> replicated on every row shard

    ``row_status_mask`` selects the [B, S] per-row mask layout (the fused
    serving core's heterogeneous-vocabulary buckets)."""
    from ..models.reconcile_model import ReconcileState

    del mesh  # the layout is the same on every mesh; blocks follow its grid
    return ReconcileState(
        up_vals=ROWS, up_exists=FLAGS, down_vals=ROWS, down_exists=FLAGS,
        status_mask=ROWS if row_status_mask else SLOT_MASK,
        replicas=FLAGS, avail=FLAGS, current=FLAGS,
        pair_hashes=FLAGS, sel_hashes=REPLICATED,
    )


def shard_state(state, mesh: Mesh):
    """A ReconcileState (numpy arrays, as ``example_state`` gives, or
    tensors) as a ReconcileState of :class:`ShardedTensor` on ``mesh``:
    uint32 lanes become int32 bit views, every block is a copy."""
    from ..models.reconcile_model import to_device

    tree = state_sharding_tree(mesh, row_status_mask=np.ndim(state.status_mask) == 2)
    cpu = torch.device("cpu")
    return type(tree)(*(
        ShardedTensor.put(a if isinstance(a, torch.Tensor) else to_device(a, cpu),
                          mesh, lay)
        for a, lay in zip(state, tree)))


def gather_state(state):
    """A sharded ReconcileState back as whole tensors on the lead device
    (tests and debugging)."""
    return type(state)(*(t.full() for t in state))
