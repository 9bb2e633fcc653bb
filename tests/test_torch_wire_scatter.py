"""The packed step's wire side lanes and delta scatters: the
``wire_scatter`` CUDA kernel (``kcp_tpu_torch/csrc/wire_scatter.cu``)
against the torch path that the step takes on the CPU.

Every case is a seeded wire with one feature in front: padding entries,
row indices that wrap from the end or fall outside the rows, acks all -1
padding, acks of real rows, an acked row that a down delta also hits (the
delta wins), an acked row that an up delta also hits (the copy takes the
up row from before the delta), a bucket-wide [S] mask, an empty wire, and
the per-bucket step's wire without segment lane or acks.

On the CPU (no card): the wrapper refuses CPU tensors, wrong dtypes,
shapes and non-contiguous inputs before it loads the library; and the
packed step takes the torch path, which launches nothing, gives the
mirrors a plain numpy loop over the wire gives, and gives the JAX
reference's wire and state byte for byte on every case.

On the card (marker ``cuda``): the kernel's two launches leave every
mirror, the mask, the segment lane and the count byte-equal to the torch
path's on the same card, at 1,048,576 rows and at a small B; a packed
step launches the kernel twice, and the steps that keep the torch path
(an unpacked ``ReconcileDeltas``, a mesh) never. The card tests import
neither JAX nor the JAX package, so on a machine without JAX they run
alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wire_scatter.py

All outputs are integers: every comparison is exact equality.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops import cuda_kernels
from kcp_tpu_torch.ops.cuda_kernels import wire_scatter
from kcp_tpu_torch.ops.diff import apply_deltas

KINDS = ("mixed", "wrap", "acks_padding", "ack_down_delta", "ack_up_delta",
         "bucket_mask", "empty_wire", "no_side_lanes")
SEG_CAP = 8
WIRE_D = 64  # every case's wire depth but the empty one's (one JAX compile a form)


@functools.lru_cache(maxsize=4)
def _state(b: int, s: int, per_row: bool) -> tm.ReconcileState:
    """A seeded numpy state: both mirrors, some rows absent on either side,
    a per-row [B, S] or bucket-wide [S] mask."""
    rng = np.random.default_rng(b * 7 + s)
    state = tm.example_state(b=b, s=s, r=16, p=4, l=1, c=8,
                             seed=int(rng.integers(1 << 30)), dirty_frac=0.3)
    state = state._replace(up_exists=rng.random(b) < 0.9, down_exists=rng.random(b) < 0.9)
    if per_row:
        state = state._replace(status_mask=rng.random((b, s)) < 0.25)
    return state


def _case(kind: str, b: int, s: int, seed: int = 0):
    """(numpy state, seg_ids int32 [B] or None, packed uint32 [D, S+2],
    acks int32 [A] or None) of one case. No two valid entries of one lane
    share a row (the host's contract); padding may point anywhere."""
    rng = np.random.default_rng([seed, KINDS.index(kind), b, s])
    state = _state(b, s, kind != "bucket_mask")
    pool = iter(rng.permutation(b)[:200].tolist())
    entries = []

    def entry(idx: int, flags: int, vals=None) -> int:
        v = rng.integers(0, 2**32, s, dtype=np.uint32) if vals is None else vals
        entries.append((v, idx & 0xFFFFFFFF, flags))
        return idx

    def stamp_flags(seg: int) -> int:
        return 4 | tm.MASK_STAMP_BIT | (seg << tm.SEG_SHIFT)

    up_rows, down_rows = [], []
    if kind != "empty_wire":
        for _ in range(12):
            up_rows.append(entry(next(pool), 4 | int(rng.random() < 0.8)))
            down_rows.append(entry(next(pool), 4 | 2 | int(rng.random() < 0.8)))
        # padding: the valid bit clear, aimed at rows the deltas hit too
        for r in (up_rows[0], down_rows[0], next(pool), -1, b + 3):
            entry(r, int(rng.integers(0, 4)) | int(rng.integers(0, 2)) * tm.MASK_STAMP_BIT)
        # mask stamps with segment ids, one out of range, one of all 16 bits
        for seg in (1, 5, SEG_CAP + 2, tm.SEG_NONE):
            vals = (rng.random(s) < 0.3).astype(np.uint32) * rng.integers(1, 9, s, dtype=np.uint32)
            entry(next(pool), stamp_flags(seg), vals)
    if kind == "wrap":
        for flags in (4 | 1, 4 | 2 | 1, stamp_flags(3)):
            entry(next(pool) - b, flags)  # counts from the end
            for far in (b, b + 7, -b - 1, 2**31 - 1, -2**31):  # drops
                entry(far, flags)
    acks = np.full(64, -1, np.int32)
    real = [next(pool) for _ in range(6)]
    if kind == "ack_down_delta":
        real[0] = down_rows[1]
    if kind == "ack_up_delta":
        real[0] = up_rows[1]
    if kind != "acks_padding":
        acks[:len(real)] = real
    if kind == "wrap":
        acks[len(real):len(real) + 4] = (-2, -b, b, b + 3)  # negative acks never wrap
    d = 0 if kind == "empty_wire" else WIRE_D
    assert len(entries) <= d or d == 0
    packed = np.zeros((d, s + 2), np.uint32)
    for i, (v, idx, flags) in enumerate(entries):
        packed[i, :s], packed[i, s], packed[i, s + 1] = v, idx, flags
    rng.shuffle(packed)
    if kind == "no_side_lanes":
        return state, None, packed, None
    seg = rng.integers(0, SEG_CAP + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.1] = tm.SEG_NONE
    return state, seg, packed, acks


def _expected(state, seg, packed, acks):
    """The side lanes and delta scatters as a plain loop over the wire:
    (up_vals, up_exists, down_vals, down_exists, status_mask, seg_ids,
    applied) after the step's first stage."""
    up, upe = state.up_vals.view(np.int32).copy(), state.up_exists.copy()
    down, dne = state.down_vals.view(np.int32).copy(), state.down_exists.copy()
    mask = state.status_mask.copy()
    seg = None if seg is None else seg.copy()
    b, s = up.shape
    wire = packed.view(np.int32)

    def row(i):
        r = int(wire[i, s])
        r = r + b if r < 0 else r
        return r if 0 <= r < b else None

    for i in range(wire.shape[0]):
        f = int(wire[i, s + 1])
        if f & 4 and f & tm.MASK_STAMP_BIT and (r := row(i)) is not None:
            if seg is not None:
                seg[r] = (f >> tm.SEG_SHIFT) & tm.SEG_FIELD_MASK
            if mask.ndim == 2:
                mask[r] = wire[i, :s] != 0
    for a in [] if acks is None else acks.tolist():
        if 0 <= a < b:
            down[a], dne[a] = up[a], upe[a]
    applied = 0
    for i in range(wire.shape[0]):
        f = int(wire[i, s + 1])
        if f & 4 and not f & tm.MASK_STAMP_BIT:
            applied += 1
            if (r := row(i)) is not None:
                vals, ex = (down, dne) if f & 2 else (up, upe)
                vals[r], ex[r] = wire[i, :s], bool(f & 1)
    return up, upe, down, dne, mask, seg, applied


def _lanes(st, seg) -> tuple:
    return (st.up_vals, st.up_exists, st.down_vals, st.down_exists, st.status_mask,
            *(() if seg is None else (seg,)))


def _torch_path(st, seg, packed, acks) -> torch.Tensor:
    """The step's first stage as the CPU step runs it, on any device."""
    tm.apply_side_lanes_plain(st, packed, acks, seg)
    d = tm.unpack_deltas(packed)
    apply_deltas(st.up_vals, st.up_exists, d.idx, d.vals, d.exists, d.valid & ~d.side)
    apply_deltas(st.down_vals, st.down_exists, d.idx, d.vals, d.exists, d.valid & d.side)
    return d.valid.sum(dtype=torch.int32)


def _kernel_path(st, seg, packed, acks) -> torch.Tensor:
    wire_scatter("stamps", packed, st.up_vals, st.up_exists, st.down_vals, st.down_exists,
                 st.status_mask, seg, acks)
    return wire_scatter("deltas", packed, st.up_vals, st.up_exists, st.down_vals,
                        st.down_exists)[0]


def _on(case, device):
    state, seg, packed, acks = case
    return (tm.state_from_numpy(state, device),
            None if seg is None else tm.to_device(seg, device),
            tm.to_device(packed, device),
            None if acks is None else tm.to_device(acks, device))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def _cpu_args(b=8, s=4):
    return dict(packed=torch.zeros((4, s + 2), dtype=torch.int32),
                up_vals=torch.zeros((b, s), dtype=torch.int32),
                up_exists=torch.zeros(b, dtype=torch.bool),
                down_vals=torch.zeros((b, s), dtype=torch.int32),
                down_exists=torch.zeros(b, dtype=torch.bool),
                status_mask=torch.zeros((b, s), dtype=torch.bool),
                seg_ids=torch.zeros(b, dtype=torch.int32),
                acks=torch.full((16,), -1, dtype=torch.int32))


REFUSALS = {
    "cpu_tensors": ({}, ValueError, "CUDA tensors"),
    "packed_int64": ({"packed": torch.zeros((4, 6), dtype=torch.int64)}, TypeError, "int32"),
    "packed_1d": ({"packed": torch.zeros(6, dtype=torch.int32)}, TypeError, "packed"),
    "packed_strided": ({"packed": torch.zeros((4, 12), dtype=torch.int32)[:, ::2]},
                       ValueError, "packed is not contiguous"),
    "up_vals_uint8": ({"up_vals": torch.zeros((8, 4), dtype=torch.uint8)}, TypeError, "up_vals"),
    "down_vals_transposed": ({"down_vals": torch.zeros((4, 8), dtype=torch.int32).t()},
                             ValueError, "down_vals is not contiguous"),
    "down_vals_shape": ({"down_vals": torch.zeros((8, 5), dtype=torch.int32)},
                        ValueError, "down_vals must be"),
    "up_exists_int32": ({"up_exists": torch.zeros(8, dtype=torch.int32)}, TypeError, "up_exists"),
    "mask_strided": ({"status_mask": torch.zeros((8, 8), dtype=torch.bool)[:, ::2]},
                     ValueError, "status_mask is not contiguous"),
    "seg_ids_int64": ({"seg_ids": torch.zeros(8, dtype=torch.int64)}, TypeError, "seg_ids"),
    "acks_2d": ({"acks": torch.full((4, 4), -1, dtype=torch.int32)}, ValueError, "acks must"),
    "stage": ({"stage": "mask"}, ValueError, "stage"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses_before_loading_the_library(name, monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(cuda_kernels, "_load", no_load)
    monkeypatch.setattr(cuda_kernels, "build", no_load)
    change, exc, words = REFUSALS[name]
    args = {"stage": "stamps", **_cpu_args(), **change}
    before = wire_scatter.launches
    with pytest.raises(exc, match=words):
        wire_scatter(args.pop("stage"), **args)
    if name in ("cpu_tensors", "packed_int64"):  # the deltas stage checks alike
        args = {**_cpu_args(), **change}
        for key in ("status_mask", "seg_ids", "acks"):
            del args[key]
        with pytest.raises(exc, match=words):
            wire_scatter("deltas", **args)
    assert wire_scatter.launches == before


@functools.cache
def _jax_steps():
    import jax

    from kcp_tpu.models import reconcile_model as jm

    return (jax.jit(jm.reconcile_step_packed, static_argnames=("patch_capacity",)),
            jax.jit(jm.reconcile_step_fleet, static_argnames=("patch_capacity",
                                                              "seg_capacity")))


@pytest.mark.parametrize("kind", KINDS)
def test_packed_step_on_cpu_takes_the_torch_path(kind):
    """No launch; the mirrors of a plain loop over the wire; the JAX
    reference's wire and state, byte for byte."""
    import jax
    import jax.numpy as jnp

    b, s, cap = 300, 33, 64
    case = _case(kind, b, s)
    state, seg, packed, acks = case
    st, sg, pk, ak = _on(case, "cpu")
    before = wire_scatter.launches
    if sg is None:
        st, wire = tm.reconcile_step_packed(st, pk, ak, patch_capacity=cap)
    else:
        st, sg, wire = tm.reconcile_step_fleet(st, sg, pk, ak, patch_capacity=cap,
                                               seg_capacity=SEG_CAP)
    assert wire_scatter.launches == before
    up, upe, down, dne, mask, want_seg, applied = _expected(state, seg, packed, acks)
    for name, got, want in (("up_vals", st.up_vals, up), ("up_exists", st.up_exists, upe),
                            ("down_vals", st.down_vals, down),
                            ("down_exists", st.down_exists, dne),
                            ("status_mask", st.status_mask, mask)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if sg is not None:
        np.testing.assert_array_equal(sg.numpy(), want_seg)
    assert int(wire[2 + 7]) == applied  # stats[7]
    packed_jax, fleet_jax = _jax_steps()
    jstate = jax.tree.map(jnp.asarray, state)
    jacks = None if acks is None else jnp.asarray(acks)
    if seg is None:
        jstate, jwire = packed_jax(jstate, jnp.asarray(packed), jacks, patch_capacity=cap)
    else:
        jstate, jseg, jwire = fleet_jax(jstate, jnp.asarray(seg), jnp.asarray(packed), jacks,
                                        patch_capacity=cap, seg_capacity=SEG_CAP)
        np.testing.assert_array_equal(sg.numpy(), np.asarray(jseg))
    assert tm.wire_to_numpy(wire).tobytes() == np.asarray(jwire).tobytes()
    for name in tm.ReconcileState._fields:
        want = np.asarray(getattr(jstate, name))
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(getattr(st, name).numpy(), want, err_msg=name)


@pytest.mark.parametrize("kind", ["ack_down_delta", "ack_up_delta", "wrap", "acks_padding"])
def test_cases_are_not_vacuous(kind):
    """The feature a case puts in front shows in the expected mirrors."""
    b, s = 300, 33
    state, seg, packed, acks = _case(kind, b, s)
    up, _upe, down, _dne, _mask, _seg, _applied = _expected(state, seg, packed, acks)
    before_up = state.up_vals.view(np.int32)
    wire = packed.view(np.int32)
    rows = {int(r): i for i, r in enumerate(wire[:, s])
            if wire[i, s + 1] & 4 and not wire[i, s + 1] & tm.MASK_STAMP_BIT}
    if kind in ("ack_down_delta", "ack_up_delta"):
        r = int(acks[0])
        np.testing.assert_array_equal(
            down[r], wire[rows[r], :s] if kind == "ack_down_delta" else before_up[r])
        if kind == "ack_up_delta":
            np.testing.assert_array_equal(up[r], wire[rows[r], :s])
            assert not np.array_equal(before_up[r], up[r])
    elif kind == "wrap":
        wrapped = [i for r, i in rows.items() if -b <= r < 0]
        assert len(wrapped) == 2
        for i in wrapped:
            lane = down if wire[i, s + 1] & 2 else up
            np.testing.assert_array_equal(lane[int(wire[i, s]) + b], wire[i, :s])
    else:  # all padding: only the down deltas move the down mirror
        assert (acks == -1).all()
        keep = np.ones(b, bool)
        keep[[r for r, i in rows.items() if wire[i, s + 1] & 2]] = False
        assert keep.sum() == b - 12
        np.testing.assert_array_equal(down[keep], state.down_vals.view(np.int32)[keep])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,s", [(1_048_576, 64), (1000, 33)], ids=["fleet_rows", "small"])
def test_kernel_equals_torch_path(cuda_device, kind, b, s):
    case = _case(kind, b, s, seed=1)
    kern, torch_side = _on(case, cuda_device), _on(case, cuda_device)
    before = wire_scatter.launches
    mine = wire_scatter.by_thread.get(threading.get_ident(), 0)
    got_applied = _kernel_path(*kern)
    want_applied = _torch_path(*torch_side)
    torch.cuda.synchronize()
    assert wire_scatter.launches == before + 2
    assert wire_scatter.by_thread[threading.get_ident()] == mine + 2
    assert int(got_applied) == int(want_applied)
    for got, want in zip(_lanes(kern[0], kern[1]), _lanes(torch_side[0], torch_side[1])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    if b <= 4096:  # the plain loop, too, where it is quick
        want = _expected(*case)
        assert int(got_applied) == want[6]
        np.testing.assert_array_equal(kern[0].down_vals.cpu().numpy(), want[2])


@pytest.mark.cuda
def test_packed_steps_launch_the_kernel_twice(cuda_device):
    """Two launches a packed step, fleet or per-bucket, and the card's
    wire equals the CPU's; the unpacked step and the sharded step keep the
    torch scatters."""
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, mesh_from_spec, shard_state

    b, s, cap = 4096, 64, 256
    for kind in ("mixed", "no_side_lanes"):
        case = _case(kind, b, s, seed=2)
        wires = []
        for dev in (cuda_device, torch.device("cpu")):
            st, sg, pk, ak = _on(case, dev)
            before = wire_scatter.launches
            if sg is None:
                _st, wire = tm.reconcile_step_packed(st, pk, ak, patch_capacity=cap)
            else:
                _st, _sg, wire = tm.reconcile_step_fleet(st, sg, pk, ak, patch_capacity=cap,
                                                         seg_capacity=SEG_CAP)
            wires.append(tm.wire_to_numpy(wire))
            assert wire_scatter.launches == before + (2 if dev.type == "cuda" else 0), kind
        assert wires[0].tobytes() == wires[1].tobytes(), kind
    state, seg, packed, acks = _case("mixed", b, s, seed=3)
    before = wire_scatter.launches
    st = tm.state_from_numpy(state, cuda_device)
    tm.reconcile_step(st, tm.unpack_deltas(tm.to_device(packed, cuda_device)),
                      patch_capacity=cap)
    mesh = mesh_from_spec("4", devices=[cuda_device] * 4)
    tm.reconcile_step_fleet(shard_state(state, mesh),
                            ShardedTensor.put(tm.to_device(seg, cuda_device), mesh, FLAGS),
                            tm.to_device(packed, cuda_device), tm.to_device(acks, cuda_device),
                            patch_capacity=cap, seg_capacity=SEG_CAP, mesh=mesh)
    torch.cuda.synchronize()
    assert wire_scatter.launches == before
