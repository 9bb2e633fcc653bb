"""The port's decide_and_match against the Pallas kernel and the un-fused
lanes.

On the CPU the port's wrapper takes its plain PyTorch version (the
tensors lie on the CPU); it is checked against the JAX Pallas kernel in
interpret mode and against ``sync_decisions`` + ``fanout_match`` for
every case of ``tests/test_pallas.py`` that is not about a mesh. All
outputs are integers: exact equality. The CUDA kernel itself runs only
on a card: ``tests/test_torch_cuda.py``.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcp_tpu.ops.diff import sync_decisions
from kcp_tpu.ops.labelmatch import fanout_match
from kcp_tpu.ops.pallas_kernels import decide_and_match as pallas_decide_and_match
from kcp_tpu_torch.ops import cuda_kernels
from kcp_tpu_torch.ops.cuda_kernels import decide_and_match


def t(a, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _random_case(rng, b=256, s=64, l=8, c=16):
    up = rng.integers(1, 2**32, size=(b, s), dtype=np.uint32)
    down = up.copy()
    dirty = rng.random(b) < 0.3
    down[dirty] ^= rng.integers(0, 2, size=(dirty.sum(), s), dtype=np.uint32) * 7
    upe = rng.random(b) < 0.9
    dne = rng.random(b) < 0.85
    mask = np.zeros(s, dtype=bool)
    mask[s // 2:] = True
    sel = rng.integers(1, 1000, size=c, dtype=np.uint32)
    pair = rng.integers(1, 1000, size=(b, l), dtype=np.uint32)
    return up, upe, down, dne, mask, pair, sel


def _port(case, device="cpu"):
    out = decide_and_match(*(t(a, device) for a in case))
    return tuple(o.cpu().numpy() for o in out)


def _reference_lanes(up, upe, down, dne, mask, pair, sel):
    ref = sync_decisions(jnp.asarray(up), jnp.asarray(upe), jnp.asarray(down),
                         jnp.asarray(dne), jnp.asarray(mask))
    match = np.asarray(fanout_match(jnp.asarray(pair), jnp.asarray(sel)))
    return (np.asarray(ref.decision), np.asarray(ref.status_upsync),
            (match & upe[:, None]).sum(axis=0).astype(np.int32))


def _assert_outputs_equal(got, want):
    for name, g, w in zip(("decision", "upsync", "counts"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.bool_
    assert got[2].dtype == np.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_pallas_kernel_and_reference_ops(seed):
    case = _random_case(np.random.default_rng(seed))
    got = _port(case)
    _assert_outputs_equal(got, pallas_decide_and_match(*case, block_rows=64,
                                                       interpret=True))
    _assert_outputs_equal(got, _reference_lanes(*case))


@pytest.mark.parametrize("seed", [0, 5])
def test_per_row_mask_matches_pallas_kernel(seed):
    rng = np.random.default_rng(seed)
    up, upe, down, dne, _mask, pair, sel = _random_case(rng)
    rowmask = rng.random(up.shape) < 0.4
    case = (up, upe, down, dne, rowmask, pair, sel)
    got = _port(case)
    _assert_outputs_equal(got, pallas_decide_and_match(*case, block_rows=64,
                                                       interpret=True))
    _assert_outputs_equal(got, _reference_lanes(*case))


@pytest.mark.parametrize("block_rows", [32, 128])
def test_block_decomposition_does_not_matter(block_rows):
    """The Pallas kernel at any block size agrees with the port, which
    has no block-size argument at all."""
    case = _random_case(np.random.default_rng(3), b=128)
    _assert_outputs_equal(_port(case), pallas_decide_and_match(
        *case, block_rows=block_rows, interpret=True))


@pytest.mark.parametrize("b", [96, 131, 1])
def test_any_b_works_port_side(b):
    """B that is not a multiple of 128 (the Pallas kernel raises for
    B % block_rows != 0; the port takes any B, as ragged fleet sums
    need)."""
    case = _random_case(np.random.default_rng(4), b=b)
    _assert_outputs_equal(_port(case), _reference_lanes(*case))
    with pytest.raises(ValueError, match="not divisible"):
        pallas_decide_and_match(*_random_case(np.random.default_rng(4), b=96),
                                block_rows=64, interpret=True)


def test_all_decision_codes_reachable():
    s = 8
    up = np.full((4, s), 5, dtype=np.uint32)
    down = up.copy()
    down[1, 0] = 99
    case = (up, np.array([True, True, False, True]), down,
            np.array([False, True, True, True]), np.zeros(s, bool),
            np.zeros((4, 2), np.uint32), np.zeros(2, np.uint32))
    decision, upsync, counts = _port(case)
    assert decision.tolist() == [1, 2, 3, 0]
    assert not upsync.any()
    # zero hashes match zero selectors: every resident up row counts
    assert counts.tolist() == [3, 3]
    _assert_outputs_equal((decision, upsync, counts),
                          pallas_decide_and_match(*case, block_rows=4, interpret=True))


def test_status_lane_triggers_upsync_not_update():
    s = 8
    up = np.full((2, s), 5, dtype=np.uint32)
    down = up.copy()
    mask = np.zeros(s, dtype=bool)
    mask[4:] = True
    down[0, 6] = 99
    case = (up, np.array([True, True]), down, np.array([True, True]), mask,
            np.zeros((2, 2), np.uint32), np.zeros(2, np.uint32))
    decision, upsync, _ = _port(case)
    assert decision.tolist() == [0, 0]
    assert upsync.tolist() == [True, False]


def test_matches_reconcile_step_lane():
    """The port's kernel on the post-scatter mirrors agrees with the JAX
    model's fan-out and decision lanes."""
    import jax

    from kcp_tpu.models.reconcile_model import example_deltas, example_state, reconcile_step
    from kcp_tpu.ops.diff import apply_deltas

    state = example_state(b=128, s=16, r=8, p=4, l=4, c=8, seed=5)
    deltas = example_deltas(b=128, s=16, d=16, seed=6)
    st = jax.tree.map(jnp.asarray, state)
    dl = jax.tree.map(jnp.asarray, deltas)
    _, out = reconcile_step(st, dl)
    upv, upe = apply_deltas(st.up_vals, st.up_exists, dl.idx, dl.vals,
                            dl.exists, dl.valid & ~dl.side)
    dnv, dne = apply_deltas(st.down_vals, st.down_exists, dl.idx, dl.vals,
                            dl.exists, dl.valid & dl.side)
    got = _port((np.asarray(upv), np.asarray(upe), np.asarray(dnv),
                 np.asarray(dne), state.status_mask, state.pair_hashes,
                 state.sel_hashes))
    _assert_outputs_equal(got, (out.decision, out.status_upsync, out.match_counts))


def test_step_matches_jax_step_with_and_without_pallas():
    """The port's step (always decide_and_match) equals the JAX step on
    both of its lanes: the Pallas kernel and the XLA composition."""
    import jax

    from kcp_tpu.models.reconcile_model import (
        example_deltas, example_state, reconcile_step,
    )
    from kcp_tpu_torch.models import reconcile_model as tm

    state = example_state(b=256, s=64, r=16, p=4, l=8, c=16, dirty_frac=0.2)
    deltas = example_deltas(b=256, s=64, d=32)
    step = jax.jit(reconcile_step, static_argnames=("use_pallas",))
    _, ref = step(state, deltas)
    _, ref_pl = step(state, deltas, use_pallas=True)
    _, got = tm.reconcile_step(tm.state_from_numpy(state, "cpu"),
                               tm.deltas_from_numpy(deltas, "cpu"))
    for name in ref._fields:
        g = getattr(got, name).numpy()
        np.testing.assert_array_equal(g, np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_array_equal(g, np.asarray(getattr(ref_pl, name)), err_msg=name)


def test_served_core_matches_jax_core_on_the_pallas_lane():
    """Port FusedCore vs a JAX FusedCore serving through the Pallas kernel:
    identical patch streams. Per-bucket dispatch, so the 512-row bucket
    passes the reference's B % 128 gate and really runs the kernel."""
    from test_torch_core import _lockstep

    async def main():
        ref, ref_ticks = await _lockstep("jax", "double", False, 3, steps=6,
                                         pallas=True)
        got, got_ticks = await _lockstep("torch", "double", False, 3, steps=6)
        assert got == ref and got_ticks == ref_ticks

    asyncio.run(main())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA path validates device, dtype, shape and layout before any
    launch (the checks run on any device)."""
    case = [t(a) for a in _random_case(np.random.default_rng(0), b=8, s=4, l=1, c=2)]
    cuda_kernels._check(*case)  # well-formed
    bad_dtype = list(case)
    bad_dtype[0] = case[0].to(torch.int64)
    with pytest.raises(TypeError):
        cuda_kernels._check(*bad_dtype)
    bad_shape = list(case)
    bad_shape[4] = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_kernels._check(*bad_shape)
    strided = list(case)
    strided[0] = torch.zeros((4, 8), dtype=torch.int32).t()
    strided[2] = strided[0].clone()
    with pytest.raises(ValueError, match="contiguous|down_vals"):
        cuda_kernels._check(*strided)
    meta = [x.to("meta") for x in case]
    with pytest.raises(ValueError, match="unsupported device"):
        decide_and_match(*meta)


def test_launch_counts_are_exact_across_threads():
    """Each server loop of a fleet in one process launches from its own
    thread: the wrapper's count loses no launch when many threads count
    at once, and each thread's share is its own."""
    import sys
    import threading

    wrapper = type("Wrapper", (), {"launches": 0, "by_thread": {}})
    n_threads, per_thread = 16, 2000
    seen = {}
    # every thread lives until all have counted: idents of live threads differ
    done = threading.Barrier(n_threads, timeout=60)

    def count(i):
        for _ in range(per_thread):
            cuda_kernels._count(wrapper, 1)
        cuda_kernels._count(wrapper, 0)
        seen[i] = threading.get_ident()
        done.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert wrapper.launches == n_threads * per_thread
    assert {wrapper.by_thread[tid] for tid in seen.values()} == {per_thread}
