"""The port's multi-process serving mesh (``torch.distributed``, gloo) on
the CPU, against the one-process mesh run.

The reference's multi-controller program (``kcp_tpu.parallel.distributed``
with ``jax.distributed``) runs the same step in every process on the same
staged wire; each process holds only its own ``hosts`` block of row shards,
and every process gets back the same ``int32`` wire. Here two ranks run as
subprocesses on ``127.0.0.1`` and a free port, each with its block of a
``2x2x1`` or ``2x1x2`` mesh over repeated ``cpu`` devices, and drive three
seeded fleet ticks (acks with padding, mask and segment stamps, an
overflowing tick; per-row and bucket-wide masks; a B that does not divide
by the row factor): each rank's wires equal the one-process mesh run's
byte for byte, and so does every state tensor gathered back across the
ranks. The one-process mesh run is held against the JAX mesh step by
``test_torch_mesh.py::test_sharded_fleet_wires_byte_equal_jax_mesh_and_unsharded``.
A rank also checks that ``init_distributed`` formed a world of 2 and that
``mesh_from_spec("auto")`` spans it (``hosts`` = 2); ``form_world_of_two``
is ``test_torch_mesh.py::test_distributed_arg_assembly``'s check that a
world above 1 forms the group. Every collective has a
timeout, and the ranks are killed if the test runs out of time.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.parallel import mesh as pmesh

from test_torch_model import _fuzz_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = r"""
import json, sys
sys.path.insert(0, REPO)
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.parallel.distributed import init_distributed

init_distributed(device="cpu")
rank = dist.get_rank()
got = {"world": dist.get_world_size(), "rank": rank, "backend": dist.get_backend()}
auto = pmesh.mesh_from_spec("auto", devices=["cpu"])
got["auto"] = [auto.shape, auto.process, auto.local_rows]
case = np.load(CASE)
t, s = (int(x) for x in SPEC.split("x")[1:])
mesh = pmesh.mesh_from_spec(SPEC, devices=["cpu"] * (t * s))
got["mesh"] = [mesh.shape, mesh.process, mesh.local_rows]
state = tm.ReconcileState(*(case[f] for f in tm.ReconcileState._fields))
sstate = pmesh.shard_state(state, mesh)
sseg = pmesh.ShardedTensor.put(torch.from_numpy(case["seg"]), mesh, pmesh.FLAGS)
out = {}
for tick, cap in enumerate(case["caps"].tolist()):
    sstate, sseg, sw = tm.reconcile_step_fleet(
        sstate, sseg, torch.from_numpy(case[f"packed{tick}"]),
        torch.from_numpy(case[f"acks{tick}"]), patch_capacity=cap,
        seg_capacity=int(case["seg_cap"]), mesh=mesh)
    out[f"wire{tick}"] = tm.wire_to_numpy(sw)
for name, full in zip(tm.ReconcileState._fields, pmesh.gather_state(sstate)):
    out[name] = full.numpy()
out["seg"] = sseg.full().numpy()
np.savez(OUT % rank, **out)
dist.destroy_process_group()
print(json.dumps(got))
"""


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(code: str, world: int = 2, timeout: float = 240.0,
              env_extra: dict | None = None) -> list[dict]:
    """``code`` in ``world`` rank subprocesses of one gloo group on
    127.0.0.1: each rank's last stdout line as JSON. Every rank is killed
    if any outlives ``timeout``."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    procs = [subprocess.Popen([sys.executable, "-I", "-c", code], cwd=REPO,
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank exit {p.returncode}: {err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _err in outs]


def _case(per_row_mask: bool, b: int, path) -> dict:
    rng = np.random.default_rng(43)
    s, seg_cap = 16, 16
    state, _seg, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
    seg = (np.arange(b) // 100).astype(np.int32)  # runs straddle the shard boundaries
    seg[rng.random(b) < 0.05] = tm.SEG_NONE
    case = {f: np.asarray(getattr(state, f)) for f in tm.ReconcileState._fields}
    case.update(seg=seg, seg_cap=np.int32(seg_cap), caps=np.array([1024, 8, 1024]))
    for tick in range(3):
        if tick:
            _s, _g, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
        case[f"packed{tick}"] = packed.view(np.int32)
        case[f"acks{tick}"] = acks
    np.savez(path, **case)
    return case


def _one_process(spec: str, case: dict) -> dict:
    """The same ticks on the one-process mesh of ``spec`` over 8 ``cpu``s."""
    mesh = pmesh.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
    state = tm.ReconcileState(*(case[f] for f in tm.ReconcileState._fields))
    sstate = pmesh.shard_state(state, mesh)
    sseg = pmesh.ShardedTensor.put(torch.from_numpy(case["seg"].copy()), mesh, pmesh.FLAGS)
    out = {}
    for tick, cap in enumerate(case["caps"].tolist()):
        sstate, sseg, sw = tm.reconcile_step_fleet(
            sstate, sseg, torch.from_numpy(case[f"packed{tick}"]),
            torch.from_numpy(case[f"acks{tick}"]), patch_capacity=cap,
            seg_capacity=int(case["seg_cap"]), mesh=mesh)
        out[f"wire{tick}"] = tm.wire_to_numpy(sw)
    for name, full in zip(tm.ReconcileState._fields, pmesh.gather_state(sstate)):
        out[name] = full.numpy()
    out["seg"] = sseg.full().numpy()
    return out


@pytest.mark.parametrize("spec,per_row_mask,b", [
    ("2x2x1", True, 1024), ("2x2x1", False, 1024), ("2x1x2", True, 1024),
    ("2x1x2", False, 1024), ("2x2x1", True, 1030), ("2x1x2", False, 1027),
], ids=["2x2x1-row_mask", "2x2x1-bucket_mask", "2x1x2-row_mask", "2x1x2-bucket_mask",
        "2x2x1-row_mask-B1030", "2x1x2-bucket_mask-B1027"])
def test_two_gloo_ranks_wires_byte_equal_the_one_process_mesh(spec, per_row_mask, b,
                                                               tmp_path):
    case = _case(per_row_mask, b, tmp_path / "case.npz")
    want = _one_process(spec, case)
    assert bool(want["wire1"][1]), "overflow coverage went vacuous"
    code = (_RANK.replace("REPO", repr(REPO)).replace("CASE", repr(str(tmp_path / "case.npz")))
            .replace("SPEC", repr(spec)).replace("OUT", repr(str(tmp_path / "rank%d.npz"))))
    got = run_ranks(code)
    t, s = (int(x) for x in spec.split("x")[1:])
    for rank, info in enumerate(got):
        assert info["world"] == 2 and info["rank"] == rank and info["backend"] == "gloo"
        assert info["auto"] == [{"hosts": 2, "tenants": 1, "slots": 1}, rank, [rank]], info
        rows = list(range(rank * t, (rank + 1) * t))
        assert info["mesh"] == [{"hosts": 2, "tenants": t, "slots": s}, rank, rows], info
        out = np.load(tmp_path / f"rank{rank}.npz")
        for name, arr in want.items():
            assert out[name].tobytes() == arr.tobytes(), (rank, name)


def form_world_of_two() -> None:
    """What ``kcp start --distributed --num-processes 2`` does first: the
    environment's coordinator, world size and rank form a gloo group of
    two (the second call finds it formed)."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import torch.distributed as dist\n"
            "from kcp_tpu_torch.parallel.distributed import init_distributed\n"
            "kw = init_distributed(device='cpu'); init_distributed(device='cpu')\n"
            "got = [kw, dist.get_world_size(), dist.get_rank(), dist.get_backend()]\n"
            "dist.destroy_process_group()\n"
            "print(json.dumps(got))\n" % REPO)
    for rank, (kw, world, r, backend) in enumerate(run_ranks(code)):
        assert kw["world_size"] == 2 and kw["rank"] == rank, kw
        assert kw["init_method"].startswith("tcp://127.0.0.1:"), kw
        assert (world, r, backend) == (2, rank, "gloo")


_SOLVE = r"""
import json, sys
sys.path.insert(0, REPO)
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from kcp_tpu_torch.fleet import solver
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.parallel.distributed import init_distributed

init_distributed(device="cpu")
x = np.load(CASE)
mesh = pmesh.mesh_from_spec("2x2x1", devices=["cpu"] * 2)
out = solver.solve_sharded(mesh, x["demand"], x["cand"], x["alloc"], x["region"],
                           x["home"], 2)
dist.destroy_process_group()
print(json.dumps([out.dtype.str, list(out.shape), out.tobytes().hex()]))
"""


def test_two_gloo_ranks_solve_equals_the_unsharded_solve(tmp_path):
    """The fleet solver's sharded full solve over a ``2x2x1`` mesh whose
    hosts are two processes, with a row count that is not a multiple of
    the row factor: every rank returns the whole unsharded assignment."""
    from kcp_tpu_torch.fleet import solver

    rng = np.random.default_rng(5)
    w, p = 1001, 8
    x = {"demand": rng.integers(1, 60, w).astype(np.int32),
         "cand": rng.random((w, p)) < 0.8,
         "alloc": rng.integers(500, 5000, p).astype(np.int32),
         "region": rng.integers(0, 3, p).astype(np.int32),
         "home": rng.integers(-1, 3, w).astype(np.int32)}
    np.savez(tmp_path / "solve.npz", **x)
    whole = solver.FleetSolver(spread=2, device="cpu").solve(
        x["demand"], x["cand"], x["alloc"], x["region"], x["home"])
    code = _SOLVE.replace("REPO", repr(REPO)).replace("CASE", repr(str(tmp_path / "solve.npz")))
    for dtype, shape, data in run_ranks(code):
        assert dtype == whole.dtype.str and shape == list(whole.shape)
        assert bytes.fromhex(data) == whole.tobytes()


def test_kcp_start_distributed_serves_on_the_auto_mesh():
    """``kcp start --distributed --num-processes 2 --mesh auto`` in two
    processes (controllers on the CPU): the group forms, each process
    serves with the hosts-major mesh (hosts = 2), and each answers
    ``/readyz`` and exits 0 on SIGTERM."""
    import signal
    import urllib.request

    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("KCP_")
           and k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(KCP_DEVICE="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kcp_tpu_torch.cli.kcp", "start", "--distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(r), "--mesh", "auto", "--in-memory", "--no-tls", "--listen-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            line = p.stdout.readline()
            assert line.startswith("kcp-tpu serving at "), line
            with urllib.request.urlopen(line.split()[-1] + "/readyz", timeout=30) as r:
                assert r.status == 200
        for p in procs:
            p.send_signal(signal.SIGTERM)
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, err[-3000:]
        assert f"process group up (gloo): process {rank}/2" in err, err[-3000:]
        assert "serving mesh: {'hosts': 2, 'tenants': 1, 'slots': 1}" in err, err[-3000:]


_LOCKSTEP = r"""
import asyncio, hashlib, json, sys
sys.path[:0] = [REPO, TESTS]
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.parallel.distributed import init_distributed
from test_torch_core import _lockstep

init_distributed(device="cpu")
mesh = pmesh.mesh_from_spec("2x2x1", devices=["cpu"] * 2)
stream, ticks = asyncio.run(_lockstep("torch", "double", FLEET, 9, mesh=mesh))
dist.destroy_process_group()
print(json.dumps([hashlib.sha256(stream).hexdigest(), len(stream), ticks]))
"""


@pytest.mark.parametrize("fleet", [False, True], ids=["buckets", "fleet"])
def test_two_gloo_ranks_fused_core_streams_equal_the_one_process_mesh(fleet):
    """The serving core over the two-process mesh: each rank runs
    ``test_torch_core.py``'s lockstep schedule through ``FusedCore(mesh=)``
    (pipeline ``double``), every rank driving the same ticks; each rank's
    patch stream equals the one-process ``2x2x1`` core's byte for byte,
    which ``test_torch_mesh.py`` holds against the JAX core."""
    import asyncio
    import hashlib

    from test_torch_core import _lockstep

    want, ticks = asyncio.run(_lockstep(
        "torch", "double", fleet, 9,
        mesh=pmesh.mesh_from_spec("2x2x1", devices=[torch.device("cpu")] * 4)))
    assert len(want) > 1
    code = (_LOCKSTEP.replace("REPO", repr(REPO)).replace("TESTS", repr(os.path.join(REPO, "tests")))
            .replace("FLEET", repr(fleet)))
    for digest, size, got_ticks in run_ranks(code):
        assert (digest, size, got_ticks) == (hashlib.sha256(want).hexdigest(), len(want), ticks)
