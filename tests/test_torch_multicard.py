"""The rule that picks a process's ``torch.distributed`` backend and its
serving cards (``kcp_tpu_torch.parallel.distributed.rank_plan``), on the
CPU with the card count patched: 1, 2 and 4 visible cards under 1, 2 and
4 processes on the host (``LOCAL_WORLD_SIZE``).

- a named card that several processes of the host share takes gloo: NCCL
  refuses two ranks on one card (``--device cuda:0`` on a four-card host
  once took NCCL, which the parent of this rule did);
- cards of its own (no ``--device``) take NCCL, each process an equal
  block of the visible cards, disjoint from the others', and every mesh a
  process builds without ``devices=`` (``mesh_from_spec("2x2x1")``,
  ``"auto"``, ``mesh_on``) lies on that block, which an NCCL group also
  enforces;
- the CPU takes gloo.

``init_distributed`` and ``kcp start --distributed`` are driven with the
group's formation patched out, so no test here connects anywhere. The
last tests rehearse ``chip_smoke.py``'s multi-card phases (19, 20) on one
visible card, where each prints its "not run" line and nothing else.
"""

import os

import pytest
import torch
import torch.distributed as dist

from kcp_tpu_torch.parallel import distributed as pdist
from kcp_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CARDS = (1, 2, 4)
LOCAL_WORLDS = (1, 2, 4)


def cuda(i: int) -> torch.device:
    return torch.device("cuda", i)


@pytest.fixture
def host(monkeypatch):
    """``host(cards, local_world)`` patches the visible card count and the
    processes on the host; ``group(world, rank, backend)`` makes the
    process look like a rank of a formed group."""
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)

    def set_host(cards: int, local_world: int) -> None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))

    def group(world: int, rank: int, backend: str) -> None:
        monkeypatch.setattr(dist, "is_available", lambda: True)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
        monkeypatch.setattr(dist, "get_rank", lambda *a: rank)
        monkeypatch.setattr(dist, "get_backend", lambda *a: backend)

    set_host.group = group
    return set_host


class Formed:
    """``init_distributed`` up to the group's formation: each call records
    the backend it would form and the card it makes current."""

    def __init__(self):
        self.calls: list[dict] = []

    def init_process_group(self, backend, timeout, **kwargs):
        self.calls[-1].update(backend=backend, kwargs=kwargs)

    def set_device(self, dev):
        self.calls[-1]["current"] = torch.device(dev)

    def begin(self) -> dict:
        self.calls.append({"current": None})
        return self.calls[-1]

    def __call__(self, world: int, rank: int, device=None) -> dict:
        got = self.begin()
        pdist.init_distributed(coordinator="127.0.0.1:1", num_processes=world,
                               process_id=rank, device=device)
        return got


@pytest.fixture
def formed(monkeypatch):
    rec = Formed()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", rec.init_process_group)
    monkeypatch.setattr(dist, "get_rank", lambda *a: rec.calls[-1]["kwargs"]["rank"])
    monkeypatch.setattr(dist, "get_world_size",
                        lambda *a: rec.calls[-1]["kwargs"]["world_size"])
    monkeypatch.setattr(torch.cuda, "set_device", rec.set_device)
    return rec


def expected(cards: int, local_world: int, local_rank: int, device):
    """The rule, written out case by case."""
    if device == "cpu" or (device is None and cards == 0):
        return "gloo", [torch.device("cpu")] if device else []
    if device == "cuda:0":
        return ("nccl" if local_world == 1 else "gloo"), [cuda(0)]
    if cards >= local_world:
        per = cards // local_world
        return "nccl", [cuda(local_rank * per + i) for i in range(per)]
    return "gloo", [cuda(local_rank % cards)]


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", "cpu"])
@pytest.mark.parametrize("local_world", LOCAL_WORLDS)
@pytest.mark.parametrize("cards", CARDS)
def test_init_distributed_forms_the_backend_of_the_rule(host, formed, cards, local_world,
                                                         device):
    """Every process of the host (a group of two hosts when the host has
    one): the backend formed, the current card (its block's lead), and
    never NCCL for processes that share a card."""
    host(cards, local_world)
    world = max(2, local_world)
    plans = []
    for rank in range(local_world):
        want_backend, want_devices = expected(cards, local_world, rank,
                                              None if device == "cuda" else device)
        got = formed(world, rank, device)
        plan = pdist.rank_plan(world, rank, device)
        assert (got["backend"], plan.backend, plan.devices) == (
            want_backend, want_backend, want_devices)
        lead = want_devices[0] if want_devices and want_devices[0].type == "cuda" else None
        assert got["current"] == lead
        plans.append(plan)
    if any(p.backend == "nccl" for p in plans):
        held = [d for p in plans for d in p.devices]
        assert len(set(held)) == len(held), plans


def test_two_ranks_sharing_a_named_card_on_four_cards_form_gloo(host, formed):
    """``kcp start --distributed --device cuda:0`` twice on a four-card
    host: both ranks on cuda:0, so gloo (the parent formed NCCL here, and
    NCCL refuses two ranks on one card)."""
    host(4, 2)
    for rank in range(2):
        got = formed(2, rank, "cuda:0")
        assert (got["backend"], got["current"]) == ("gloo", cuda(0))


@pytest.mark.parametrize("cards", CARDS)
def test_the_cpu_takes_gloo(host, formed, cards):
    """``device="cpu"`` on any host, and no device on a host without a
    card: gloo, no current card."""
    host(cards, 2)
    for rank in range(2):
        got = formed(2, rank, "cpu")
        assert (got["backend"], got["current"]) == ("gloo", None)
        assert got["kwargs"] == {"init_method": "tcp://127.0.0.1:1", "world_size": 2,
                                 "rank": rank}
    host(0, 2)
    assert (formed(2, 0)["backend"], pdist.rank_plan(2, 0)) == ("gloo", ("gloo", []))


@pytest.mark.parametrize("cards", [2, 4])
def test_nccl_ranks_build_their_meshes_on_their_own_disjoint_blocks(host, cards):
    """Two NCCL ranks on 2 or 4 cards: each rank's block is disjoint from
    the other's, and the mesh it builds without ``devices=`` (a 3-D spec
    over the group, ``"auto"``, ``mesh_on`` without a device) lies on its
    block, led by the block's lead."""
    host(cards, 2)
    spec = "2x2x1" if cards == 4 else "2x1x1"
    blocks = []
    for rank in range(2):
        host.group(2, rank, "nccl")
        plan = pdist.rank_plan(2, rank)
        assert plan.backend == "nccl"
        blocks.append(plan.devices)
        for mesh in (pmesh.mesh_from_spec(spec), pmesh.mesh_on(spec, None),
                     pmesh.mesh_on(spec, "cuda")):
            assert mesh.process == rank and mesh.shape["hosts"] == 2
            assert list(mesh.local_devices) == plan.devices[:mesh.shape["tenants"]]
            assert mesh.lead == plan.devices[0]
        auto = pmesh.mesh_from_spec("auto")
        assert auto.shape == {"hosts": 2, "tenants": cards // 2, "slots": 1}
        assert list(auto.local_devices) == plan.devices and auto.process == rank
        assert pmesh.mesh_from_spec(str(cards // 2)).local_devices == tuple(plan.devices)
    assert blocks == [[cuda(i) for i in range(cards // 2)],
                      [cuda(i) for i in range(cards // 2, cards)]]


def test_an_nccl_group_refuses_a_shard_on_another_ranks_card(host):
    """A rank of an NCCL group holds no row shard on a card outside its
    block, nor on the CPU; a gloo group may (one card shared)."""
    host(4, 2)
    host.group(2, 1, "nccl")
    with pytest.raises(ValueError, match="its own cards"):
        pmesh.mesh_from_spec("2x2x1", devices=[cuda(0), cuda(0)])
    with pytest.raises(ValueError, match="its own cards"):
        pmesh.mesh_on("2x2x1", "cuda:0")
    with pytest.raises(ValueError, match="its own cards"):
        pmesh.mesh_from_spec("2x2x1", devices=["cpu", "cpu"])
    assert pmesh.mesh_from_spec("2x2x1", devices=[cuda(3), cuda(2)]).lead == cuda(3)
    host.group(2, 1, "gloo")
    assert pmesh.mesh_on("2x2x1", "cuda:0").local_devices == (cuda(0),)
    host.group(2, 0, "nccl")
    assert pmesh.mesh_on("2x2x1", "cuda:0").local_devices == (cuda(0),)


@pytest.mark.parametrize("device,backend,current", [
    (None, "nccl", [cuda(0), cuda(2)]), ("cuda:0", "gloo", [cuda(0), cuda(0)]),
], ids=["own-cards", "shared-cuda0"])
def test_kcp_start_distributed_forms_the_backend_of_its_device(host, formed, monkeypatch,
                                                                device, backend, current):
    """``kcp start --distributed`` hands its ``--device`` to the rule:
    without one, each of two ranks on four cards serves on its own block
    over NCCL; with ``--device cuda:0`` both serve on that card over gloo."""
    from kcp_tpu_torch.cli import kcp

    host(4, 2)
    monkeypatch.delenv("KCP_DEVICE", raising=False)
    monkeypatch.setattr(kcp.asyncio, "run", lambda coro: coro.close())
    for rank in range(2):
        formed.begin()
        argv = ["start", "--distributed", "--coordinator", "127.0.0.1:1",
                "--num-processes", "2", "--process-id", str(rank), "--in-memory",
                "--no-tls", "--listen-port", "0"]
        assert kcp.main(argv + (["--device", device] if device else [])) == 0
    assert [(g["backend"], g["current"]) for g in formed.calls] == [(backend, c)
                                                                   for c in current]


@pytest.mark.parametrize("visible", [0, 1])
def test_chip_smoke_multicard_phases_print_only_not_run_on_one_card(monkeypatch, capsys,
                                                                     visible):
    """``chip_smoke.py`` phases 19 and 20 with fewer than two visible cards:
    one "not run" line each, no launch, no timed call, nothing else."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    timed = []
    assert chip_smoke.multicard_loop_phase(torch, "card", {}, timed) == 0
    assert chip_smoke.nccl_phase(torch, "card", [], []) == 0
    assert timed == []
    assert capsys.readouterr().out.splitlines() == [
        f"phase 19, the fused loop over a card per row shard: not run: needs ≥ 2 cards, "
        f"{visible} visible",
        f"phase 20, A7 over NCCL: not run: needs ≥ 2 cards, {visible} visible"]
