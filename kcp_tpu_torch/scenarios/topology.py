"""Topologies: the real server constellations scenarios run on.

Everything here drives REAL servers over real HTTP — ServerThread per
process-analog, each with its own event loop and store, exactly the
harness discipline tests/helpers.py established (its ``shard_fleet`` /
``restart_shard`` now live here and are re-exported there). Three
shapes cover the deployment matrix the scenarios exercise:

- :class:`Monolith` — one server (optionally with in-process
  controllers, for the CRD/schema-negotiation scenarios);
- :class:`RouterFleet` — N durable shards behind a ``--role router``
  scatter-gather frontend, restartable one at a time (gracefully via
  :meth:`~kcp_tpu_torch.server.server.Server.drain` or abruptly via
  ``kill()`` — the rolling-restart scenario's A/B);
- :class:`ReplicatedPrimary` — primary + standby + replica behind a
  router whose shard entry lists the followers as read replicas; the
  kill-the-primary scenario's stage (standby promotion, replica
  re-homing, router write re-routing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import time
from urllib.parse import urlsplit

from ..server.server import Config
from ..server.threaded import ServerThread


def spawn_server(extra_args: list[str] | None = None,
                 env_overrides: dict | None = None,
                 timeout: float = 60.0):
    """Spawn a real ``kcp start`` SUBPROCESS (plaintext, no controllers)
    and block until it announces its serving address; returns
    ``(Popen, address)``.

    The out-of-process shape exists for watcher-scale scenarios: a
    10k-stream storm is 10k fds on each side of the wire, and holding
    both sides in one process doubles the bill against RLIMIT_NOFILE.
    The child never imports jax, and engine-side ``KCP_FAULTS``
    schedules do NOT reach it — subprocess topologies drill client-side
    and wire-level chaos (drops, storms), not server-internal points."""
    cmd = [sys.executable, "-m", "kcp_tpu_torch.cli.kcp", "start",
           "--no-install-controllers", "--no-tls",
           "--syncer-mode", "none"] + list(extra_args or [])
    env = dict(os.environ)
    env.pop("KCP_FAULTS", None)  # engine-phase schedules stay engine-side
    env.update({k: str(v) for k, v in (env_overrides or {}).items()})
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, env=env, text=True)
    deadline = time.time() + timeout
    while True:
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(
                f"kcp start exited rc={p.poll()} before serving: {cmd}")
        if line.startswith("kcp-tpu serving at "):
            return p, line.rsplit(None, 1)[-1]
        if time.time() > deadline:
            p.kill()
            raise RuntimeError(f"kcp start did not serve in {timeout}s")


# ---------------------------------------------------------------------------
# fleet primitives (moved from tests/helpers.py; re-exported there)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def shard_fleet(n: int, tls: bool = False, durable: bool = False,
                root_dir: str | None = None):
    """A sharded control plane: ``n`` shard servers plus a router
    fronting them over a consistent-hash ring.

    Yields ``(router_thread, shard_threads, ring)``; ``shard_threads``
    is a mutable list so chaos tests can kill and
    :func:`restart_shard` entries in place. ``durable=True`` gives each
    shard a WAL under ``root_dir/shard<i>`` so a restarted shard
    resumes with its data AND its RV sequence (the honest recovery
    story; in-memory shards come back empty at RV 0)."""
    from ..sharding import ShardRing

    if durable and root_dir is None:
        raise ValueError("durable shard_fleet needs a root_dir")
    shards: list[ServerThread] = []
    router = None
    names = ",".join(f"s{i}" for i in range(n))
    try:
        for i in range(n):
            # every shard knows the ring's NAMES and its own, so direct
            # smart-client requests (X-Kcp-Ring-Epoch stamped) are
            # ownership-verified; routed traffic is untouched
            kw: dict = dict(durable=durable, install_controllers=False,
                            tls=tls, shard_name=f"s{i}", ring_names=names,
                            ring_epoch=1)
            if durable:
                kw["root_dir"] = os.path.join(root_dir, f"shard{i}")
            shards.append(ServerThread(Config(**kw)).start())
        spec = ",".join(f"s{i}={t.address}" for i, t in enumerate(shards))
        router = ServerThread(Config(role="router", shards=spec,
                                     durable=False, tls=tls)).start()
        yield router, shards, ShardRing.from_spec(spec)
    finally:
        if router is not None:
            router.stop()
        for s in shards:
            s.stop()


def restart_shard(shards: list, i: int, timeout: float = 30.0):
    """Restart shard ``i`` on its OLD address (the ring entry is fixed
    at fleet start — a revived shard must come back where the router
    expects it). The old thread must already be stopped."""
    old = shards[i]
    cfg = dataclasses.replace(old.server.config,
                              listen_port=urlsplit(old.address).port)
    # the freed port can linger briefly; retry the bind a few times
    last: Exception | None = None
    for _ in range(10):
        try:
            shards[i] = ServerThread(cfg).start(timeout=timeout)
            return shards[i]
        except RuntimeError as e:  # port not yet released
            last = e
            time.sleep(0.2)
    raise last


def move_shard(shards: list, i: int, router_url: str, drain: bool = True,
               timeout: float = 30.0):
    """The elastic-topology primitive: take shard ``i`` down (drain by
    default), bring it back on a NEW ephemeral address, and republish
    the ring (``POST /ring``) so the router re-points its pools and
    bumps the ring epoch. Smart clients going direct to the old address
    fall back through the router once, re-fetch ``GET /ring``, and
    follow the move; routed clients never notice beyond the restart
    window. The shard's WAL (durable fleets) carries its data and RV
    sequence across the move."""
    from ..server.rest import RestClient

    old = shards[i]
    if drain:
        old.drain()
    old.stop()
    cfg = dataclasses.replace(
        old.server.config, listen_port=0,
        ring_epoch=(old.server.config.ring_epoch or 1) + 1)
    shards[i] = ServerThread(cfg).start(timeout=timeout)
    spec = ",".join(
        f"{t.server.config.shard_name or f's{j}'}={t.address}"
        for j, t in enumerate(shards))
    c = RestClient(router_url)
    try:
        c._request("POST", "/ring", {"shards": spec})
    finally:
        c.close()
    return shards[i]


# ---------------------------------------------------------------------------
# scenario topologies
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _env_patch(env: dict):
    """Apply server-process env overrides for the duration of server
    CONSTRUCTION (flow-control rates, drain budgets — read once at
    startup); restored immediately after so scenarios compose."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Monolith:
    """One server process; controllers optional (CRD scenarios).

    ``proc=True`` runs the server as a real SUBPROCESS instead of a
    ServerThread — the watcher-scale shape (10k streams = 10k fds per
    side; one process holding both sides pays double against
    RLIMIT_NOFILE). Scenario ``env`` reaches the child's environment;
    engine-side KCP_FAULTS schedules do not (see :func:`spawn_server`).
    """

    kind = "monolith"

    def __init__(self, root_dir: str, env: dict | None = None,
                 durable: bool = False, controllers: bool = False,
                 proc: bool = False, device=None):
        self.root_dir = root_dir
        self.env = env or {}
        self.durable = durable
        self.controllers = controllers
        self.proc = proc
        self.device = device
        self.server: ServerThread | None = None
        self._child: subprocess.Popen | None = None
        self._child_url = ""

    def start(self) -> "Monolith":
        if self.proc:
            if self.controllers:
                raise ValueError(
                    "proc=True monolith runs --no-install-controllers; "
                    "CRD scenarios need the in-process shape")
            args = ["--listen-port", "0"]
            if self.durable:
                args += ["--root-dir", os.path.join(self.root_dir, "mono")]
            else:
                args += ["--in-memory"]
            self._child, self._child_url = spawn_server(args, self.env)
            return self
        # the device is resolved only when controllers are installed
        kw: dict = dict(durable=self.durable,
                        install_controllers=self.controllers, tls=False,
                        device=self.device)
        if self.durable:
            kw["root_dir"] = os.path.join(self.root_dir, "mono")
        with _env_patch(self.env):
            self.server = ServerThread(Config(**kw)).start()
        return self

    @property
    def client_url(self) -> str:
        if self._child is not None:
            return self._child_url
        return self.server.address

    def stop(self) -> None:
        if self._child is not None:
            # SIGTERM = graceful drain (the CLI's handler); escalate if
            # the child outlives a generous budget
            self._child.send_signal(signal.SIGTERM)
            try:
                self._child.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self._child.kill()
                self._child.wait(timeout=5)
            self._child = None
        if self.server is not None:
            self.server.stop()
            self.server = None


class RouterFleet:
    """N durable shards behind a router, restartable in place."""

    kind = "fleet"

    def __init__(self, root_dir: str, env: dict | None = None,
                 shards: int = 2, durable: bool = True):
        self.root_dir = root_dir
        self.env = env or {}
        self.n = shards
        self.durable = durable
        self.shards: list[ServerThread] = []
        self.router: ServerThread | None = None

    def start(self) -> "RouterFleet":
        with _env_patch(self.env):
            names = ",".join(f"s{i}" for i in range(self.n))
            for i in range(self.n):
                kw: dict = dict(durable=self.durable,
                                install_controllers=False, tls=False,
                                shard_name=f"s{i}", ring_names=names,
                                ring_epoch=1)
                if self.durable:
                    kw["root_dir"] = os.path.join(self.root_dir,
                                                  f"shard{i}")
                self.shards.append(ServerThread(Config(**kw)).start())
            spec = ",".join(f"s{i}={t.address}"
                            for i, t in enumerate(self.shards))
            self.router = ServerThread(Config(role="router", shards=spec,
                                              durable=False,
                                              tls=False)).start()
        return self

    @property
    def client_url(self) -> str:
        return self.router.address

    def restart_shard(self, i: int, drain: bool = True) -> None:
        """Take shard ``i`` down (gracefully or by SIGKILL-equivalent)
        and bring it back on its old address — one step of a rolling
        restart."""
        if drain:
            self.shards[i].drain()
        else:
            self.shards[i].kill()
        restart_shard(self.shards, i)

    def move_shard(self, i: int | None = None) -> None:
        """The ring-change-under-load lever: drain a shard, restart it
        on a NEW address, republish ``/ring``. With no index given, the
        shard owning tenant ``t0`` moves — guaranteed to sit on a live
        workload's write path."""
        from ..sharding import ShardRing

        if i is None:
            spec = ",".join(f"s{j}={t.address}"
                            for j, t in enumerate(self.shards))
            i = ShardRing.from_spec(spec).owner_index("t0")
        move_shard(self.shards, i, self.router.address)

    def scale_out(self) -> ServerThread:
        """The elastic-capacity lever: grow the fleet by ONE shard while
        the workload runs. Starts ``s<n>`` (durable, booted with the
        grown ring identity so epoch-stamped direct requests verify),
        then drives :func:`kcp_tpu_torch.sharding.migrate.scale_out` against
        the router — the grown ring publishes with every moving cluster
        pinned to its old owner, each pinned cluster's WAL streams to
        the new shard, and ownership flips atomically per cluster.
        Raises (scenario fails) if any migration step refuses."""
        from ..sharding import migrate

        i = len(self.shards)
        with _env_patch(self.env):
            names = ",".join(
                [t.server.config.shard_name or f"s{j}"
                 for j, t in enumerate(self.shards)] + [f"s{i}"])
            kw: dict = dict(durable=self.durable,
                            install_controllers=False, tls=False,
                            shard_name=f"s{i}", ring_names=names,
                            ring_epoch=1)
            if self.durable:
                kw["root_dir"] = os.path.join(self.root_dir, f"shard{i}")
            new = ServerThread(Config(**kw)).start()
        self.shards.append(new)
        self.n += 1
        migrate.scale_out(self.router.address, f"s{i}={new.address}")
        return new

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
            self.router = None
        for s in self.shards:
            s.stop()
        self.shards = []


class ReplicatedPrimary:
    """Primary + standby + replica behind a router (one ring entry with
    the followers as read replicas). The replica's ``--primary`` is the
    CANDIDATE list ``primary,standby`` so re-homing engages after a
    failover."""

    kind = "replicated"

    def __init__(self, root_dir: str, env: dict | None = None,
                 hysteresis_s: float = 0.6):
        self.root_dir = root_dir
        self.env = env or {}
        self.hysteresis_s = hysteresis_s
        self.primary: ServerThread | None = None
        self.standby: ServerThread | None = None
        self.replica: ServerThread | None = None
        self.router: ServerThread | None = None

    def start(self) -> "ReplicatedPrimary":
        with _env_patch(self.env):
            self.primary = ServerThread(Config(
                durable=True, install_controllers=False, tls=False,
                root_dir=os.path.join(self.root_dir, "p"))).start()
            self.standby = ServerThread(Config(
                role="standby", primary=self.primary.address,
                repl_hysteresis_s=self.hysteresis_s,
                durable=True, install_controllers=False, tls=False,
                root_dir=os.path.join(self.root_dir, "s"))).start()
            self.replica = ServerThread(Config(
                role="replica",
                primary=f"{self.primary.address},{self.standby.address}",
                repl_hysteresis_s=self.hysteresis_s,
                durable=True, install_controllers=False, tls=False,
                root_dir=os.path.join(self.root_dir, "r"))).start()
            spec = (f"s0={self.primary.address}|{self.standby.address}"
                    f"|{self.replica.address}")
            self.router = ServerThread(Config(
                role="router", shards=spec, durable=False,
                tls=False)).start()
        return self

    @property
    def client_url(self) -> str:
        return self.router.address

    def peer_addrs(self) -> dict[str, str]:
        """host:port per replication role. The engine templates
        ``{primary}``/``{standby}``/``{replica}`` in phase fault specs
        into these — link faults key on the netloc, not the URL."""
        return {name: urlsplit(t.address).netloc
                for name, t in (("primary", self.primary),
                                ("standby", self.standby),
                                ("replica", self.replica))
                if t is not None}

    def audit(self, timeout: float = 12.0) -> dict:
        """Post-run replication facts for the scorecard: poll every
        node's ``/replication/status`` until the constellation settles
        — exactly one writable primary (fencing landed), every live
        unfenced follower drained to the primary's applied RV — then
        report. A fleet that never settles reports its last snapshot
        and the SLOs fail loudly.

        ``stale_primary_excess_rv`` is the dual-primary-commit
        evidence: a fenced ex-primary that committed writes the
        promoted primary never saw would sit AHEAD of it in the shared
        RV sequence."""
        from ..server.rest import RestClient
        from ..utils import errors

        def snap() -> dict:
            out = {}
            for name, t in (("primary", self.primary),
                            ("standby", self.standby),
                            ("replica", self.replica)):
                if t is None:
                    continue
                c = RestClient(t.address)
                try:
                    out[name] = c._request(
                        "GET", "/replication/status") or {}
                except (errors.ApiError, ConnectionError, OSError):
                    out[name] = None  # dead node (e.g. killed primary)
                finally:
                    c.close()
            return out

        deadline = time.time() + timeout
        while True:
            st = [s for s in snap().values() if s]
            prim = [s for s in st
                    if s.get("role") == "primary" and not s.get("fenced")
                    and not s.get("read_only")]
            fenced = [s for s in st if s.get("fenced")]
            lag = excess = 0
            if len(prim) == 1:
                head = int(prim[0].get("applied_rv", 0) or 0)
                epoch = int(prim[0].get("epoch", 0) or 0)
                followers = [s for s in st
                             if s is not prim[0] and not s.get("fenced")]
                lag = max((head - int(s.get("applied_rv", 0) or 0)
                           for s in followers), default=0)
                excess = max((int(s.get("applied_rv", 0) or 0) - head
                              for s in fenced), default=0)
                # a fence stamps the SUPERSEDING epoch onto the sealed
                # store, so a fenced node sitting AHEAD of the writable
                # primary would mean a promotion this fleet never saw
                ahead = any(int(s.get("epoch", 0) or 0) > epoch
                            for s in fenced)
                if lag == 0 and excess <= 0:
                    break
            if time.time() > deadline:
                ahead = True
                break
            time.sleep(0.2)
        return {"writable_primaries": len(prim),
                "fenced_nodes": len(fenced),
                "replica_lag": max(lag, 0),
                "stale_primary_excess_rv": max(excess, 0),
                "epoch_fence_held": int(len(prim) == 1 and not ahead)}

    def kill_primary(self) -> None:
        """SIGKILL-equivalent primary death (Server.kill: no WAL
        compaction, streams die mid-chunk)."""
        self.primary.kill()

    def stop(self) -> None:
        for t in (self.router, self.replica, self.standby, self.primary):
            if t is not None:
                t.stop()
        self.router = self.replica = self.standby = self.primary = None


class NullTopology:
    """No servers at all. The placement-study workload is pure solver
    work driven engine-side; ``client_url`` is empty and the engine
    skips every HTTP-touching step (observers, traces, final-state
    verify)."""

    kind = "none"

    def __init__(self, root_dir: str, env: dict | None = None):
        self.root_dir = root_dir
        self.env = env or {}

    def start(self) -> "NullTopology":
        return self

    @property
    def client_url(self) -> str:
        return ""

    def stop(self) -> None:
        pass


def make_topology(spec, root_dir: str, device=None):
    """Instantiate the topology a spec names. ``device`` is the device of
    a server that installs controllers (``None``: the CUDA card); the
    other topologies serve without controllers and resolve none."""
    args = dict(spec.topology_args)
    if spec.topology == "monolith":
        return Monolith(root_dir, env=spec.env, device=device, **args)
    if spec.topology == "fleet":
        return RouterFleet(root_dir, env=spec.env, **args)
    if spec.topology == "replicated":
        return ReplicatedPrimary(root_dir, env=spec.env, **args)
    if spec.topology == "none":
        return NullTopology(root_dir, env=spec.env)
    raise ValueError(f"unknown topology {spec.topology!r}")
