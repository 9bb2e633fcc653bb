"""Server core: wires storage + REST surface + in-process controllers.

The analog of the reference's pkg/server/server.go:79-292: create the
data dir, bring up storage (WAL-backed LogicalStore standing in for
embedded etcd, reference pkg/etcd/etcd.go), serve the REST API, write
admin.kubeconfig (server.go:151-176), then fire post-start hooks that
install the in-process controllers (the "Install Cluster Controller"
hook, server.go:193-255).
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass, field

from ..apis.scheme import Scheme, default_scheme
from ..client import MultiClusterClient
from ..physical import PhysicalRegistry
from ..store import LogicalStore
from .handler import RestHandler, render_kubeconfig
from .httpd import HttpServer

log = logging.getLogger(__name__)


@dataclass
class Config:
    """Server configuration (reference: pkg/server/config.go:13-42)."""

    root_dir: str = ".kcp_tpu_torch"
    listen_host: str = "127.0.0.1"
    listen_port: int = 0  # 0 = ephemeral (reference default is 6443)
    durable: bool = True  # WAL-backed store vs in-memory
    store_server: str = ""  # external-storage option (the reference's
    # kcp start --etcd-servers, server.go:263-291): serve against another
    # kcp-tpu server's storage over REST instead of embedding a store.
    # Durability and storage semantics belong to that backend; run
    # controllers on exactly one process.
    store_token: str = ""  # bearer token for an authz'd storage backend
    store_ca_file: str | None = None  # CA for a TLS storage backend
    install_controllers: bool | None = None  # in-proc controllers.
    # None = auto: True for an embedded store (kcp start default), False
    # when store_server is set — in-process controllers issue BLOCKING
    # RemoteStore HTTP calls (30 s timeout each) straight on the serving
    # loop via MultiClusterClient, bypassing the handler's store-I/O
    # thread pool: a slow backend freezes watches and /healthz. An
    # explicit True with store_server is a hard error unless
    # force_remote_controllers acknowledges the hazard.
    force_remote_controllers: bool = False  # accept loop-blocking remote
    # controllers (and the controller-fighting risk) with store_server
    auto_publish_apis: bool = False  # --auto_publish_apis flag analog
    resources_to_sync: list[str] = field(default_factory=lambda: ["deployments.apps"])
    syncer_mode: str = "push"  # push | pull | none (controller.go:42-48)
    syncer_image: str = ""  # pull-mode image the installer deploys
    # (contrib/syncer-image/Dockerfile; reference: the cluster
    # controller's syncer-image flag). Empty = installer.
    # DEFAULT_SYNCER_IMAGE — resolved at wiring time to keep the one
    # definition in installer.py
    poll_interval: float = 15.0
    import_poll_interval: float = 15.0
    authz: bool = False  # RBAC-lite enforcement (server/authz.py); the
    # reference prototype runs open, so open stays the default
    admin_token: str = ""  # minted when empty and authz is on
    tls: bool = True  # serve HTTPS with self-generated certs (reference
    # parity: pkg/etcd/etcd.go:98-188 + server.go:151-176); certs persist
    # under root_dir/pki for durable servers, ephemeral otherwise
    device: str | None = None  # the controllers' device: None is the CUDA
    # card (an error without one), "cpu" runs them on the host. Resolved
    # only when controllers are installed; a serve-only server needs none
    mesh: str = ""  # serving-mesh spec ("8", "4x2", "2x2x2"): shard the
    # fused reconcile core's buckets over a mesh of the visible CUDA
    # devices, or of ``device`` repeated when it names one (SURVEY §7.2
    # step 9; the reference's horizontal-sharding story,
    # docs/investigations/logical-clusters.md:83)
    role: str = "shard"  # shard (a normal server — the default) | router
    # (the sharded control plane's scatter-gather frontend: no storage,
    # no controllers, no device; every request routes over the shard
    # ring) |
    # replica (read-only follower fed by a primary's WAL feed, serving
    # GET/LIST/WATCH RV-honestly from its own store + encode cache) |
    # standby (a replica that promotes itself to primary when the
    # primary's breaker stays open past the hysteresis window)
    shards: str = ""  # router role: comma-separated [name=]url shard list
    # (KCP_SHARDS env is the fallback; see kcp_tpu_torch/sharding/ring.py)
    shard_name: str = ""  # shard role: this server's stable name in the
    # ring (KCP_SHARD_NAME env fallback). With ring_names set, direct
    # smart-client requests (X-Kcp-Ring-Epoch stamped) are verified
    # against HRW ownership: a stale-ring client gets a typed 410
    # instead of a silently-wrong shard's answer
    ring_names: str = ""  # shard role: comma-separated names of EVERY
    # shard in the ring (KCP_RING_NAMES env fallback) — names alone
    # determine HRW ownership, so a shard can verify direct requests
    # without knowing anyone's address
    ring_epoch: int = 0  # shard role: the ring epoch this shard was
    # (re)started under; stamped on ring-mismatch 410s so smart clients
    # can tell a stale shard from a stale self
    primary: str = ""  # replica/standby roles: the primary's base URL
    # (the /replication/wal feed source and the health-probe target).
    # Accepts a comma-separated CANDIDATE list ("url1,url2"): a replica
    # whose current primary stays dead or fenced past the hysteresis
    # window probes the candidates in order and re-homes onto whichever
    # one serves as the live primary (the promoted standby after a
    # failover). KCP_PRIMARY env is the fallback for the flag.
    drain_timeout_s: float | None = None  # graceful-drain budget for
    # Server.drain (None -> KCP_DRAIN_TIMEOUT_S, default 5.0): the wall
    # bound on stop-accepting + finish-in-flight + terminal watch
    # Status + replication flush; whatever is still alive at the
    # deadline is cut off hard
    repl_hysteresis_s: float | None = None  # standby promotion: how long
    # the primary's breaker must stay open before the standby promotes
    # (None -> KCP_REPL_HYSTERESIS_S, default 3.0s). Too low and a slow
    # GC pause triggers a split brain race the fence then has to win;
    # too high and writes are down that much longer.
    repl_lag_max: int | None = None  # replicas refuse reads 503 past
    # this many records of lag (None -> KCP_REPL_LAG_MAX, default 0 =
    # serve any staleness RV-honestly)
    fleet: bool = False  # fleet placement control plane (KCP_FLEET=1 env
    # fallback): a FleetScheduler takes over the DeploymentSplitter's
    # placement decision with the capacity/locality-aware batched
    # bin-pack (kcp_tpu_torch/fleet/), solved on the controllers' device.
    # Spread + locality weight come from KCP_FLEET_SPREAD /
    # KCP_FLEET_LOCALITY_WEIGHT.


class Server:
    """One kcp-tpu control-plane process."""

    def __init__(self, config: Config | None = None, scheme: Scheme | None = None,
                 registry: PhysicalRegistry | None = None):
        self.config = config or Config()
        self.scheme = scheme or default_scheme()
        self.registry = registry or PhysicalRegistry()
        # resolve the install_controllers tri-state once (see Config):
        # frontends serving someone else's storage default to serve-only,
        # and a router (no storage at all) can never run controllers
        # routers own no storage; replicas/standbys serve a replicated
        # store that in-process controllers would fight the primary's
        # controllers over — none of the three may run controllers
        self.install_controllers = (
            False if self.config.role in ("router", "replica", "standby")
            else self.config.install_controllers
            if self.config.install_controllers is not None
            else not self.config.store_server)
        self.repl_hub = None
        self.repl_applier = None
        # the controllers' device work (schema hashes, the fused tick) runs
        # on this device: resolved here, so a missing card fails before
        # anything listens. A serve-only server (a router among them)
        # resolves nothing.
        self.mesh = None
        self.device = None
        if self.config.role == "router":
            # scatter-gather frontend over a shard ring: no store, no
            # controllers — requests relay to the owning shard(s). Authz
            # is terminated BY THE SHARDS (bearer tokens pass through);
            # enforcing it here too would need the router to share the
            # shards' role objects it deliberately does not store.
            from ..sharding import RouterHandler, ShardRing

            if self.config.authz:
                raise ValueError(
                    "--authz with --role router: the router does not "
                    "terminate authz — shards enforce it on every relayed "
                    "request; run the router open and pass bearer tokens "
                    "through")
            if self.config.store_server:
                raise ValueError("--store-server with --role router: a "
                                 "router routes to --shards, not to a "
                                 "storage backend")
            ring = (ShardRing.from_spec(self.config.shards,
                                        os.environ.get("KCP_REPLICAS", ""))
                    if self.config.shards else ShardRing.from_env())
            self.store = None
            self.authenticator = None
            self.handler = RouterHandler(
                ring, token=self.config.store_token,
                ca_file=self.config.store_ca_file)
            self.certs = None
            ssl_context = None
            if self.config.durable:
                # no WAL, but start() still renders admin.kubeconfig (and
                # TLS persists pki/) under root_dir
                os.makedirs(self.config.root_dir, exist_ok=True)
            if self.config.tls:
                from .certs import ServingCerts

                cert_dir = (os.path.join(self.config.root_dir, "pki")
                            if self.config.durable else None)
                hosts = {self.config.listen_host, "127.0.0.1", "localhost"}
                self.certs = ServingCerts.load_or_create(cert_dir,
                                                         sorted(hosts))
                ssl_context = self.certs.server_context()
            self.http = HttpServer(self.handler, self.config.listen_host,
                                   self.config.listen_port,
                                   ssl_context=ssl_context)
            self.client = None
            self._controllers = []
            self._post_start_hooks = []
            self._stop = asyncio.Event()
            return
        if self.install_controllers:
            # torch loads here, with the controllers: a serve-only process
            # (router, store frontend, --no-install-controllers) never
            # imports it
            from ..parallel.mesh import mesh_on
            from ..utils.device import resolve_device

            if self.config.mesh:
                self.mesh = mesh_on(self.config.mesh, self.config.device)
            self.device = resolve_device(self.config.device, self.mesh)
        if self.config.role in ("replica", "standby"):
            if not self.config.primary:
                # KCP_PRIMARY env is the flag's fallback (and carries the
                # same comma-separated candidate-list form)
                self.config.primary = os.environ.get("KCP_PRIMARY", "")
            if not self.config.primary:
                raise ValueError(
                    f"--role {self.config.role} needs --primary (the "
                    f"primary server's base URL to follow)")
            if self.config.store_server:
                raise ValueError(
                    "--store-server with --role replica/standby: a "
                    "follower replays the primary's WAL into its OWN "
                    "store; it cannot also delegate storage elsewhere")
        if self.config.store_server:
            # external storage: this process is a stateless frontend; the
            # backend's store owns RVs, conflicts, finalizers, and the WAL
            from ..store.remote import RemoteStore

            if self.config.durable:
                # no WAL here, but start() still writes admin.kubeconfig
                # (and TLS persists pki/) under root_dir
                os.makedirs(self.config.root_dir, exist_ok=True)
            if self.install_controllers:
                if not self.config.force_remote_controllers:
                    # hard error, not a warning (ADVICE r5): in-process
                    # controllers run their RemoteStore HTTP verbs (30 s
                    # timeouts) directly on the serving loop — a slow or
                    # unreachable backend freezes watches and /healthz —
                    # on top of frontend/backend controllers fighting
                    # over the shared dataset
                    raise ValueError(
                        "install_controllers=True with store_server would "
                        "run controllers that issue blocking remote-store "
                        "HTTP calls on the serving loop (and fight any "
                        "backend-side controllers over the shared "
                        "dataset); run controllers on the storage backend "
                        "instead, or set force_remote_controllers=True "
                        "(--force-install-controllers) if you accept both "
                        "hazards")
                log.warning(
                    "--store-server with in-process controllers (forced): "
                    "a slow storage backend can block the serving loop, "
                    "and the backend (or any other frontend) must NOT "
                    "also be running controllers")
            self.store = RemoteStore(self.config.store_server,
                                     token=self.config.store_token,
                                     ca_file=self.config.store_ca_file)
        else:
            wal = None
            if self.config.durable:
                os.makedirs(self.config.root_dir, exist_ok=True)
                wal = os.path.join(self.config.root_dir, "store.wal")
            # finalizer stamping is only safe when the namespace
            # controller that releases it will run (install_controllers)
            self.store = LogicalStore(
                wal_path=wal,
                namespace_lifecycle=self.install_controllers,
            )
        authn = authz = None
        if self.config.authz:
            import secrets as _secrets

            from .authz import ADMIN_USER, Authenticator, Authorizer

            if not self.config.admin_token:
                self.config.admin_token = _secrets.token_urlsafe(24)
            authn = Authenticator(tokens={self.config.admin_token: ADMIN_USER})
            authz = Authorizer(self.store)
        self.authenticator = authn
        self.handler = RestHandler(
            self.store, self.scheme, authenticator=authn, authorizer=authz,
            # a replica never serves a write (the store refuses them
            # anyway), so its admission chain would be dead weight; a
            # standby keeps the default chain for life after promotion
            admission=(None if self.config.role == "replica" else "auto"))
        # smart-client ring identity (env fallbacks let subprocess fleets
        # configure shards without new flags in every harness)
        shard_name = (self.config.shard_name
                      or os.environ.get("KCP_SHARD_NAME", ""))
        ring_names = (self.config.ring_names
                      or os.environ.get("KCP_RING_NAMES", ""))
        if shard_name and ring_names:
            names = tuple(n.strip() for n in ring_names.split(",")
                          if n.strip())
            if shard_name not in names:
                raise ValueError(
                    f"--shard-name {shard_name!r} is not in --ring-names "
                    f"{sorted(names)}")
            self.handler.shard_name = shard_name
            self.handler.ring_names = names
            self.handler.ring_epoch = self.config.ring_epoch or int(
                os.environ.get("KCP_RING_EPOCH", "1") or "1")
        self._wire_replication()
        self.certs = None
        ssl_context = None
        if self.config.tls:
            from .certs import ServingCerts

            cert_dir = (os.path.join(self.config.root_dir, "pki")
                        if self.config.durable else None)
            hosts = {self.config.listen_host, "127.0.0.1", "localhost"}
            self.certs = ServingCerts.load_or_create(cert_dir, sorted(hosts))
            ssl_context = self.certs.server_context()
        self.http = HttpServer(self.handler, self.config.listen_host,
                               self.config.listen_port,
                               ssl_context=ssl_context)
        # the in-process client SHARES the serving scheme: controller-
        # registered CRDs (crdlifecycle.py) must be visible to the REST
        # handler, or a CRD created over REST never serves its CRs
        self.client = MultiClusterClient(self.store, scheme=self.scheme)
        self._controllers: list = []
        self._post_start_hooks: list = []
        self._stop = asyncio.Event()

    def _wire_replication(self) -> None:
        """Attach the WAL-shipping hub (every server with a local store
        can feed replicas) and, for replica/standby roles, the applier
        that follows the configured primary."""
        from ..store import LogicalStore

        if not isinstance(self.store, LogicalStore):
            return  # remote-store frontends ship nothing: the backend does
        from ..replication import ReplicationApplier, ReplicationHub

        self.repl_hub = ReplicationHub(self.store)
        self.handler.repl_hub = self.repl_hub
        role = self.config.role
        if role not in ("replica", "standby"):
            return
        self.store.read_only = (
            "replica serves reads only; writes go to the primary"
            if role == "replica"
            else "standby awaiting promotion; writes go to the primary")
        self.store.reject_future_rv = True
        hysteresis = (self.config.repl_hysteresis_s
                      if self.config.repl_hysteresis_s is not None
                      else float(os.environ.get("KCP_REPL_HYSTERESIS_S",
                                                "3.0")))
        lag_max = (self.config.repl_lag_max
                   if self.config.repl_lag_max is not None
                   else int(os.environ.get("KCP_REPL_LAG_MAX", "0")))

        def on_promote() -> None:
            self.handler.repl_role = "primary"
            log.warning("this server is now the PRIMARY (epoch %d)",
                        self.store.epoch)

        self.repl_applier = ReplicationApplier(
            self.store, self.config.primary, role=role,
            token=self.config.store_token,
            ca_file=self.config.store_ca_file,
            hysteresis_s=hysteresis, on_promote=on_promote)
        self.handler.repl_applier = self.repl_applier
        self.handler.repl_role = role
        self.handler.repl_lag_max = lag_max

    def add_post_start_hook(self, hook) -> None:
        """Register an async callable fired once serving (server.go:294-312)."""
        self._post_start_hooks.append(hook)

    @property
    def address(self) -> str:
        return self.http.address

    @property
    def ca_pem(self) -> bytes | None:
        """The serving CA certificate (None when TLS is off) — what a
        client passes as ``RestClient(..., ca_data=...)``."""
        return self.certs.ca_cert_pem if self.certs else None

    async def start(self) -> None:
        """Bring the server up and fire hooks; returns once serving."""
        from ..utils.raceguard import LoopWatchdog

        # stall visibility on the serving loop (the race/sanitizer story's
        # production half): a reconcile blocking the loop past 1s is
        # logged with the offending stacks
        self._watchdog = LoopWatchdog(asyncio.get_running_loop(),
                                      threshold=1.0).start()
        await self.http.start()
        if self.config.durable:
            render_kubeconfig(self.address,
                              os.path.join(self.config.root_dir, "admin.kubeconfig"),
                              token=self.config.admin_token,
                              ca_pem=self.certs.ca_cert_pem if self.certs else None)
        if self.install_controllers:
            await self._install_controllers()
        if self.repl_applier is not None:
            await self.repl_applier.start()
        for hook in self._post_start_hooks:
            await hook(self)
        self.handler.ready = True
        from ..utils.trace import REGISTRY

        REGISTRY.gauge("kcp_up", "1 once post-start hooks completed").set(1)
        if self.config.authz and not self.config.durable:
            # no kubeconfig to carry the minted token: surface it or every
            # external client is locked out at 403
            log.warning("RBAC-lite on without a kubeconfig; admin token: %s",
                        self.config.admin_token)
        log.info("kcp-tpu serving at %s", self.address)

    async def _install_controllers(self) -> None:
        """The "Install Cluster Controller" post-start hook
        (reference: server.go:193-255 — cluster controller Start(2),
        apiresource controller Start(2), plus CRD lifecycle which the
        reference gets from its forked apiextensions apiserver)."""
        from ..reconcilers.apiresource import NegotiationController
        from ..reconcilers.cluster import ClusterController, SyncerMode
        from ..reconcilers.crdlifecycle import CRDLifecycleController
        from ..reconcilers.deployment import DeploymentSplitter
        from ..reconcilers.namespace import NamespaceLifecycleController

        mode = {"push": SyncerMode.PUSH, "pull": SyncerMode.PULL,
                "none": SyncerMode.NONE}[self.config.syncer_mode]
        mesh, device = self.mesh, self.device
        if mesh is not None:
            from ..parallel.mesh import set_serving_mesh

            self._installed_mesh = set_serving_mesh(mesh)
            log.info("serving mesh: %s", mesh.shape)
        splitter = DeploymentSplitter(self.client, device=device, mesh=mesh)
        self._controllers = [
            NegotiationController(self.client,
                                  auto_publish=self.config.auto_publish_apis,
                                  device=device),
            CRDLifecycleController(self.client),
            ClusterController(
                self.client, self.registry,
                resources_to_sync=self.config.resources_to_sync,
                mode=mode, poll_interval=self.config.poll_interval,
                import_poll_interval=self.config.import_poll_interval,
                mesh=mesh, mesh_spec=self.config.mesh, device=device,
                **({"syncer_image": self.config.syncer_image}
                   if self.config.syncer_image else {}),
            ),
            splitter,
            # the reference's "start-namespace-controller" hook
            # (server.go:325-356)
            NamespaceLifecycleController(self.client),
        ]
        if self.config.fleet or os.environ.get("KCP_FLEET") == "1":
            from ..fleet.scheduler import FleetScheduler

            # must start AFTER the splitter (it shares its informers);
            # the controllers list starts in order
            self._controllers.append(FleetScheduler(splitter, mesh=mesh))
        admission = getattr(self.handler, "admission", None)
        if admission is not None and admission.ledger is not None:
            # quota usage-recount reconciler (admission/quota.py):
            # applies ResourceQuota limit changes (including in-process
            # writes that bypass the REST chain) and periodically repairs
            # ledger drift against the store's true counts
            from ..admission import UsageRecountController

            self._controllers.append(UsageRecountController(
                self.client, admission.ledger, self.store))
            # the fleet batch's device-side per-segment counters feed
            # this ledger (FusedCore forwards them on every collect), so
            # admission accounting rides the fused device batch and the
            # recount loop can skip its host-side walk when they agree
            from ..syncer.core import FusedCore

            FusedCore.set_process_ledger(admission.ledger)
        for c in self._controllers:
            await c.start()

    async def run(self) -> None:
        """start() then block until stop() (reference: server.go:258-260)."""
        await self.start()
        await self._stop.wait()
        await self.shutdown()

    def stop(self) -> None:
        self._stop.set()

    async def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain (the SIGTERM path): stop accepting
        connections, let in-flight requests finish, deliver buffered
        watch events + a terminal in-stream Status to every live
        watcher, flush the replication feed to subscribers, then return
        True — the caller stops the server afterwards. The whole
        sequence is bounded by ``timeout`` (KCP_DRAIN_TIMEOUT_S,
        default 5.0 s): at the deadline, whatever is still alive is cut
        off exactly as a hard stop would. Returns False when the drain
        was aborted (an injected ``server.drain`` fault) and the caller
        should fall straight through to stop().
        """
        from ..faults import maybe_fail
        from ..utils.trace import REGISTRY

        if timeout is None:
            timeout = (self.config.drain_timeout_s
                       if self.config.drain_timeout_s is not None
                       else float(os.environ.get("KCP_DRAIN_TIMEOUT_S",
                                                 "5.0")))
        loop = asyncio.get_running_loop()
        gauge = REGISTRY.gauge(
            "server_draining",
            "1 while a graceful drain is in progress")
        span = REGISTRY.histogram(
            "server_drain_seconds",
            "wall time of one graceful drain (stop accepting -> "
            "in-flight done -> watchers terminated -> replication "
            "flushed)")
        t0 = loop.time()
        deadline = t0 + max(0.0, timeout)
        gauge.set(1)
        try:
            try:
                delay = maybe_fail("server.drain")
            except Exception as e:  # noqa: BLE001 — injected abort
                log.warning("graceful drain aborted (%s); "
                            "escalating to hard stop", e)
                return False
            if delay:
                await asyncio.sleep(delay)
            # 1. stop accepting: listener closed (late connections are
            # refused at connect time), idle keep-alive conns torn down
            self.http.begin_drain()
            # 2. in-flight requests finish (semi-sync repl waits
            # included); watch streams are excluded — they end in step 3
            if not await self.http.wait_requests_idle(deadline):
                log.warning("drain: in-flight requests still running at "
                            "the %.1fs deadline", timeout)
            # 3. flush + terminate watchers and replication subscribers.
            # An open commit window is flushed FIRST (group commit: a
            # reconciler's last writes may still be buffered — their
            # records must ship BEFORE the hub's drain sentinel), then
            # the store's pending fan-out, so the watch producers' final
            # drain() sees every committed event.
            if self.store is not None and hasattr(self.store,
                                                  "_gc_barrier"):
                self.store._gc_barrier()
            if self.store is not None and hasattr(self.store,
                                                  "_flush_events"):
                self.store._flush_events()
            draining = getattr(self.handler, "draining", None)
            if draining is not None:
                draining.set()
            if self.repl_hub is not None:
                self.repl_hub.drain()
            # 4. wait for every connection to wind down; cut off hard at
            # the deadline
            forced = await self.http.finish_drain(deadline)
            if forced:
                log.warning("drain: %d connection(s) cut off at the "
                            "%.1fs deadline", forced, timeout)
            log.info("graceful drain complete in %.3fs", loop.time() - t0)
            return True
        finally:
            span.observe(loop.time() - t0)
            gauge.set(0)

    def kill(self) -> None:
        """Abrupt-death switch (the in-process SIGKILL emulation the
        kill-the-primary drills use): serving stops immediately and the
        shutdown skips WAL compaction — on-disk state is exactly the
        appended log a killed process leaves, which is what restart and
        standby promotion must recover from."""
        self._killed = True
        self._stop.set()

    async def shutdown(self) -> None:
        if getattr(self, "_watchdog", None) is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self.repl_applier is not None:
            await self.repl_applier.stop()
            self.repl_applier = None
        for c in reversed(self._controllers):
            await c.stop()
        self._controllers = []
        if getattr(self, "_installed_mesh", None) is not None:
            # clear the process serving mesh so a later server/syncer in
            # this process doesn't inherit stale sharding — but only if
            # OUR mesh is still the installed one (another live server
            # may have replaced it since)
            from ..parallel.mesh import get_serving_mesh, set_serving_mesh

            if get_serving_mesh() is self._installed_mesh:
                set_serving_mesh(None)
            self._installed_mesh = None
        await self.http.stop()
        self.handler.close()
        if self.store is not None:
            if self.config.durable and not getattr(self, "_killed", False):
                self.store.snapshot()
            self.store.close()
