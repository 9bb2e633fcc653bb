"""``kcp start`` — run the control-plane server process.

The analog of the reference's cmd/kcp/kcp.go:15-63 (`kcp start` cobra
command): bring up storage + API server + in-process controllers and
serve until interrupted. Flags mirror pkg/server/config.go:45-112.

Usage:
    python -m kcp_tpu_torch.cli.kcp start [--listen-port 6443] [--root-dir .kcp_tpu_torch]
        [--in-memory] [--no-install-controllers] [--auto-publish-apis]
        [--resources-to-sync deployments.apps] [--syncer-mode push|pull|none]
        [--device cpu]
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from ..server import Config, Server
from . import add_device_argument
from .help import fit_terminal, parser

DOC = """Start a kcp-tpu control plane: a minimal multi-tenant API server
serving many logical clusters from one store, with batched reconcilers
installed in-process on a CUDA card.

kcp-tpu re-designs the kcp prototype for an accelerator: per-tenant
reconcile loops run as one batched device step (PyTorch, with a
hand-written CUDA kernel) instead of one goroutine per workspace."""


def build_parser():
    p = parser("kcp", DOC)
    sub = p.add_subparsers(dest="command", required=True)
    start = sub.add_parser("start", help="start the control plane",
                           description=fit_terminal(DOC))
    start.add_argument("--listen-host", default="127.0.0.1")
    start.add_argument("--listen-port", type=int, default=6443,
                       help="API port (reference default :6443)")
    start.add_argument("--root-dir", default=".kcp_tpu_torch",
                       help="data directory (reference: .kcp/, server.go:80-94)")
    start.add_argument("--in-memory", action="store_true",
                       help="no WAL durability (testing)")
    start.add_argument("--no-install-controllers", action="store_true",
                       help="serve only; controllers run out-of-process "
                            "(reference: cmd/cluster-controller). This is "
                            "already the default when --store-server is "
                            "set (a frontend's controllers would block "
                            "the serving loop on remote-store calls)")
    start.add_argument("--force-install-controllers", action="store_true",
                       help="run in-process controllers even with "
                            "--store-server, accepting that a slow "
                            "storage backend can block the serving loop "
                            "and that no other process may run "
                            "controllers against the same backend")
    start.add_argument("--auto-publish-apis", action="store_true",
                       help="negotiated APIs publish without manual approval "
                            "(reference: --auto_publish_apis)")
    start.add_argument("--resources-to-sync", default="deployments.apps",
                       help="comma-separated resources synced to physical clusters")
    start.add_argument("--role",
                       choices=["shard", "router", "replica", "standby"],
                       default="shard",
                       help="shard: a normal control-plane server (the "
                            "default; shards of a fleet are just servers). "
                            "router: the sharded control plane's scatter-"
                            "gather frontend — no storage, no controllers; "
                            "single-cluster requests proxy to the owning "
                            "shard, wildcard list/watch merge across all "
                            "shards (kcp_tpu_torch/sharding/). "
                            "replica: a read-only follower replaying the "
                            "--primary server's WAL feed, serving GET/LIST/"
                            "WATCH RV-honestly from its own store. "
                            "standby: a replica that promotes itself to "
                            "primary (fencing the old one) when the "
                            "primary stays dead past the hysteresis "
                            "window (kcp_tpu_torch/replication/)")
    start.add_argument("--shards", default="",
                       help="router role: comma-separated [name=]url shard "
                            "list (env KCP_SHARDS is the fallback), e.g. "
                            "s0=http://h0:6443,s1=http://h1:6443; a shard "
                            "entry may append |-separated read replicas, "
                            "e.g. s0=http://h0:6443|http://h0r:6444")
    start.add_argument("--shard-name", default="",
                       help="shard role: this server's stable name in the "
                            "ring (env KCP_SHARD_NAME). With --ring-names "
                            "set, direct smart-client requests (the "
                            "X-Kcp-Ring-Epoch stamp) are verified against "
                            "HRW ownership — a stale-ring client gets a "
                            "typed 410 instead of the wrong shard's answer")
    start.add_argument("--ring-names", default="",
                       help="shard role: comma-separated names of every "
                            "shard in the ring (env KCP_RING_NAMES); names "
                            "alone determine HRW ownership, so no "
                            "addresses are needed to verify direct "
                            "requests")
    start.add_argument("--ring-epoch", type=int, default=0,
                       help="shard role: the ring epoch this shard was "
                            "(re)started under, stamped on ring-mismatch "
                            "410s (env KCP_RING_EPOCH, default 1)")
    start.add_argument("--primary", default="",
                       help="replica/standby roles: the primary server's "
                            "base URL (the /replication/wal feed source "
                            "and promotion health-probe target). A "
                            "replica accepts a comma-separated candidate "
                            "list (url1,url2): when its primary stays "
                            "dead or fenced past the hysteresis window "
                            "it probes the candidates in order and "
                            "re-homes onto the live promoted primary. "
                            "Env KCP_PRIMARY is the fallback")
    start.add_argument("--drain-timeout", type=float, default=None,
                       help="graceful-drain budget in seconds on SIGTERM "
                            "(env KCP_DRAIN_TIMEOUT_S, default 5.0): "
                            "stop accepting, finish in-flight requests, "
                            "send terminal Status to watchers, flush "
                            "replication subscribers, then exit; "
                            "whatever is still alive at the deadline is "
                            "cut off hard. SIGINT skips the drain")
    start.add_argument("--repl-hysteresis", type=float, default=None,
                       help="standby promotion hysteresis seconds (env "
                            "KCP_REPL_HYSTERESIS_S, default 3.0): how long "
                            "the primary's breaker must stay open before "
                            "the standby fences it and takes writes")
    start.add_argument("--repl-lag-max", type=int, default=None,
                       help="replica reads answer 503 past this many "
                            "records of replication lag (env "
                            "KCP_REPL_LAG_MAX; default 0 = serve any "
                            "staleness, RV-honestly)")
    start.add_argument("--store-server", default="",
                       help="serve against another kcp-tpu server's "
                            "storage (the --etcd-servers analog): this "
                            "process becomes a stateless frontend; run "
                            "controllers on exactly one process")
    start.add_argument("--store-token", default="",
                       help="bearer token for an RBAC-enabled storage "
                            "backend")
    start.add_argument("--store-ca-file", default=None,
                       help="CA bundle for a TLS storage backend")
    start.add_argument("--syncer-image", default="",
                       help="image the pull-mode installer deploys into "
                            "physical clusters (default: the installer's "
                            "DEFAULT_SYNCER_IMAGE; see contrib/syncer-image)")
    start.add_argument("--syncer-mode", choices=["push", "pull", "none"],
                       default="push")
    start.add_argument("--poll-interval", type=float, default=60.0,
                       help="cluster health/API-import poll seconds "
                            "(reference: cluster.go:22, apiimporter.go:37)")
    start.add_argument("--authz", action="store_true",
                       help="enforce RBAC-lite (bearer tokens + per-tenant "
                            "ClusterRole/Binding evaluation); admin token is "
                            "minted into admin.kubeconfig")
    start.add_argument("--admin-token", default="",
                       help="fixed admin bearer token (minted when empty)")
    start.add_argument("--no-tls", action="store_true",
                       help="serve plaintext HTTP instead of the default "
                            "self-signed TLS endpoint")
    start.add_argument("--mesh", default="",
                       help="serving-mesh spec to shard the fused reconcile "
                            "core over the visible CUDA devices (or over "
                            "--device repeated when it names one): N "
                            "(tenants), NxM (tenants x slots), NxMxK (hosts "
                            "x tenants x slots), or 'auto' (one tenants "
                            "shard per visible CUDA device; with "
                            "--distributed, hosts = the processes and each "
                            "process's own cards), e.g. "
                            "--mesh 4x2")
    start.add_argument("--distributed", action="store_true",
                       help="form the torch.distributed process group "
                            "before serving (multi-host: every process "
                            "holds its own hosts block of the mesh's row "
                            "shards and drives the same ticks; NCCL when "
                            "each process serves on cards of its own, i.e. "
                            "without --device, an equal block of the "
                            "visible cards each; gloo when several "
                            "processes of a host share the --device card, "
                            "and on the CPU)")
    start.add_argument("--coordinator", default="",
                       help="process-group address (host:port); env "
                            "MASTER_ADDR/MASTER_PORT also works")
    start.add_argument("--num-processes", type=int, default=None)
    start.add_argument("--process-id", type=int, default=None)
    add_device_argument(start)
    start.add_argument("-v", "--verbosity", type=int, default=0)

    snap = sub.add_parser(
        "snapshot",
        help="compact the WAL offline (etcdctl-snapshot analog)",
        description="Load the store from its WAL, write a snapshot and "
                    "truncate the log. Run only while the server is down.")
    snap.add_argument("--root-dir", default=".kcp_tpu_torch")
    snap.add_argument("-v", "--verbosity", type=int, default=0)
    return p


def config_from_args(args) -> Config:
    return Config(
        root_dir=args.root_dir,
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        durable=not args.in_memory,
        # tri-state: an explicit --no-install-controllers wins; a forced
        # install wins over the store-server default; otherwise None lets
        # the server resolve (False with --store-server, True embedded)
        install_controllers=(
            False if args.no_install_controllers
            else True if args.force_install_controllers
            else None),
        force_remote_controllers=args.force_install_controllers,
        auto_publish_apis=args.auto_publish_apis,
        resources_to_sync=[r for r in args.resources_to_sync.split(",") if r],
        syncer_mode=args.syncer_mode,
        syncer_image=args.syncer_image,
        store_server=args.store_server,
        store_token=args.store_token,
        store_ca_file=args.store_ca_file,
        role=args.role,
        shards=args.shards,
        shard_name=args.shard_name,
        ring_names=args.ring_names,
        ring_epoch=args.ring_epoch,
        primary=args.primary,
        repl_hysteresis_s=args.repl_hysteresis,
        repl_lag_max=args.repl_lag_max,
        drain_timeout_s=args.drain_timeout,
        poll_interval=args.poll_interval,
        import_poll_interval=args.poll_interval,
        authz=args.authz,
        admin_token=args.admin_token,
        tls=not args.no_tls,
        device=args.device,
        mesh=args.mesh,
    )


async def serve(config: Config) -> None:
    try:
        server = Server(config)
    except RuntimeError as e:  # no card for the controllers' device work
        raise SystemExit(f"kcp start: {e}") from None

    async def announce(s: Server) -> None:
        # parseable by wrapping scripts (the reference prints the admin
        # kubeconfig path at startup for the same purpose)
        print(f"kcp-tpu serving at {s.address}", flush=True)

    server.add_post_start_hook(announce)
    loop = asyncio.get_event_loop()

    draining = False

    def _graceful() -> None:
        # SIGTERM: drain first (stop accepting, finish in-flight, send
        # terminal Status to watchers, flush replication), THEN stop. A
        # second SIGTERM — or a drain abort — falls through to the
        # immediate stop.
        nonlocal draining
        if draining:
            server.stop()
            return
        draining = True

        async def _drain_then_stop() -> None:
            try:
                await server.drain()
            finally:
                server.stop()

        asyncio.ensure_future(_drain_then_stop())

    try:
        loop.add_signal_handler(signal.SIGINT, server.stop)
        loop.add_signal_handler(signal.SIGTERM, _graceful)
    except NotImplementedError:  # non-unix
        pass
    await server.run()


def snapshot_cmd(args) -> int:
    """Offline WAL compaction: replay, snapshot, truncate, report."""
    import os

    from ..store import LogicalStore

    wal = os.path.join(args.root_dir, "store.wal")
    if not os.path.exists(wal) and not os.path.exists(wal + ".snap"):
        print(f"no WAL at {wal}", file=sys.stderr)
        return 1
    store = LogicalStore(wal_path=wal)
    objects, rv = len(store), store.resource_version
    store.snapshot()
    store.close()
    print(f"compacted {wal}: {objects} objects at rv {rv}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity > 0 else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    if args.command == "snapshot":
        return snapshot_cmd(args)
    if args.distributed:
        from ..parallel.distributed import init_distributed

        init_distributed(coordinator=args.coordinator or None,
                         num_processes=args.num_processes,
                         process_id=args.process_id, device=args.device)
    asyncio.run(serve(config_from_args(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
