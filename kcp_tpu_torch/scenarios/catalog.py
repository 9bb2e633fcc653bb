"""The named scenarios: the end-to-end acceptance suite, the port's copy
of the reference catalog (same names, phases, SLOs, options and env).

Each entry composes subsystems that are tested one by one elsewhere —
CRUD serving + encode-once lists, watch fan-out + informer discipline,
admission/flow control, the shard router, WAL replication + promotion,
graceful drain — into one declared-SLO workload. ``python -m
kcp_tpu_torch.scenarios run --all --seed N`` runs them all and emits one
JSON scorecard.

SLO targets are deliberately scale-independent (ScenarioSpec.scaled
never touches them): an objective that only holds at toy scale is not
an objective. Latency bounds leave headroom for loaded CI hosts —
regressions they exist to catch (lost events, lost writes, unthrottled
floods, silent stream deaths) are step functions, not millisecond
drift.
"""

from __future__ import annotations

from .spec import SLO, Phase, ScenarioSpec

CRUD_CHURN = ScenarioSpec(
    name="crud-churn",
    description="N-tenant CRUD churn under a watcher fleet: the "
                "bread-and-butter lane — every ack converges to every "
                "stream, nothing is lost, nothing 5xxes.",
    topology="monolith",
    tenants=8,
    watchers_per_tenant=2,
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("churn", ops_per_tenant=60)),
    slos=(
        SLO("convergence", "p99_convergence_ms", "<=", 400.0),
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("no-unclean-stream-deaths", "unclean_stream_ends", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "==", 0),
    ),
)

NOISY_NEIGHBOR = ScenarioSpec(
    name="noisy-neighbor",
    description="One tenant floods writes at many times its token rate "
                "while quiet tenants keep working: flow control must "
                "throttle the flood (429 + Retry-After) and keep the "
                "quiet tenants' p99 within a declared ratio of their "
                "no-storm baseline.",
    topology="monolith",
    tenants=6,
    watchers_per_tenant=1,
    env={"KCP_FLOW_RATE": "80", "KCP_FLOW_BURST": "40"},
    phases=(Phase("baseline", ops_per_tenant=40),
            Phase("storm", ops_per_tenant=40, action="flood")),
    options={"flood_ops": 600, "pace_s": 0.02},
    slos=(
        SLO("quiet-tenant-p99-ratio", "quiet_p99_ratio", "<=", 3.0),
        SLO("no-quiet-throttling", "quiet_429", "==", 0),
        SLO("flood-throttled", "flood_429", ">=", 1),
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
    ),
)

RECONNECT_STORM = ScenarioSpec(
    name="reconnect-storm",
    description="10,000 watch streams severed in the same instant while "
                "writes continue; every observer resumes from its last "
                "RV at once against one server. The shared watch-cache "
                "window must absorb the storm: zero lost events, zero "
                "unrecoverable (410) resumes, and drop-to-first-event "
                "resume latency bounded at p99. Runs against a real "
                "server SUBPROCESS so the 10k-stream fd bill is split "
                "across processes (scale 1.0 needs ~10k fds per side).",
    topology="monolith",
    topology_args={"proc": True},
    tenants=20,
    watchers_per_tenant=500,
    phases=(Phase("warm", ops_per_tenant=15),
            Phase("storm", ops_per_tenant=40, action="drop_watchers",
                  settle_s=1.0),
            Phase("recover", ops_per_tenant=15, settle_s=1.0)),
    options={"pace_s": 0.01, "coverage_timeout_s": 120.0},
    slos=(
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("no-unrecoverable-resumes", "gone_410", "==", 0),
        SLO("storm-happened", "reconnects", ">=", 1),
        # the bound is the 1-cpu host reality: re-establishing 10k TCP
        # streams serializes on one accept loop (~500 conns/s), so the
        # herd converges together near the tail; the SLOs exist to catch
        # step-function regressions (lost events, 410 storms, resumes
        # that relist), not millisecond drift
        SLO("resume-latency", "resume_p99_ms", "<=", 30000.0),
        SLO("convergence", "p99_convergence_ms", "<=", 30000.0),
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "==", 0),
        # soak memory: server RSS at the last phase boundary vs the
        # first. 10k resumes each relisting the world is exactly where
        # unpaged list bodies balloon; paged relists keep this flat.
        # Declared (not best-effort) so a run where RSS sampling broke
        # FAILS as "metric never measured" instead of passing blind.
        SLO("bounded-rss-growth", "memory_growth_ratio", "<=", 3.0),
    ),
)

ROLLING_RESTART = ScenarioSpec(
    name="rolling-restart",
    description="A durable shard fleet behind the router restarted one "
                "shard at a time USING GRACEFUL DRAIN, under live "
                "writes and watches: zero lost acked writes, zero lost "
                "watch events, every stream ended by a terminal Status. "
                "The same workload re-runs with drain bypassed (kill) "
                "and must demonstrate the breach drain prevents.",
    topology="fleet",
    topology_args={"shards": 2},
    tenants=6,
    watchers_per_tenant=2,
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("restart", ops_per_tenant=90,
                  action="rolling_restart_drain", settle_s=1.0)),
    options={"pace_s": 0.02, "compare_kill": True,
             "coverage_timeout_s": 25.0},
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("no-unclean-stream-deaths", "unclean_stream_ends", "==", 0),
        SLO("drain-terminated-streams", "terminal_statuses", ">=", 1),
        SLO("error-budget-5xx", "http_5xx", "<=", 400),
        SLO("kill-bypass-breaches", "bypass_stream_breaches", ">=", 1),
    ),
)

KILL_PRIMARY = ScenarioSpec(
    name="kill-primary",
    description="SIGKILL the primary mid-workload behind a router with "
                "standby + replica: the standby promotes, the replica "
                "re-homes its feed onto the promoted standby, the "
                "router re-routes writes to it — no manual restarts, "
                "zero acked writes lost.",
    topology="replicated",
    tenants=5,
    watchers_per_tenant=2,
    phases=(Phase("warm", ops_per_tenant=25),
            Phase("failover", ops_per_tenant=80, action="kill_primary",
                  faults="repl.ship:latency=2ms", settle_s=1.5),
            Phase("recovered", ops_per_tenant=25, settle_s=1.0)),
    options={"pace_s": 0.02, "coverage_timeout_s": 30.0},
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("standby-promoted", "repl_promotions", ">=", 1),
        SLO("replica-rehomed", "repl_rehome", ">=", 1),
        SLO("router-rerouted-writes", "router_rehome", ">=", 1),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "<=", 600),
    ),
)

CRD_CHURN = ScenarioSpec(
    name="crd-churn",
    description="Per-tenant CRD creation, schema-negotiation churn and "
                "teardown with live CR traffic: a created CRD must "
                "become servable within the convergence bound, schema "
                "updates must not blip serving, and a deleted CRD's "
                "endpoint must 404 promptly.",
    topology="monolith",
    topology_args={"controllers": True},
    tenants=4,
    watchers_per_tenant=0,
    workload="crd",
    phases=(Phase("establish", ops_per_tenant=15, settle_s=0.5),
            Phase("negotiate", ops_per_tenant=25, settle_s=0.5)),
    slos=(
        SLO("schema-negotiation-convergence", "crd_servable_p99_ms",
            "<=", 5000.0),
        SLO("all-crds-established", "crd_unestablished", "==", 0),
        SLO("all-crds-torn-down", "crd_undestroyed", "==", 0),
        SLO("no-lost-acked-cr-writes", "lost_acked_writes", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "==", 0),
    ),
)

RING_CHANGE = ScenarioSpec(
    name="ring-change-under-load",
    description="A live-workload shard drains and restarts on a NEW "
                "address mid-phase and the router republishes /ring: "
                "smart clients (even-index tenants go DIRECT to the HRW "
                "owner) must absorb the move via one-shot router "
                "fallbacks + a ring re-fetch, routed tenants via plain "
                "retries — zero lost acked writes, zero stuck clients, "
                "and a bounded p99 through the fallback window.",
    topology="fleet",
    topology_args={"shards": 3},
    tenants=6,
    watchers_per_tenant=1,
    options={"pace_s": 0.02, "smart_half": True,
             "coverage_timeout_s": 30.0},
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("move", ops_per_tenant=80, action="move_shard",
                  settle_s=1.5),
            Phase("after", ops_per_tenant=20, settle_s=1.0)),
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-stuck-clients", "gave_up", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("fallback-window-p99", "phase_move_p99_ms", "<=", 15000.0),
        SLO("smart-went-direct", "smart_client_direct", ">=", 1),
        SLO("move-absorbed-by-fallback", "smart_client_fallback", ">=", 1),
        SLO("ring-refetched", "smart_client_ring_refreshes", ">=", 1),
        SLO("error-budget-5xx", "http_5xx", "<=", 400),
    ),
)

SCALE_OUT = ScenarioSpec(
    name="scale-out-under-load",
    description="Elastic capacity: a 2-shard durable fleet DOUBLES to 4 "
                "shards live, one shard per grow phase, while tenants "
                "write and watch throughout (even-index tenants go "
                "direct via smart clients). Each grow publishes the "
                "grown ring with every moving cluster pinned to its old "
                "owner, streams the cluster's WAL to the new shard "
                "through the fenced filtered feed, and flips ownership "
                "atomically per cluster. Zero lost acked writes, zero "
                "lost watch events, no stuck clients, bounded p99 "
                "through both migration windows — and the WAL actually "
                "moved (migration_records). Typed 410s are EXPECTED "
                "here (fences and flips turn them into retries/relists) "
                "so no gone_410 SLO: honesty about the mechanism, not "
                "silence about it.",
    topology="fleet",
    topology_args={"shards": 2},
    tenants=6,
    watchers_per_tenant=1,
    options={"pace_s": 0.02, "smart_half": True,
             "coverage_timeout_s": 30.0},
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("grow23", ops_per_tenant=60, action="scale_out",
                  settle_s=1.5),
            Phase("grow34", ops_per_tenant=60, action="scale_out",
                  settle_s=1.5),
            Phase("after", ops_per_tenant=20, settle_s=1.0)),
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("no-stuck-clients", "gave_up", "==", 0),
        SLO("grow23-window-p99", "phase_grow23_p99_ms", "<=", 15000.0),
        SLO("grow34-window-p99", "phase_grow34_p99_ms", "<=", 15000.0),
        SLO("wal-actually-migrated", "migration_records", ">=", 1),
        SLO("smart-went-direct", "smart_client_direct", ">=", 1),
        SLO("error-budget-5xx", "http_5xx", "<=", 400),
    ),
)

WRITE_STORM = ScenarioSpec(
    name="write-storm",
    description="The whole tenant fleet writes flat-out with group "
                "commit on (KCP_GROUP_COMMIT=1, the default) and the "
                "primary is SIGKILLed mid-storm behind a router with "
                "standby + replica: the standby promotes and zero "
                "ACKED writes are lost — an unsynced commit window was "
                "never acked, so grouping cannot widen the loss window "
                "— while the commit-window counters prove the write "
                "path actually grouped under the storm.",
    topology="replicated",
    tenants=6,
    watchers_per_tenant=1,
    env={"KCP_GROUP_COMMIT": "1"},
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("storm", ops_per_tenant=120, action="kill_primary",
                  settle_s=1.5),
            Phase("recovered", ops_per_tenant=20, settle_s=1.0)),
    options={"pace_s": 0.0, "coverage_timeout_s": 30.0},
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("standby-promoted", "repl_promotions", ">=", 1),
        SLO("writes-actually-grouped", "store_commit_windows", ">=", 1),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "<=", 2000),
    ),
)

FLEET_CHURN = ScenarioSpec(
    name="fleet-churn",
    description="Hundreds of physical clusters with skewed capacity "
                "flap Ready/NotReady in a seeded storm while the "
                "in-server fleet control plane (KCP_FLEET=1) keeps "
                "root Deployments placed: every flap stays inside the "
                "evacuation hysteresis, so the storm phase must move "
                "ZERO replicas and evacuate ZERO pclusters — and the "
                "healed fleet's live assignment must equal the numpy "
                "host twin's answer for the final state.",
    topology="monolith",
    topology_args={"controllers": True},
    tenants=2,
    watchers_per_tenant=0,
    workload="fleet",
    env={"KCP_FLEET": "1"},
    options={"pclusters": 200, "roots": 30, "ticks": 6,
             "flap_rate": 0.15, "skew": 1.0},
    phases=(Phase("seed", settle_s=0.3),
            Phase("storm", settle_s=0.3),
            Phase("verify", settle_s=0.3)),
    slos=(
        SLO("zero-churn-under-flaps", "fleet_storm_churn", "==", 0),
        SLO("zero-evacuations-under-flaps", "fleet_storm_evacuations",
            "==", 0),
        SLO("storm-actually-flapped", "fleet_flaps", ">=", 50),
        SLO("seed-fully-placed", "fleet_seed_unplaced", "==", 0),
        SLO("assignment-matches-host-twin", "assignment_mismatches",
            "==", 0),
        SLO("healed-fully-placed", "fleet_unplaced", "==", 0),
        SLO("solver-actually-ran", "placement_resolves", ">=", 1),
        SLO("driver-clean", "fleet_driver_errors", "==", 0),
    ),
)

CAPACITY_SKEW = ScenarioSpec(
    name="capacity-skew-binpack",
    description="The BASELINE-shape bin-pack study: 10k workspaces "
                "over 8 pclusters with lognormal-skewed capacity, "
                "solved in ONE device batch. The assignment must be "
                "byte-identical to the numpy host twin, never "
                "overcommit a row or land on a non-candidate, and a "
                "37-row candidate delta must re-solve exactly those "
                "rows to the same answer a from-scratch solve gives.",
    topology="none",
    tenants=2,
    watchers_per_tenant=0,
    workload="placement",
    options={"workspaces": 10000, "pclusters": 8, "spread": 2,
             "skew": 1.2, "dirty_rows": 37},
    phases=(Phase("solve", settle_s=0.0),),
    slos=(
        SLO("baseline-shape", "placement_rows", ">=", 10000),
        SLO("assignment-byte-identical", "placement_mismatches",
            "==", 0),
        SLO("no-overcommitted-rows", "placement_overcommit_rows",
            "==", 0),
        SLO("never-onto-non-candidates",
            "placement_noncandidate_replicas", "==", 0),
        SLO("incremental-touches-only-dirty-rows",
            "placement_incremental_extra_rows", "==", 0),
        SLO("incremental-matches-full-solve",
            "placement_incremental_mismatches", "==", 0),
        SLO("batched-solve-bounded", "placement_batched_ms",
            "<=", 5000.0),
        SLO("driver-clean", "placement_driver_errors", "==", 0),
    ),
)

PARTITION_PROMOTION = ScenarioSpec(
    name="partition-during-promotion",
    description="A WAN partition cuts every peer's link TO the primary "
                "(feed fan-out stays up — the partition is directed) "
                "mid-workload: the standby's probes fail, it promotes "
                "behind the epoch fence, the router re-homes writes "
                "onto it, and when the link heals the fence lands on "
                "the old primary. The epoch fence must HOLD: zero "
                "acked writes lost, exactly one writable primary at "
                "the end, the fenced ex-primary behind the promoted "
                "epoch with no commits the new primary never saw.",
    topology="replicated",
    tenants=5,
    watchers_per_tenant=2,
    phases=(Phase("warm", ops_per_tenant=25),
            Phase("partition", ops_per_tenant=60,
                  faults="link.partition:drop@peer=*>{primary}",
                  settle_s=2.0),
            Phase("healed", ops_per_tenant=25, settle_s=2.0)),
    options={"pace_s": 0.02, "coverage_timeout_s": 30.0},
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("partition-actually-cut",
            "fault_injected_link_partition", ">=", 1),
        SLO("standby-promoted", "repl_promotions", ">=", 1),
        SLO("router-rerouted-writes", "router_rehome", ">=", 1),
        SLO("one-writable-primary", "writable_primaries", "==", 1),
        SLO("old-primary-fenced", "fenced_nodes", ">=", 1),
        SLO("no-dual-primary-commits", "stale_primary_excess_rv",
            "==", 0),
        SLO("epoch-fence-held", "epoch_fence_held", "==", 1),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "<=", 2000),
    ),
)

WAN_REPLICA_LAG = ScenarioSpec(
    name="wan-replica-lag",
    description="The replica's feed link crosses a slow WAN path "
                "(seeded 30-60ms per batch, jittered) while writes "
                "continue at full rate: the primary's fan-out must lag "
                "ONLY that follower (the semi-sync standby acks at LAN "
                "speed, so client acks never slow), and once the link "
                "heals the replica must drain its lag to zero — "
                "bounded staleness, not silent divergence. Session-"
                "consistency probers ride alongside the writers, every "
                "read pinned to the tenant's own max acked RV "
                "(X-Kcp-Min-Rv): whichever node answers through the "
                "lagging link — parked on its RV barrier or fallen "
                "back to the primary — the response must never come "
                "back below the session floor, with zero surfaced "
                "errors.",
    topology="replicated",
    tenants=5,
    watchers_per_tenant=1,
    phases=(Phase("warm", ops_per_tenant=20),
            Phase("lag", ops_per_tenant=60,
                  faults="link.delay:latency=30ms@jitter=30ms"
                         "@peer=repl.feed>replica",
                  settle_s=1.0),
            Phase("drain", ops_per_tenant=20, settle_s=2.0)),
    options={"pace_s": 0.02, "coverage_timeout_s": 30.0,
             "consistent_readers": True},
    slos=(
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("wan-delay-actually-fired",
            "fault_injected_link_delay", ">=", 1),
        SLO("replica-drained-after-heal", "replica_lag", "==", 0),
        SLO("one-writable-primary", "writable_primaries", "==", 1),
        SLO("no-spurious-promotion", "repl_promotions", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("error-budget-5xx", "http_5xx", "==", 0),
        SLO("consistent-reads-served", "consistent_reads", ">=", 1),
        SLO("zero-stale-consistent-reads",
            "stale_consistent_reads", "==", 0),
        SLO("zero-consistent-read-errors",
            "consistent_read_errors", "==", 0),
        SLO("barrier-parked-under-lag",
            "consistent_read_waits", ">=", 1),
    ),
)

SCENARIOS: dict[str, ScenarioSpec] = {
    s.name: s for s in (CRUD_CHURN, NOISY_NEIGHBOR, RECONNECT_STORM,
                        ROLLING_RESTART, KILL_PRIMARY, CRD_CHURN,
                        RING_CHANGE, SCALE_OUT, WRITE_STORM,
                        FLEET_CHURN, CAPACITY_SKEW, PARTITION_PROMOTION,
                        WAN_REPLICA_LAG)
}
