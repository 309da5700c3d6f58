"""LMS cluster server: Raft + LMS + FileTransfer on one gRPC endpoint.

The port's copy of `distributed_lms_raft_llm_tpu/serving/lms_server.py`:
the same three servicers on one port, the same positional CLI and flags,
one asyncio event loop, durable Raft state, commit-acked writes, and a
long-lived BERT relevance gate, which is the port's (`engine/gate.py`,
on the card unless `--device cpu`). Port and JAX-package nodes speak one
wire and can share one Raft group.

Run (5-node cluster, reference topology):
    python -m distributed_lms_raft_llm_tpu_torch.serving.lms_server 1 50051 \
        50051 50052 50053 50055 50056 --host 127.0.0.1

Peers are listed as ports (same-host dev) or full host:port addresses,
node ids 1..N in order. --tutoring points at the tutoring node(s).

Or declaratively — one TOML for the whole deployment (config.py):
    python -m distributed_lms_raft_llm_tpu_torch.serving.lms_server \
        --config configs/cluster.toml --id 1
Explicit CLI flags override file values.

`--groups N` ([groups] count) shards the LMS state over N Raft groups
behind the group router (`lms/group_router.py`); as in the reference's
entry point, no reshard coordinator is wired, so `POST /admin/reshard`
answers 400.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import urllib.parse
from typing import Dict

import grpc

from ..lms.group_router import GroupsAdmin, RoutedLMSServicer, RoutingMap
from ..lms.node import LMSNode
from ..lms.service import (
    FileTransferServicer,
    LMSServicer,
    collect_submission_texts,
)
from ..lms.tutoring_pool import TutoringPool, TutoringUnavailable
from ..proto import rpc
from ..raft import RaftConfig
from ..raft.grpc_transport import RaftServicer
from ..utils.diskfaults import DiskFaultInjector
from ..utils.faults import CampaignRunner, FaultInjector
from ..utils.guards import make_serving_watchdog
from ..utils.metrics import Metrics
from ..utils.timeline import (
    Timeline,
    TimelineSampler,
    timeline_admin_get,
)
from ..utils.tracing import trace_admin_get

log = logging.getLogger("lms_server")


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def parse_addresses(peers, host: str) -> Dict[int, str]:
    addresses = {}
    for i, peer in enumerate(peers, start=1):
        addresses[i] = peer if ":" in peer else f"{host}:{peer}"
    return addresses


def fault_state(faults: FaultInjector, disk_faults: DiskFaultInjector,
                campaigns: CampaignRunner) -> Dict:
    """The active fault/campaign configuration — ONE shape shared by
    `POST /admin/faults` responses and `GET /admin/faults`, so operators
    and the semester simulator assert against the same document."""
    snap = faults.snapshot()
    snap["disk"] = disk_faults.snapshot()
    return {"ok": True, "faults": snap, "campaign": campaigns.snapshot()}


def make_admin(lms_node: LMSNode, faults: FaultInjector,
               disk_faults: DiskFaultInjector, campaigns: CampaignRunner,
               timeline: "Timeline | None" = None,
               pool: "TutoringPool | None" = None,
               groups_admin: "GroupsAdmin | None" = None):
    """The node's admin plane: (POST handler, GET handler) for the local
    HTTP endpoint (utils/healthz.py). Module-level (not inlined in
    serve_async) so the in-process semester-sim cluster (sim/cluster.py)
    serves the EXACT operator surface the production entrypoint serves.
    `timeline` is the node's telemetry ring (utils/timeline.py), served
    read-only at GET /admin/timeline."""

    async def admin(path: str, body: Dict) -> Dict:
        """POST /admin/membership {"op": "add"|"remove", "id": N,
        "address": "host:port"} — single-server Raft membership change on
        the leader (raft/core.py §4 machinery).
        POST /admin/transfer {"target": N?} — graceful leadership handoff
        (thesis §3.10: drain to the most caught-up member before planned
        maintenance; resolves once this node has stepped down).
        POST /admin/faults — chaos over real gRPC (utils/faults.py):
        {"target": "raft:2"|"tutoring"|"*", "drop": 0.3, "error": 0.1,
        "delay_s": 0.05, "delay_jitter_s": 0.05, "duplicate": 0.1} installs
        a spec; target "disk" routes to the storage-plane injector
        (utils/diskfaults.py: {"target": "disk", "write_error": 0.05,
        "fsync_error": 0.02, "bit_flip": 0.01}); {"clear": "raft:2"} (or
        "disk") removes one; {"reset": true} removes all (and cancels any
        campaign); {"campaign": {"name": "...", "phases": [{"target": ...,
        "duration_s": 2.0, ...spec}]}} schedules a timed campaign
        (utils/faults.CampaignRunner); {"campaign_cancel": true} stops it;
        {} reads the current state (also served read-only as
        GET /admin/faults).
        The admin plane rides the local HTTP endpoint, keeping the gRPC
        wire contract frozen."""
        if path == "/admin/faults":
            if body.get("reset"):
                # stop(), not cancel(): the response snapshot below must
                # not race the cancelled campaign's finally-clear and
                # show its spec as still installed.
                await campaigns.stop()
                faults.clear()
                disk_faults.clear()
            elif body.get("campaign_cancel"):
                await campaigns.stop()
            elif "campaign" in body:
                camp = body["campaign"]
                if not isinstance(camp, dict) or "phases" not in camp:
                    raise ValueError(
                        "campaign needs {'name': ..., 'phases': [...]}"
                    )
                campaigns.start(str(camp.get("name", "campaign")),
                                list(camp["phases"]))
            elif "clear" in body:
                if str(body["clear"]) == "disk":
                    disk_faults.clear()
                else:
                    faults.clear(str(body["clear"]))
            elif "target" in body:
                spec = {k: v for k, v in body.items() if k != "target"}
                if str(body["target"]) == "disk":
                    disk_faults.configure(**spec)
                else:
                    faults.configure(str(body["target"]), **spec)
            return fault_state(faults, disk_faults, campaigns)
        if path == "/admin/tutoring":
            # Elastic fleet membership on this node's routing tier
            # (lms/tutoring_pool.py): {"op": "add", "address": ...,
            # "health": ...?} admits a node (warm-up weighted),
            # {"op": "remove"} drops it, {"op": "eject"}/{"op": "join"}
            # toggle routability without forgetting the node. Drains
            # normally flow from the tutoring node's own POST
            # /admin/drain via the health poller; these ops are the
            # operator override.
            if pool is None:
                raise ValueError("no tutoring pool on this node")
            op = body.get("op")
            address = str(body.get("address", ""))
            if not address:
                raise ValueError("missing 'address'")
            if op == "add":
                pool.add_node(address,
                              health_address=body.get("health"))
            elif op == "remove":
                if not pool.remove_node(address):
                    raise ValueError(f"unknown tutoring node {address}")
            elif op == "eject":
                if not pool.eject(address):
                    raise ValueError(f"unknown tutoring node {address}")
            elif op == "join":
                if not pool.join(address):
                    raise ValueError(f"unknown tutoring node {address}")
            else:
                raise ValueError(
                    "op must be 'add', 'remove', 'eject', or 'join'"
                )
            return {"ok": True, "fleet": pool.snapshot()}
        if path == "/admin/score":
            # Bulk scoring through the fleet's BACKGROUND route
            # (lms/tutoring_pool.plan_background — off the hot affinity
            # nodes first): {"purpose": "grading", "student"?} fans the
            # submitted-assignment corpus (lms/service.
            # collect_submission_texts) to the coldest scoring-capable
            # tutoring node; {"texts": [...]} scores an explicit corpus
            # (relevance evals, gate-threshold calibration). Poll
            # GET /admin/score/<job_id> for progress + results.
            if pool is None:
                raise ValueError("no tutoring pool on this node")
            if "texts" in body:
                texts = [str(t) for t in body["texts"]]
            else:
                texts = collect_submission_texts(
                    lms_node.state,
                    student=(str(body["student"])
                             if body.get("student") else None),
                )
            if not texts:
                raise ValueError(
                    "no texts to score (no submissions yet, or an "
                    "unknown student filter)"
                )
            try:
                doc = await pool.submit_score_job(
                    texts, purpose=str(body.get("purpose", "grading")),
                    job_id=(str(body["job_id"]) if body.get("job_id")
                            else None),
                )
            except TutoringUnavailable as e:
                raise ValueError(f"scoring unavailable: {e}") from e
            return {"ok": True, "submitted_texts": len(texts), **doc}
        if path == "/admin/reshard":
            # Live resharding (lms/group_router.ReshardCoordinator):
            # {"course": "<course>", "to_group": N} moves one course's
            # users to another Raft group as a staged, journaled handoff
            # (freeze → slice → install → map flip → drop) with zero
            # acked-write loss. Requires a multi-group deployment with a
            # coordinator wired (the sim cluster wires one; a
            # single-group node answers 400).
            if groups_admin is None:
                raise ValueError("no group admin on this node")
            return {"ok": True, **await groups_admin.reshard(body)}
        if path == "/admin/transfer":
            target = body.get("target")
            chosen = await lms_node.node.transfer_leadership(
                None if target is None else int(target)
            )
            # No leader_id here: this node just abdicated, and its local
            # view stays stale until the new leader's first append — the
            # target IS the expected leader; clients re-resolve as usual.
            return {"ok": True, "target": chosen}
        if path != "/admin/membership":
            raise KeyError(path)
        op = body.get("op")
        if op not in ("add", "remove"):
            raise ValueError("op must be 'add' or 'remove'")
        if "id" not in body:
            raise ValueError("missing 'id'")
        nid = int(body["id"])
        if op == "add" and "address" not in body:
            raise ValueError("'add' requires 'address'")
        members = {
            k: lms_node.addresses.get(k, v)
            for k, v in lms_node.node.core.members.items()
        }
        if op == "add":
            members[nid] = str(body["address"])
        else:
            members.pop(nid, None)
        index = await lms_node.node.propose_config(members)
        return {"ok": True, "index": index,
                "members": {str(k): v for k, v in members.items()}}

    async def admin_get(path: str) -> Dict:
        """GET /admin/faults — read-only introspection of the active
        fault/campaign configuration. The plane used to be write-only:
        an operator (or the semester sim's auditor) could INSTALL chaos
        but never assert what was currently injected.
        GET /admin/trace — the flight recorder's pinned exemplars plus
        recent traces; GET /admin/trace/<request-id> — the assembled span
        forest for one request (utils/tracing.py).
        GET /admin/timeline — this node's telemetry ring (counter rates,
        gauges, histogram percentiles over time + recorded events;
        utils/timeline.py)."""
        if path.startswith("/admin/trace"):
            return trace_admin_get(path)
        if path == "/admin/timeline":
            return timeline_admin_get(path, timeline)
        if path.startswith("/admin/score/"):
            # GET /admin/score/<job_id> — proxy the job's status (+
            # results once done) from the tutoring node the background
            # route placed it on.
            if pool is None:
                raise KeyError(path)
            return {"ok": True,
                    **await pool.score_job_status(path.rsplit("/", 1)[1])}
        if path.startswith("/admin/tutoring"):
            # GET /admin/tutoring — the routing tier's per-node map
            # (state, breaker, queue depth, routes/served counts).
            # GET /admin/tutoring/route?q=<query> — which fleet node the
            # ring would serve this query from, and the spill order.
            if pool is None:
                raise KeyError(path)
            if path == "/admin/tutoring":
                return {"ok": True, "fleet": pool.snapshot()}
            prefix = "/admin/tutoring/route"
            if path.startswith(prefix):
                qs = urllib.parse.urlparse(path).query
                params = urllib.parse.parse_qs(qs)
                q = params.get("q", [""])[0]
                sid = params.get("session", [""])[0]
                if not q and not sid:
                    raise ValueError(
                        "route needs ?q=<query> or ?session=<sid>"
                    )
                return {"ok": True,
                        **pool.route_snapshot(q, session_id=sid)}
            raise KeyError(path)
        if path == "/admin/raft":
            # Read-only sharded-control-plane topology: routing map
            # version + per-group members/leader/term/applied index.
            # Served in single-group deployments too (one row).
            if groups_admin is None:
                raise KeyError(path)
            return {"ok": True, **groups_admin.topology()}
        if path != "/admin/faults":
            raise KeyError(path)
        return fault_state(faults, disk_faults, campaigns)

    return admin, admin_get


def make_health(node_id: int, lms_node: LMSNode, pool: TutoringPool,
                faults: FaultInjector):
    """/healthz provider closure (shared with sim/cluster.py)."""

    def health() -> Dict:
        return {
            "ok": True,
            "node_id": node_id,
            "role": "leader" if lms_node.node.is_leader else "follower",
            "leader_id": lms_node.node.leader_id,
            "applied_index": lms_node.node.core.last_applied,
            "members": {
                str(k): v for k, v in lms_node.node.core.members.items()
            },
            # Resilience surface: operators see shed/degrade pressure
            # here without scraping /metrics. `tutoring_breaker` keeps
            # its pre-fleet shape (the worst node's snapshot — a
            # one-node fleet reports its only breaker, exactly as
            # before); `tutoring_fleet` is the per-node routing map.
            "tutoring_breaker": pool.worst_breaker_snapshot(),
            "tutoring_fleet": pool.snapshot(),
            "faults": faults.snapshot(),
            # Storage-recovery surface: true while this node discarded
            # corrupt local state and is re-syncing from the leader.
            "storage_recovering": lms_node.recovering,
        }

    return health


async def serve_async(args) -> None:
    addresses = parse_addresses(args.peers, args.host)
    if args.id not in addresses:
        raise SystemExit(f"node id {args.id} not in peer list")

    raft_config = RaftConfig(
        election_timeout_min=args.election_timeout / 2,
        election_timeout_max=args.election_timeout,
        heartbeat_interval=args.heartbeat_interval,
    )
    # One injector per node shapes BOTH network fault surfaces (Raft egress
    # and the tutoring forward); dormant (zero overhead beyond a dict probe)
    # until the admin endpoint installs a spec. The disk injector is its
    # sibling for the storage plane (admin target "disk").
    faults = FaultInjector(seed=args.fault_seed)
    disk_faults = DiskFaultInjector(seed=args.fault_seed)
    metrics = Metrics()
    lms_node = LMSNode(
        args.id, addresses, args.data_dir, raft_config=raft_config,
        snapshot_every=args.snapshot_every, fault_injector=faults,
        disk_fault_injector=disk_faults,
        # Wires the Raft tick-lag watchdog (utils/guards.py) into /metrics:
        # raft_tick_lag histogram + raft_tick_stalls counter.
        metrics=metrics,
        replicate_timeout_s=args.replicate_timeout,
        replicate_budget_s=args.replicate_budget,
        storage_checksums=args.storage_checksums,
        storage_fsync=args.storage_fsync == "always",
        storage_recovery=args.storage_recovery,
    )

    gate = None
    if args.gate_model:
        # torch is imported here only: the rest of the node is host code.
        # On --device cuda without a card the gate raises (device.py).
        from ..engine import GateConfig, RelevanceGate

        gate = RelevanceGate(
            GateConfig(model=args.gate_model, checkpoint=args.gate_checkpoint,
                       vocab_path=args.gate_vocab,
                       threshold=args.gate_threshold,
                       quant=args.gate_quant, device=args.device)
        )
        gate.warmup()

    tutoring_auth_key = None
    if args.tutoring_auth_key_file:
        # Off-loop even at startup: this coroutine already shares the loop
        # with the Raft node being constructed around it, and the habit of
        # never blocking the loop is what the no-blocking-in-async lint
        # rule enforces.
        loop = asyncio.get_running_loop()
        tutoring_auth_key = (await loop.run_in_executor(
            None, _read_text, args.tutoring_auth_key_file
        )).strip()

    # The tutoring routing tier: a bare --tutoring host:port is a
    # one-node fleet; a comma-separated list (or [tutoring_fleet]
    # addresses) fans the forward out with cache-affinity placement,
    # per-node breakers, spill, and hedged sends.
    fleet_addresses = [a.strip() for a in (args.tutoring or "").split(",")
                       if a.strip()]
    fleet_health = [a.strip() for a in (args.tutoring_health or "").split(",")
                    if a.strip()]
    # Flag values get the SAME validation the TOML section enforces
    # (list lengths, health_poll_s > 0, warmup_weight in (0, 1], ...):
    # constructing the config dataclass runs its __post_init__, so e.g.
    # `--tutoring-health-poll 0` fails at startup instead of busy-
    # looping the serving loop.
    from ..config import TutoringFleetConfig

    try:
        fleet_cfg = TutoringFleetConfig(
            addresses=fleet_addresses,
            health_addresses=fleet_health,
            hedge_after_s=args.tutoring_hedge_after,
            stream_stall_s=args.tutoring_stream_stall,
            queue_spill_depth=args.tutoring_queue_spill,
            warmup_s=args.tutoring_warmup,
            warmup_weight=args.tutoring_warmup_weight,
            health_poll_s=args.tutoring_health_poll,
        )
    except ValueError as e:
        raise SystemExit(f"tutoring fleet flags: {e}") from e
    pool = TutoringPool(
        fleet_cfg.addresses,
        metrics=metrics,
        health_addresses=fleet_cfg.health_addresses,
        fault_injector=faults,
        breaker_failure_threshold=args.breaker_threshold,
        breaker_recovery_s=args.breaker_recovery,
        breaker_half_open_max=args.breaker_half_open,
        timeout_s=args.tutoring_timeout,
        deadline_floor_s=args.deadline_floor,
        hedge_after_s=fleet_cfg.hedge_after_s,
        stream_stall_s=fleet_cfg.stream_stall_s,
        queue_spill_depth=fleet_cfg.queue_spill_depth,
        warmup_s=fleet_cfg.warmup_s,
        warmup_weight=fleet_cfg.warmup_weight,
        health_poll_s=fleet_cfg.health_poll_s,
    )
    # Sharded control plane (lms/group_router.py): group 0 is the meta +
    # byte-compat group living in this node's existing data dir; groups
    # 1..N-1 each run the same Raft/WAL/snapshot stack under
    # data_dir/group<gid> with their Raft wire on base_port +
    # port_stride*gid. The LMS wire stays on the base port — the router
    # forwards cross-group RPCs to the owning group's leader node. With
    # groups = 1 (or absent) none of this runs and the boot is
    # byte-identical to the pre-sharding server.
    lms_nodes: Dict[int, LMSNode] = {0: lms_node}
    for gid in range(1, args.groups):
        group_addresses = {
            nid: "{}:{}".format(
                addr.rsplit(":", 1)[0],
                int(addr.rsplit(":", 1)[1]) + args.groups_port_stride * gid,
            )
            for nid, addr in addresses.items()
        }
        lms_nodes[gid] = LMSNode(
            args.id, group_addresses,
            os.path.join(args.data_dir, f"group{gid}"),
            raft_config=raft_config, snapshot_every=args.snapshot_every,
            fault_injector=faults, disk_fault_injector=disk_faults,
            metrics=metrics,
            replicate_timeout_s=args.replicate_timeout,
            replicate_budget_s=args.replicate_budget,
            storage_checksums=args.storage_checksums,
            storage_fsync=args.storage_fsync == "always",
            storage_recovery=args.storage_recovery,
            # One blob store per NODE (group 0 owns it); replication and
            # fetch-on-miss ride the base LMS ports.
            blobs=lms_node.blobs,
            blob_addresses=lms_node.addresses,
            fault_prefix=f"raft:{gid}",
        )

    def _make_servicer(group_node: LMSNode) -> LMSServicer:
        return LMSServicer(
            group_node.node,
            group_node.state,
            lms_node.blobs,
            gate=gate,
            tutoring_auth_key=tutoring_auth_key,
            metrics=metrics,
            # The LMSNode's map, mutated by runtime membership changes —
            # the servicer holds it live so blob fetch-on-miss tracks the
            # cluster.
            peer_addresses=lms_node.addresses,
            self_id=args.id,
            linearizable_reads=args.linearizable_reads,
            fault_injector=faults,
            tutoring_timeout_s=args.tutoring_timeout,
            deadline_floor_s=args.deadline_floor,
            blob_fetch_timeout_s=args.blob_fetch_timeout,
            tutoring_pool=pool,
        )

    servicer = _make_servicer(lms_node)
    server = grpc.aio.server(
        options=[
            ("grpc.max_send_message_length", 50 * 1024 * 1024),
            ("grpc.max_receive_message_length", 50 * 1024 * 1024),
        ]
    )
    router = None
    if args.groups > 1:
        inner = {0: servicer}
        for gid in range(1, args.groups):
            inner[gid] = _make_servicer(lms_nodes[gid])
        router = RoutedLMSServicer(
            lms_nodes, inner, lms_node.addresses, args.id,
            initial_map=RoutingMap.initial(args.groups),
            metrics=metrics,
            router_secret=args.groups_secret or "",
        )
        rpc.add_LMSServicer_to_server(router, server)
    else:
        rpc.add_LMSServicer_to_server(servicer, server)
    rpc.add_RaftServiceServicer_to_server(
        # The LIVE address map (membership changes mutate it): GetLeader
        # must report a membership-added leader's address, or clients
        # could never re-discover it from this peer.
        RaftServicer(lms_node.node, lms_node.addresses,
                     kv=lms_node.state.data["kv"]),
        server,
    )
    rpc.add_FileTransferServiceServicer_to_server(
        FileTransferServicer(lms_node.blobs), server
    )
    server.add_insecure_port(f"[::]:{args.port}")
    await server.start()
    await lms_node.start()
    # Each extra group's Raft wire gets its own port (stride off the base
    # port); the group's LMS surface stays in-process behind the router.
    group_servers = []
    for gid in range(1, args.groups):
        group_server = grpc.aio.server()
        rpc.add_RaftServiceServicer_to_server(
            RaftServicer(lms_nodes[gid].node, lms_nodes[gid].addresses,
                         kv=lms_nodes[gid].state.data["kv"]),
            group_server,
        )
        group_server.add_insecure_port(
            f"[::]:{args.port + args.groups_port_stride * gid}"
        )
        await group_server.start()
        await lms_nodes[gid].start()
        group_servers.append(group_server)
    groups_admin = GroupsAdmin(lms_nodes, router=router)
    campaigns = CampaignRunner(faults, disk_faults, metrics=metrics)
    # Node-local telemetry timeline: a sampler thread folds /metrics
    # snapshots into a bounded ring, served at GET /admin/timeline and
    # merged cluster-wide by scripts/telemetry.py.
    sampler = None
    if args.telemetry:
        sampler = TimelineSampler(
            metrics, interval_s=args.telemetry_interval,
            max_points=args.telemetry_ring,
        ).start()
    # The router's health poller: drain-driven ejection/rejoin and
    # queue-depth signals from each tutoring node's /healthz plane.
    pool.start()
    admin, admin_get = make_admin(
        lms_node, faults, disk_faults, campaigns,
        timeline=sampler.timeline if sampler is not None else None,
        pool=pool,
        groups_admin=groups_admin,
    )

    health = None
    if args.metrics_port is not None:
        from ..utils.healthz import HealthServer

        health = HealthServer(
            metrics,
            health=make_health(args.id, lms_node, pool, faults),
            admin=admin,
            admin_get=admin_get,
            port=args.metrics_port,
        )
        bound = await health.start()
        log.info("health/metrics endpoint on http://127.0.0.1:%d", bound)
    log.info("LMS node %d serving on %d (peers: %s)", args.id, args.port,
             addresses)

    async def report():
        while True:
            await asyncio.sleep(args.metrics_period)
            log.info("metrics %s", json.dumps(metrics.snapshot()))

    reporter = asyncio.get_running_loop().create_task(report())
    # Serving-loop heartbeat: a handler that blocks this loop (sync IO, a
    # long pure-Python stretch) surfaces as serving_tick_lag/-_stalls in
    # /metrics instead of being inferred from p99 tails. Distinct from the
    # Raft tick watchdog: this loop also owns every gRPC handler.
    watchdog = asyncio.get_running_loop().create_task(
        make_serving_watchdog(metrics).run()
    )
    try:
        await server.wait_for_termination()
    finally:
        reporter.cancel()
        watchdog.cancel()
        campaigns.cancel()  # sync bookkeeping on CampaignRunner, not a task
        # Reap the cancelled loops: confirms the CancelledError was
        # delivered (their cleanup ran) before tearing down what they
        # poke at, and surfaces any exception they died with.
        await asyncio.gather(reporter, watchdog, return_exceptions=True)

        async def _shutdown() -> None:
            await pool.close()
            if sampler is not None:
                sampler.stop()
            if health is not None:
                await health.stop()
            if router is not None:
                await router.close()
            for gid in range(1, args.groups):
                await lms_nodes[gid].stop()
            for group_server in group_servers:
                await group_server.stop(0.5)
            await lms_node.stop()

        # One bounded await for the whole teardown sequence: if serve()
        # itself is being cancelled (asyncio.run cancels the main task on
        # KeyboardInterrupt), a second CancelledError would otherwise
        # abort the cleanup at whichever raw await it happened to be in.
        await asyncio.wait_for(_shutdown(), timeout=30.0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("id", type=int, nargs="?", default=None,
                        help="node id (1-based)")
    parser.add_argument("port", type=int, nargs="?", default=None,
                        help="port to serve on")
    parser.add_argument("peers", nargs="*",
                        help="cluster peer ports or host:port, ids 1..N")
    parser.add_argument("--config", default=None,
                        help="TOML deployment file (config.py); use with "
                             "--id instead of positionals")
    parser.add_argument("--id", type=int, dest="id_flag", default=None,
                        help="node id when using --config")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--data-dir", default=None,
                        help="state directory (default ./lms_node_<id>)")
    parser.add_argument("--tutoring", default=None,
                        help="tutoring fleet address(es): a single "
                        "host:port (one-node fleet, fully "
                        "back-compatible) or a comma-separated list "
                        "routed with cache-affinity rendezvous hashing "
                        "+ per-node breakers/spill/hedging "
                        "([tutoring_fleet] addresses in the TOML)")
    parser.add_argument("--tutoring-health", default=None,
                        help="comma-separated /healthz endpoints "
                        "(host:port of each tutoring node's metrics "
                        "plane, same order as --tutoring): enables the "
                        "router's drain-aware health poller")
    parser.add_argument("--tutoring-hedge-after", type=float,
                        default=0.35,
                        help="hedge a tutoring forward to the "
                        "second-choice node after this many seconds of "
                        "silence (first answer wins, loser cancelled; "
                        "0 disables hedging)")
    parser.add_argument("--tutoring-stream-stall", type=float,
                        default=2.0,
                        help="per-chunk stall watchdog for streamed "
                        "tutoring forwards: if an OPEN stream goes this "
                        "many seconds without yielding a chunk the node "
                        "is treated as failed (breaker records it) and "
                        "the stream resumes at the last delivered offset "
                        "on the next candidate (0 disables)")
    parser.add_argument("--tutoring-queue-spill", type=int, default=8,
                        help="spill to the second-choice node when the "
                        "affinity node's serving queue is deeper than "
                        "this (and the second's is not)")
    parser.add_argument("--tutoring-warmup", type=float, default=5.0,
                        help="warm-up ramp seconds for a rejoined/added "
                        "tutoring node (its key share ramps to full as "
                        "its prefix cache refills)")
    parser.add_argument("--tutoring-warmup-weight", type=float,
                        default=0.25,
                        help="initial ring weight of a warming node")
    parser.add_argument("--tutoring-health-poll", type=float, default=1.0,
                        help="router health-poll cadence in seconds")
    parser.add_argument("--tutoring-auth-key-file", default=None,
                        help="file holding the LMS↔tutoring shared secret "
                        "(must match the tutoring server's --auth-key-file)")
    parser.add_argument("--gate-model", default=None,
                        help="BERT gate model preset ('bert-base-uncased' or "
                             "'tiny'); omit to disable the gate")
    parser.add_argument("--gate-checkpoint", default=None)
    parser.add_argument("--gate-vocab", default=None)
    parser.add_argument("--gate-threshold", type=float, default=0.6)
    parser.add_argument("--gate-quant", default=None, choices=["int8"],
                        help="weight-only int8 for the BERT gate")
    parser.add_argument("--groups", type=int, default=1,
                        help="number of independent LMS Raft groups "
                             "([groups] count in the TOML): 1 (default) "
                             "is the classic single-group deployment, "
                             "byte-compatible with existing data dirs; "
                             ">1 shards state by course behind the "
                             "group router")
    parser.add_argument("--groups-port-stride", type=int, default=1000,
                        help="port offset between group Raft planes: "
                             "group g's Raft wire listens on base port "
                             "+ stride*g on every node")
    parser.add_argument("--groups-secret", default="",
                        help="shared router HMAC key ([groups] secret): "
                             "signs forwarded x-lms-* control metadata "
                             "so clients cannot forge group targeting "
                             "or auth salts/tokens; must match on every "
                             "node")
    parser.add_argument("--election-timeout", type=float, default=0.5)
    parser.add_argument("--heartbeat-interval", type=float, default=0.1)
    parser.add_argument("--metrics-period", type=float, default=60.0)
    parser.add_argument("--snapshot-every", type=int, default=64,
                        help="full-state snapshot cadence in applied commands")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="HTTP /healthz + /metrics endpoint (0 = "
                             "ephemeral); omit to disable")
    parser.add_argument("--no-telemetry", action="store_true",
                        help="disable the node-local telemetry timeline "
                             "(sampler thread + GET /admin/timeline)")
    parser.add_argument("--telemetry-interval", type=float, default=1.0,
                        help="telemetry timeline sample interval in "
                             "seconds")
    parser.add_argument("--telemetry-ring", type=int, default=600,
                        help="telemetry timeline ring length (samples "
                             "retained per node)")
    parser.add_argument("--breaker-threshold", type=int, default=5,
                        help="consecutive tutoring failures that open the "
                             "circuit (degraded instructor-queue answers)")
    parser.add_argument("--breaker-recovery", type=float, default=10.0,
                        help="seconds the tutoring circuit stays open "
                             "before a half-open probe")
    parser.add_argument("--breaker-half-open", type=int, default=1,
                        help="concurrent probe calls allowed while "
                             "half-open")
    parser.add_argument("--tutoring-timeout", type=float, default=120.0,
                        help="cap on the tutoring forward when the client "
                             "sent no deadline")
    parser.add_argument("--deadline-floor", type=float, default=0.25,
                        help="remaining-budget floor below which the LMS "
                             "degrades instead of forwarding to tutoring")
    parser.add_argument("--blob-fetch-timeout", type=float, default=5.0,
                        help="per-peer cap on blob fetch-on-miss FetchFile "
                             "RPCs; each attempt also spends the calling "
                             "request's remaining deadline budget")
    parser.add_argument("--replicate-timeout", type=float, default=30.0,
                        help="per-peer cap on post-upload SendFile "
                             "replication streams")
    parser.add_argument("--replicate-budget", type=float, default=60.0,
                        help="overall budget for one upload's replication "
                             "sweep across all peers; peers it never "
                             "reaches heal via fetch-on-miss")
    parser.add_argument("--fault-seed", type=int, default=0,
                        help="seed for the /admin/faults chaos injectors "
                             "(network and disk; deterministic replay)")
    parser.add_argument("--storage-no-checksums", action="store_true",
                        help="write legacy v1 (un-checksummed) WAL/snapshot "
                             "records; v2 CRC framing is the default")
    parser.add_argument("--storage-fsync", default="always",
                        choices=["always", "never"],
                        help="fsync policy for WAL appends ('never' trades "
                             "crash durability for latency; dev/bench only)")
    parser.add_argument("--storage-recovery", default="rejoin",
                        choices=["rejoin", "fail"],
                        help="on corrupt WAL/snapshot: 'rejoin' discards "
                             "local state and restores from the leader via "
                             "InstallSnapshot; 'fail' refuses to start")
    parser.add_argument("--no-linearizable-reads", action="store_true",
                        help="serve reads from local state without the "
                             "leadership fence (the reference's behavior)")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="device for the in-process BERT gate: 'cuda' (default; "
             "raises without a card) or 'cpu'",
    )
    args = parser.parse_args(argv)
    args.linearizable_reads = not args.no_linearizable_reads
    args.storage_checksums = not args.storage_no_checksums
    args.telemetry = not args.no_telemetry
    if args.config:
        from ..config import apply_file_defaults, load_config

        cfg = load_config(args.config)
        args.id = args.id_flag if args.id_flag is not None else args.id
        if args.id is None:
            parser.error("--config requires --id <node id>")
        if args.id not in cfg.cluster.nodes:
            parser.error(f"node id {args.id} not in [cluster.nodes]")
        # Topology always comes from the file; everything else merges with
        # explicit-flags-win precedence.
        args.peers = [cfg.cluster.nodes[k] for k in sorted(cfg.cluster.nodes)]
        args.port = int(cfg.cluster.nodes[args.id].rsplit(":", 1)[1])
        # [tutoring_fleet] addresses win over the single [tutoring]
        # address when configured; both merge with explicit-flags-win
        # precedence like everything else.
        fleet = cfg.tutoring_fleet
        apply_file_defaults(args, parser, {
            "data_dir": os.path.join(cfg.cluster.data_dir, f"node{args.id}"),
            "tutoring": (",".join(fleet.addresses) if fleet.addresses
                         else cfg.tutoring.address),
            "tutoring_health": (",".join(fleet.health_addresses)
                                if fleet.health_addresses else None),
            "tutoring_hedge_after": fleet.hedge_after_s,
            "tutoring_stream_stall": fleet.stream_stall_s,
            "tutoring_queue_spill": fleet.queue_spill_depth,
            "tutoring_warmup": fleet.warmup_s,
            "tutoring_warmup_weight": fleet.warmup_weight,
            "tutoring_health_poll": fleet.health_poll_s,
            "tutoring_auth_key_file": cfg.tutoring.auth_key_file,
            "gate_model": cfg.gate.model,
            "gate_checkpoint": cfg.gate.checkpoint,
            "gate_vocab": cfg.gate.vocab,
            "gate_threshold": cfg.gate.threshold,
            "gate_quant": cfg.gate.quant,
            "groups": cfg.groups.count,
            "groups_port_stride": cfg.groups.port_stride,
            "groups_secret": cfg.groups.secret,
            "election_timeout": cfg.cluster.election_timeout,
            "heartbeat_interval": cfg.cluster.heartbeat_interval,
            "metrics_period": cfg.cluster.metrics_period,
            "snapshot_every": cfg.cluster.snapshot_every,
            "breaker_threshold": cfg.resilience.breaker_failure_threshold,
            "breaker_recovery": cfg.resilience.breaker_recovery_s,
            "breaker_half_open": cfg.resilience.breaker_half_open_max,
            "tutoring_timeout": cfg.resilience.tutoring_timeout_s,
            "deadline_floor": cfg.resilience.deadline_floor_s,
            "blob_fetch_timeout": cfg.resilience.blob_fetch_timeout_s,
            "replicate_timeout": cfg.resilience.replicate_timeout_s,
            "replicate_budget": cfg.resilience.replicate_budget_s,
            "fault_seed": cfg.resilience.fault_seed,
            "storage_fsync": cfg.storage.fsync,
            "storage_recovery": cfg.storage.recovery,
            "telemetry_interval": cfg.telemetry.sample_interval_s,
            "telemetry_ring": cfg.telemetry.ring_points,
        }, argv=argv)
        if not args.no_telemetry:
            # Negative flag can't carry the file value through the
            # sentinel probe; mirror the linearizable_reads merge.
            args.telemetry = cfg.telemetry.enabled
        if not args.no_linearizable_reads:
            args.linearizable_reads = cfg.cluster.linearizable_reads
        if not args.storage_no_checksums:
            # Negative flag can't carry the file value through the
            # sentinel probe; mirror the linearizable_reads merge.
            args.storage_checksums = cfg.storage.checksums
        # [tracing]: rebuild the process tracer (ring size, exemplar pins,
        # kill switch) before the first request can open a span.
        from ..utils.tracing import configure_from

        configure_from(cfg.tracing)
    elif args.id is None or args.port is None or not args.peers:
        parser.error("need either positional <id> <port> <peers...> or "
                     "--config <file> --id <node id>")
    if args.data_dir is None:
        args.data_dir = f"lms_node_{args.id}"

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    asyncio.run(serve_async(args))


if __name__ == "__main__":
    main()
