"""LMSNode: one LMS cluster member — Raft node + state machine + stores.

The port's copy of `distributed_lms_raft_llm_tpu/lms/node.py`,
its logic as it is.

Composition (reference equivalent: the `serve()` wiring of LMSService ↔
RaftService ↔ FileTransferServicer, GUI_RAFT_LLM_SourceCode/
lms_server.py:1561-1601):

    RaftNode (asyncio, durable WAL)
      └─ apply ─► LMSState.apply(op, args)
                   ├─ SnapshotStore.save(state, applied_index)
                   └─ leader: schedule blob push to followers (uploads)

Boot order: restore snapshot → construct RaftCore with last_applied at the
snapshot index → WAL suffix replays through the same apply path.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
from typing import Dict, Optional

from ..raft import FileStorage, RaftConfig, RaftNode, decode_command
from ..raft.grpc_transport import GrpcTransport
from ..raft.messages import Entry
from ..raft.storage import WALCorruption
from ..utils import metrics_registry as metric
from ..utils.diskfaults import REAL_FS, FaultyFS
from ..utils.guards import make_tick_watchdog
from ..utils.resilience import Deadline
from .persistence import BlobStore, SnapshotCorruption, SnapshotStore
from .service import replicate_file_to_peers
from .state import LMSState

log = logging.getLogger(__name__)


class LMSNode:
    def __init__(
        self,
        node_id: int,
        addresses: Dict[int, str],
        data_dir: str,
        *,
        raft_config: Optional[RaftConfig] = None,
        transport=None,
        snapshot_every: int = 64,
        fault_injector=None,
        disk_fault_injector=None,
        metrics=None,
        replicate_timeout_s: float = 30.0,
        replicate_budget_s: float = 60.0,
        storage_checksums: bool = True,
        storage_fsync: bool = True,
        storage_recovery: str = "rejoin",
        blobs=None,
        blob_addresses: Optional[Dict[int, str]] = None,
        fault_prefix: str = "raft",
    ):
        # Multi-group hosting (lms/group_router.py): a non-zero group's
        # LMSNode shares the primary node's BlobStore (`blobs=`) — blob
        # bytes are node-scoped, only metadata shards — and replicates
        # files over the BASE LMS ports (`blob_addresses=`), since the
        # per-group Raft ports carry no FileTransfer servicer. Its chaos
        # target namespace is `fault_prefix` (`raft:<gid>`), so campaigns
        # can kill one group's leader while the others keep serving. The
        # defaults keep a single-group node byte-identical to before.
        # snapshot_every > 1 amortizes the full-state JSON rewrite (the WAL
        # already guarantees durability; on crash, at most snapshot_every
        # entries replay). The reference rewrote everything per command.
        if storage_recovery not in ("rejoin", "fail"):
            raise ValueError(
                f"storage_recovery must be 'rejoin' or 'fail', "
                f"got {storage_recovery!r}"
            )
        self.node_id = node_id
        self.addresses = dict(addresses)
        os.makedirs(data_dir, exist_ok=True)
        fs = REAL_FS
        if disk_fault_injector is not None:
            # Disk chaos mirrors the network plane: every byte the stores
            # persist routes through the injector (admin target "disk").
            fs = FaultyFS(fs, disk_fault_injector)
        self._fs = fs
        self.metrics = metrics
        self.snapshot_every = max(1, snapshot_every)
        self._applies_since_snapshot = 0
        # [resilience] replicate_timeout_s / replicate_budget_s: per-peer
        # cap and whole-sweep budget for post-commit upload replication.
        self._replicate_timeout_s = replicate_timeout_s
        self._replicate_budget_s = replicate_budget_s

        snap_path = os.path.join(data_dir, "lms_data.json")
        wal_path = os.path.join(data_dir, "raft_wal.jsonl")
        self._owns_blobs = blobs is None
        self.blobs = blobs if blobs is not None else BlobStore(
            os.path.join(data_dir, "uploads"), fs=fs, metrics=metrics
        )
        self._blob_addresses = blob_addresses
        # Recovery mode must survive a crash MID-recovery: the quarantine
        # leaves clean (empty) stores behind, so without a durable marker
        # the next boot would resume normal voting before the re-sync
        # finished — reopening the double-vote window the mode closes.
        # The marker is written before the quarantine renames and removed
        # only when the heal completes (_on_recovered).
        self._recovery_marker = os.path.join(data_dir, "storage_recovering")
        recovering = fs.exists(self._recovery_marker)
        if recovering:
            log.warning("resuming interrupted storage recovery "
                        "(marker %s present)", self._recovery_marker)
            # A crash between the WAL/snapshot renames and the blob-tree
            # rename leaves the (possibly bit-flipped) blobs live while
            # the log loads clean — the corruption handler below never
            # runs, and the healed node would serve corrupt blob bytes.
            # The marker makes the quarantine idempotent: every
            # marker-resume boot re-quarantines the blob tree (already
            # -healed blobs re-fetch on miss).
            self._quarantine_blob_tree(data_dir)
            fs.fsync_dir(os.path.abspath(data_dir))
        try:
            self.snapshots = SnapshotStore(snap_path, fs=fs, metrics=metrics)
            self.state, applied = self.snapshots.load()
            storage = FileStorage(
                wal_path, fsync=storage_fsync, checksums=storage_checksums,
                fs=fs, metrics=metrics,
            )
        except (SnapshotCorruption, WALCorruption) as e:
            if storage_recovery == "fail":
                # Refuse standalone start: local state cannot be trusted
                # and the operator asked not to auto-discard it.
                raise
            # Rejoin mode: the WAL and snapshot are one durability unit
            # (the snapshot anchors where replay resumes) — quarantine
            # BOTH, boot empty in recovering mode, and let the leader's
            # InstallSnapshot/replication path restore every committed
            # write. No acked write is lost cluster-wide: a quorum of
            # healthy replicas still holds it.
            log.error("local storage corrupt (%s); discarding state and "
                      "rejoining via leader replication", e)
            marker_f = fs.open(self._recovery_marker, "w", encoding="utf-8")
            with marker_f:
                fs.write(marker_f, "recovering\n")
                fs.fsync(marker_f)
            for path in (wal_path, snap_path):
                if fs.exists(path):
                    # Quarantine, not an atomic write: the source is a
                    # closed, already-(un)durable file — there is no open
                    # handle to fsync; the dir fsync below persists the
                    # swap.  # lint: disable-next=durable-rename
                    fs.replace(path, path + ".corrupt")
            # The blob tree shares the fate of the WAL.
            self._quarantine_blob_tree(data_dir)
            fs.fsync_dir(os.path.abspath(data_dir))
            recovering = True
            self.snapshots = SnapshotStore(snap_path, fs=fs, metrics=metrics)
            self.state, applied = LMSState(), 0
            storage = FileStorage(
                wal_path, fsync=storage_fsync, checksums=storage_checksums,
                fs=fs, metrics=metrics,
            )
        self._last_applied_index = applied
        # Replica digest chain (cross-replica convergence audit, see
        # LMSState.digest): recomputed from the restored snapshot so a
        # restarted node REJOINS the chain at its applied index instead
        # of starting a fresh one.
        self.state_digest = self._fold_digest(applied)
        if metrics is not None:
            metrics.set_gauge(metric.STORAGE_RECOVERING, int(recovering))

        transport = transport or GrpcTransport(self.addresses)
        if fault_injector is not None:
            # Chaos over real sockets: per-peer drop/delay/error/duplicate
            # on the live Raft egress, driven by the admin endpoint.
            from ..utils.faults import FaultyTransport

            transport = FaultyTransport(transport, fault_injector,
                                        prefix=fault_prefix)
        cfg = raft_config or RaftConfig()
        self.node = RaftNode(
            node_id,
            # id -> address mapping seeds raft membership; a durable
            # membership from a previous run's config changes overrides it.
            dict(self.addresses),
            storage,
            transport,
            apply_cb=self._apply,
            install_cb=self._install_snapshot,
            config=raft_config,
            last_applied=applied,
            recovering=recovering,
            # Tick-lag watchdog (utils/guards.py): loop stalls export via
            # /metrics as raft_tick_lag/raft_tick_stalls. Warn threshold
            # tracks the heartbeat interval — a stall that long delays
            # heartbeats and risks spurious elections.
            watchdog=make_tick_watchdog(
                metrics, tick_interval=cfg.heartbeat_interval
            ),
        )
        # Keep the file-replication peer list in sync with raft membership
        # (a server added at runtime receives blob anti-entropy too).
        self.node.membership_cb = self._on_membership
        self.node.on_recovered = self._on_recovered
        self._on_membership(self.node.core.members)
        # Compact the WAL up to the restored snapshot and prime the
        # InstallSnapshot payload for lagging peers (a restart loses the
        # in-memory copy; the core keeps only (index, term) durably).
        if applied > 0:
            self.node.compact(applied, self._snapshot_bytes())

    # ------------------------------------------------------------------ api

    async def start(self) -> None:
        await self.node.start()

    async def stop(self) -> None:
        await self.node.stop()
        self.snapshots.save(self.state, self._last_applied_index)

    @property
    def recovering(self) -> bool:
        """True while local storage was discarded and the node is being
        restored from the leader (surfaced in /healthz)."""
        return self.node.core.recovering

    # ------------------------------------------------------------ internals

    def _quarantine_blob_tree(self, data_dir: str) -> None:
        """Rename the blob tree aside and mount a fresh, empty one.

        Blobs carry no integrity headers, so whatever corrupted the log
        may have silently flipped blob bytes too — a recovering node must
        not serve them. Quarantined blobs heal via fetch-on-miss once the
        metadata re-replicates (a quorum of healthy peers holds every
        acked upload)."""
        if not self._owns_blobs:
            # Shared store (multi-group hosting): the PRIMARY node owns
            # the blob tree and its quarantine lifecycle; a group member
            # finding ITS log corrupt says nothing about the shared blobs.
            return
        fs = self._fs
        uploads_dir = os.path.join(data_dir, "uploads")
        if not fs.exists(uploads_dir):
            return
        dst, n = uploads_dir + ".corrupt", 0
        while fs.exists(dst):  # dir renames don't overwrite
            n += 1
            dst = f"{uploads_dir}.corrupt.{n}"
        # Quarantine, not an atomic write: the sources are closed,
        # already-(un)durable files — there is no open handle to fsync;
        # the caller's dir fsync persists the swap.
        # lint: disable-next=durable-rename
        fs.replace(uploads_dir, dst)
        self.blobs = BlobStore(uploads_dir, fs=fs, metrics=self.metrics)

    def _on_recovered(self) -> None:
        log.info("storage recovery complete: log caught up to the "
                 "leader's commit index")
        if self._fs.exists(self._recovery_marker):
            self._fs.remove(self._recovery_marker)
            self._fs.fsync_dir(os.path.dirname(self._recovery_marker))
        if self.metrics is not None:
            self.metrics.set_gauge(metric.STORAGE_RECOVERING, 0)

    def _on_membership(self, members) -> None:
        for nid, address in members.items():
            if address:
                self.addresses[nid] = address
        for nid in list(self.addresses):
            if nid not in members:
                self.addresses.pop(nid, None)

    def _fold_digest(self, index: int) -> str:
        """Digest-chain link at `index`: a pure function of (applied
        index, state content). Every replica that applied the same
        committed prefix computes the same value — and because it is
        derived from state rather than accumulated, a replica restarting
        from its snapshot or rebuilt via InstallSnapshot RESUMES the
        chain at its index instead of forking it. Exported as the
        raft_state_digest gauge (low 32 bits) and via /admin/raft; the
        semester sim's replicas_converged SLO compares it per group."""
        digest = hashlib.sha256(
            f"{index}:{self.state.digest()}".encode()
        ).hexdigest()[:16]
        if self.metrics is not None:
            self.metrics.set_gauge(
                metric.RAFT_STATE_DIGEST, int(digest[:8], 16)
            )
        return digest

    def _snapshot_bytes(self) -> bytes:
        # NO sort_keys: the applied_requests idempotency ledger dedupes by
        # dict insertion order (oldest-first eviction must match on every
        # replica); sorting would rebuild snapshot-installed replicas in
        # lexicographic order and diverge them from live-applied ones.
        return json.dumps(self.state.data).encode()

    def _install_snapshot(self, index: int, data: bytes) -> None:
        """A leader's InstallSnapshot replaced our log prefix: swap in its
        state wholesale, persist it, and resume applying after `index`."""
        self.state.replace(json.loads(data.decode()))
        self._last_applied_index = index
        self.state_digest = self._fold_digest(index)
        self.snapshots.save(self.state, index)
        self._applies_since_snapshot = 0
        log.info("installed leader snapshot at index %d", index)

    def _apply(self, index: int, entry: Entry) -> None:
        op, args = decode_command(entry.command)
        self.state.apply(op, args)
        self._last_applied_index = index
        self.state_digest = self._fold_digest(index)
        self._applies_since_snapshot += 1
        if self._applies_since_snapshot >= self.snapshot_every:
            self.snapshots.save(self.state, index)
            self._applies_since_snapshot = 0
            # The state snapshot at `index` is durable: the WAL prefix it
            # covers can go, bounding the log (the reference's analogue grew
            # forever — it never persisted, let alone compacted).
            self.node.compact(index, self._snapshot_bytes())
        # Bulk data plane: after the metadata commits, the leader streams the
        # file itself to followers (reference lms_server.py:1328-1334).
        if op in ("PostAssignment", "PostCourseMaterial") and self.node.is_leader:
            rel = args["filepath"]
            task = asyncio.ensure_future(
                replicate_file_to_peers(
                    # Group members stream blobs over the base LMS ports
                    # (their own Raft ports carry no FileTransfer plane).
                    self._blob_addresses if self._blob_addresses is not None
                    else self.addresses,
                    self.node_id, self.blobs, rel,
                    per_peer_timeout_s=self._replicate_timeout_s,
                    # One budget for the whole sweep: a wedged follower
                    # cannot stack per-peer caps into minutes of leader
                    # loop time per upload.
                    deadline=Deadline.after(self._replicate_budget_s),
                    metrics=self.metrics,
                )
            )
            task.add_done_callback(_log_replication_result)


def _log_replication_result(task: asyncio.Task) -> None:
    try:
        results = task.result()
    except Exception as e:  # pragma: no cover - network dependent
        log.warning("file replication task failed: %s", e)
        return
    if results:
        log.info("file replicated: %s", results)
