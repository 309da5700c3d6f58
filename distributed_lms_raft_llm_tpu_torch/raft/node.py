"""RaftNode: the asyncio runner around the sans-IO core.

The port's copy of `distributed_lms_raft_llm_tpu/raft/node.py`,
its logic as it is.

One task owns the core (single-threaded by construction — the race-free
replacement for the reference's ticker-thread + gRPC-thread-pool mutation of
shared state, defect D10). Responsibilities:

- periodic `core.tick()` (elections, heartbeats at the configured interval —
  not per-tick like the reference's D11);
- draining the core's outbox through a `Transport` and feeding responses
  back in;
- resolving `propose()` futures when entries COMMIT (the reference ACKs
  before replication, defect D9) — and failing them on leadership loss;
- handing newly committed commands to the application's apply callback.

Transports are pluggable: `MemTransport` (deterministic in-process cluster
with drop/partition/delay injection) and `raft.grpc_transport.GrpcTransport`
(the wire).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from ..utils.tracing import get_tracer
from .core import NotLeader, RaftConfig, RaftCore, Role
from .messages import (
    NOOP,
    AppendRequest,
    AppendResponse,
    Entry,
    InstallSnapshotRequest,
    InstallSnapshotResponse,
    TimeoutNowRequest,
    TimeoutNowResponse,
    VoteRequest,
    VoteResponse,
    is_membership,
)

log = logging.getLogger(__name__)

ApplyCallback = Callable[[int, Entry], None]
# (last_included_index, snapshot_bytes) -> None: replace the app state.
InstallCallback = Callable[[int, bytes], None]


class Transport:
    """Delivers a request to a peer and returns its response (or raises)."""

    async def send(self, peer: int, message) -> object:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class RaftNode:
    def __init__(
        self,
        node_id: int,
        peer_ids,
        storage,
        transport: Transport,
        apply_cb: Optional[ApplyCallback] = None,
        config: Optional[RaftConfig] = None,
        *,
        install_cb: Optional[InstallCallback] = None,
        tick_interval: float = 0.01,
        seed: Optional[int] = None,
        last_applied: int = 0,
        recovering: bool = False,
        watchdog=None,  # utils.guards.LoopWatchdog (optional)
    ):
        self.core = RaftCore(
            node_id, peer_ids, storage, config, now=time.monotonic(), seed=seed,
            last_applied=last_applied, recovering=recovering,
        )
        self.transport = transport
        self.apply_cb = apply_cb
        self.install_cb = install_cb
        self.tick_interval = tick_interval
        # Loop-stall watchdog: the tick loop reports its scheduling lag so
        # anything blocking this event loop (sync IO, a device readback, a
        # long apply) is visible as the `raft_tick_lag` histogram and
        # `raft_tick_stalls` counter in /metrics instead of as mystery
        # election churn.
        self.watchdog = watchdog
        # index -> [(expected_term, future)]: a waiter only resolves if the
        # entry committed at its index carries the term it was proposed in —
        # otherwise a new leader's different entry at the same index would be
        # mistaken for our commit.
        self._commit_waiters: Dict[int, List[Tuple[int, asyncio.Future]]] = {}
        self._read_barrier: Optional[asyncio.Future] = None
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        # Observer for membership changes (id -> address map); the LMS node
        # uses it to keep its file-replication peer list current.
        self.membership_cb: Optional[Callable[[Dict[int, str]], None]] = None
        # Fires once when storage-recovery mode clears (the re-synced log
        # holds everything the leader committed); the LMS node uses it to
        # drop the storage_recovering gauge back to 0.
        self.on_recovered: Optional[Callable[[], None]] = None
        self._was_recovering = self.core.recovering
        self._last_members = dict(self.core.members)
        self._sync_transport_addresses()

    # -------------------------------------------------------------- public

    @property
    def node_id(self) -> int:
        return self.core.node_id

    @property
    def is_leader(self) -> bool:
        return self.core.role is Role.LEADER

    @property
    def leader_id(self) -> Optional[int]:
        return self.core.leader_id

    async def start(self) -> None:
        self._tasks.append(asyncio.create_task(self._tick_loop()))

    async def stop(self) -> None:
        self._stopped = True
        # Snapshot AND clear before awaiting: completing tasks remove
        # themselves from the live list (tolerating the clear — see
        # _discard_task), and clearing after the awaits would race any
        # delivery task the outbox pump registered mid-await.
        pending = list(self._tasks)
        self._tasks.clear()
        for t in pending:
            t.cancel()
        for t in pending:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._fail_waiters(RuntimeError("raft node stopped"))
        await self.transport.close()

    async def propose(self, command: str, timeout: float = 10.0) -> int:
        """Replicate `command`; resolves with its index once COMMITTED.

        Under an active request trace this is the `raft.commit` span: the
        whole propose→append→quorum→apply path, ending when the commit
        waiter resolves (i.e. the entry has been applied locally). A no-op
        span outside any trace, so Raft-internal proposes cost nothing."""
        with get_tracer().span("raft.commit") as sp:
            index = self.core.propose(command, time.monotonic())
            sp.set_attr("index", index)
            return await self._await_commit(index, timeout)

    async def propose_config(
        self, members: Dict[int, str], timeout: float = 10.0
    ) -> int:
        """Change cluster membership by one server (add or remove); the new
        id -> address map takes effect on this leader immediately and the
        call resolves once the change entry COMMITS under the new quorum."""
        index = self.core.propose_config(members, time.monotonic())
        return await self._await_commit(index, timeout)

    async def _await_commit(self, index: int, timeout: float) -> int:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._commit_waiters.setdefault(index, []).append(
            (self.core.current_term, fut)
        )
        self._pump()
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise TimeoutError(f"entry {index} not committed within {timeout}s")

    async def transfer_leadership(
        self, target: Optional[int] = None, timeout: float = 5.0
    ) -> int:
        """Hand leadership to `target` (default: most caught-up member) and
        wait until this node has actually stepped down (or the transfer
        aborted and we are still leader — then raises TimeoutError).
        Returns the target node id."""
        chosen = self.core.transfer_leadership(time.monotonic(), target)
        self._pump()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.core.role is not Role.LEADER:
                return chosen
            if self.core.transfer_target is None:
                # Aborted (target unreachable / lost): surface it.
                raise TimeoutError(
                    f"leadership transfer to {chosen} aborted; still leader"
                )
            await asyncio.sleep(self.tick_interval)
        raise TimeoutError(f"leadership transfer to {chosen} timed out")

    async def read_barrier(self, timeout: float = 10.0) -> int:
        """Linearizable read fence: resolves once this node has PROVEN it is
        still the leader by committing an entry of its current term, with the
        state machine applied through that point.

        Implementation: propose a no-op and await its quorum commit (the
        log-barrier read — the wire-compatible alternative to a read-index
        round, since the frozen AppendEntries contract has no field to
        correlate a heartbeat round with). A deposed leader cannot commit in
        its term, so its reads fail (NotLeader/Timeout) instead of serving
        stale state; by the time the barrier resolves every prior committed
        entry has passed through apply_cb (commit waiters resolve in apply
        order). Concurrent readers coalesce onto one in-flight barrier, so a
        read burst costs one log entry, not one per read.
        """
        if self.core.role is not Role.LEADER:
            raise NotLeader(self.core.leader_id)
        if self._read_barrier is None or self._read_barrier.done():
            self._read_barrier = asyncio.ensure_future(
                self.propose(NOOP, timeout=timeout)
            )
        # shield: one cancelled reader (client gone) must not cancel the
        # barrier other coalesced readers are waiting on.
        return await asyncio.shield(self._read_barrier)

    # RPC entry points (called by the gRPC servicer / mem transport) ------

    def handle_vote_request(self, req: VoteRequest) -> VoteResponse:
        resp = self.core.on_vote_request(req, time.monotonic())
        self._pump()
        return resp

    def handle_append_request(self, req: AppendRequest) -> AppendResponse:
        resp = self.core.on_append_request(req, time.monotonic())
        self._pump()
        return resp

    def handle_timeout_now(self, req: TimeoutNowRequest) -> TimeoutNowResponse:
        resp = self.core.on_timeout_now(req, time.monotonic())
        self._pump()
        return resp

    def handle_install_snapshot(
        self, req: InstallSnapshotRequest
    ) -> InstallSnapshotResponse:
        resp = self.core.on_install_snapshot(req, time.monotonic())
        if self.core.pending_snapshot is not None:
            index, data = self.core.pending_snapshot
            self.core.pending_snapshot = None
            try:
                if self.install_cb is not None:
                    self.install_cb(index, data)
                # App state is durable; now raft state + WAL may advance.
                self.core.commit_installed_snapshot()
            except Exception:
                # Raft state never advanced, so answering success=False makes
                # the leader re-send the snapshot (after its resend throttle)
                # instead of streaming entries past a hole the app never
                # filled; this node keeps serving from its old state.
                log.exception("snapshot install failed at %d", index)
                self.core.abort_installed_snapshot()
                resp = InstallSnapshotResponse(
                    term=self.core.current_term, success=False
                )
        self._pump()
        return resp

    def compact(self, index: int, snapshot_data: bytes) -> None:
        """App-driven log compaction: the state snapshot at `index` is
        durable, so the WAL prefix through `index` can go (and `data` serves
        lagging peers via InstallSnapshot)."""
        self.core.compact(index, snapshot_data)

    # ------------------------------------------------------------ internals

    async def _tick_loop(self) -> None:
        # Lag is measured over the WHOLE iteration (tick + pump + sleep), so
        # both a slow apply callback and another task hogging the loop show
        # up — not just oversleep.
        prev = time.monotonic()
        while not self._stopped:
            self.core.tick(time.monotonic())
            self._pump()
            await asyncio.sleep(self.tick_interval)
            now = time.monotonic()
            if self.watchdog is not None:
                self.watchdog.observe(now - prev - self.tick_interval)
            prev = now

    def _sync_transport_addresses(self) -> None:
        """Push membership addresses into an address-keyed transport (the
        gRPC transport dials by core membership; MemTransport has none)."""
        addr = getattr(self.transport, "addresses", None)
        if addr is None:
            return
        for nid, address in self.core.members.items():
            if address:
                addr[nid] = address

    def _pump(self) -> None:
        """Apply newly committed entries and dispatch outbound messages."""
        for index, entry in self.core.take_applies():
            self._resolve_waiters(index, entry)
            # Membership entries configure raft itself (applied on append,
            # core._refresh_membership) — they never reach the app FSM.
            if (
                self.apply_cb is not None
                and entry.command != NOOP
                and not is_membership(entry.command)
            ):
                try:
                    self.apply_cb(index, entry)
                except Exception:
                    log.exception("apply callback failed at index %d", index)
        if self._was_recovering and not self.core.recovering:
            self._was_recovering = False
            if self.on_recovered is not None:
                try:
                    self.on_recovered()
                except Exception:
                    log.exception("on_recovered callback failed")
        if self.core.members != self._last_members:
            self._last_members = dict(self.core.members)
            self._sync_transport_addresses()
            if self.membership_cb is not None:
                try:
                    self.membership_cb(dict(self.core.members))
                except Exception:
                    log.exception("membership callback failed")
        if self.core.role is not Role.LEADER:
            self._fail_waiters(NotLeader(self.core.leader_id))
        for peer, message in self.core.drain_outbox():
            task = asyncio.ensure_future(self._deliver(peer, message))
            self._tasks.append(task)
            task.add_done_callback(self._discard_task)

    async def _deliver(self, peer: int, message) -> None:
        try:
            resp = await self.transport.send(peer, message)
        except Exception as e:
            log.debug("send to %d failed: %s", peer, e)
            return
        now = time.monotonic()
        if isinstance(message, VoteRequest) and isinstance(resp, VoteResponse):
            self.core.on_vote_response(peer, resp, now)
        elif isinstance(message, AppendRequest) and isinstance(resp, AppendResponse):
            self.core.on_append_response(peer, resp, now)
        elif isinstance(message, InstallSnapshotRequest) and isinstance(
            resp, InstallSnapshotResponse
        ):
            self.core.on_install_snapshot_response(peer, message, resp, now)
        elif isinstance(message, TimeoutNowRequest) and isinstance(
            resp, TimeoutNowResponse
        ):
            self.core.on_timeout_now_response(resp, now)
        self._pump()

    def _discard_task(self, task: asyncio.Task) -> None:
        try:
            self._tasks.remove(task)
        except ValueError:
            pass  # stop() already cleared the list

    def _resolve_waiters(self, index: int, entry: Entry) -> None:
        for term, fut in self._commit_waiters.pop(index, []):
            if fut.done():
                continue
            if entry.term == term:
                fut.set_result(index)
            else:
                # A different leader's entry won this slot; ours was lost.
                fut.set_exception(NotLeader(self.core.leader_id))

    def _fail_waiters(self, exc: Exception) -> None:
        if not self._commit_waiters:
            return
        for futs in self._commit_waiters.values():
            for _, fut in futs:
                if not fut.done():
                    fut.set_exception(exc)
        self._commit_waiters.clear()


class MemTransport(Transport):
    """In-process cluster transport with fault injection for tests.

    Shared `MemNetwork` routes messages between nodes synchronously (with an
    optional asyncio delay), supports dropping messages and partitioning
    node sets — the deterministic-simulation harness SURVEY.md §4 calls for.
    """

    def __init__(self, network: "MemNetwork", node_id: int):
        self.network = network
        self.node_id = node_id

    async def send(self, peer: int, message) -> object:
        return await self.network.deliver(self.node_id, peer, message)


class MemNetwork:
    def __init__(self, *, delay: float = 0.0):
        self.nodes: Dict[int, RaftNode] = {}
        self.delay = delay
        self.partitions: List[set] = []  # node sets that can talk internally
        self.drop_pairs: set = set()     # directed (src, dst) pairs to drop

    def register(self, node: RaftNode) -> None:
        self.nodes[node.node_id] = node

    def transport_for(self, node_id: int) -> MemTransport:
        return MemTransport(self, node_id)

    def partition(self, *groups) -> None:
        self.partitions = [set(g) for g in groups]

    def heal(self) -> None:
        self.partitions = []
        self.drop_pairs = set()

    def _blocked(self, src: int, dst: int) -> bool:
        if (src, dst) in self.drop_pairs:
            return True
        if self.partitions:
            return not any(src in g and dst in g for g in self.partitions)
        return False

    async def deliver(self, src: int, dst: int, message) -> object:
        if self._blocked(src, dst):
            raise ConnectionError(f"partitioned: {src} -> {dst}")
        if self.delay:
            await asyncio.sleep(self.delay)
        node = self.nodes.get(dst)
        if node is None or node._stopped:
            raise ConnectionError(f"node {dst} down")
        if isinstance(message, VoteRequest):
            resp = node.handle_vote_request(message)
        elif isinstance(message, AppendRequest):
            resp = node.handle_append_request(message)
        elif isinstance(message, InstallSnapshotRequest):
            resp = node.handle_install_snapshot(message)
        elif isinstance(message, TimeoutNowRequest):
            resp = node.handle_timeout_now(message)
        else:
            raise TypeError(type(message))
        if self._blocked(dst, src):
            raise ConnectionError(f"partitioned: {dst} -> {src}")
        return resp
