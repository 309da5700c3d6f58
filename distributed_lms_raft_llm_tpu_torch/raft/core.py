"""Sans-IO Raft core: the consensus state machine, no clocks, no sockets.

The port's copy of `distributed_lms_raft_llm_tpu/raft/core.py`,
its logic as it is.

A clean-room implementation of leader election + log replication (Raft §5)
replacing the reference's thread-racy, lockless version (reference:
GUI_RAFT_LLM_SourceCode/lms_server.py:107-697; defects D2 nextIndex
off-by-one, D3 missing Candidate state, D10 unsynchronized shared state,
D11 heartbeat-every-tick). Design:

- **Sans-IO**: every method is a synchronous transition taking explicit
  `now` timestamps; outbound messages accumulate in `outbox` for a runner
  (`raft.node`) to deliver. Single-threaded by construction — the runner is
  one asyncio task, so there is nothing to lock (SURVEY.md §5 race-detection
  strategy: safety by construction + deterministic simulation tests).
- **Durability**: current_term / voted_for / log changes go through the
  injected storage *before* any message referencing them leaves the node
  (the reference persisted none of these).
- **1-based log indexing**; index 0 is the empty sentinel.
- On winning an election the leader appends a no-op barrier entry so the
  new term can commit immediately (Raft §5.4.2 commit rule).
"""

from __future__ import annotations

import enum
import random
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

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
    decode_membership,
    encode_membership,
    is_membership,
    unwrap_snapshot,
    wrap_snapshot,
)


class Role(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


class RaftConfig:
    """Timing knobs (seconds). Defaults match textbook Raft; the reference's
    10-30s election timeouts (lms_server.py:672) are reproducible by
    construction-time override for wire-compat demos."""

    def __init__(
        self,
        election_timeout_min: float = 0.15,
        election_timeout_max: float = 0.30,
        heartbeat_interval: float = 0.05,
        max_entries_per_append: int = 64,
        snapshot_resend_interval: float = 2.0,
    ):
        assert election_timeout_min > 2 * heartbeat_interval
        self.election_timeout_min = election_timeout_min
        self.election_timeout_max = election_timeout_max
        self.heartbeat_interval = heartbeat_interval
        self.max_entries_per_append = max_entries_per_append
        # Unlike heartbeats, snapshot payloads are unbounded — don't re-send
        # one to the same peer more often than this while awaiting its ack.
        self.snapshot_resend_interval = snapshot_resend_interval


class RaftCore:
    def __init__(
        self,
        node_id: int,
        peer_ids: Sequence[int],
        storage: Any,  # raft.storage.FileStorage-shaped (duck-typed in sims)
        config: Optional[RaftConfig] = None,
        *,
        now: float = 0.0,
        seed: Optional[int] = None,
        last_applied: int = 0,
        recovering: bool = False,
    ):
        self.node_id = node_id
        # peer_ids: a sequence of ids, or an id -> address mapping (the
        # addresses then seed the membership map below).
        if isinstance(peer_ids, dict):
            boot_members = {int(k): v for k, v in peer_ids.items()}
        else:
            boot_members = {int(p): "" for p in peer_ids}
        boot_members.setdefault(node_id, "")
        self.peer_ids = [p for p in boot_members if p != node_id]
        self.storage = storage
        self.config = config or RaftConfig()
        self._rng = random.Random(node_id if seed is None else seed)

        # Persistent state (restored from storage). The log may be
        # compacted: `snapshot_index/term` anchor absolute indexing, and
        # `self.log` holds entries snapshot_index+1 .. last (Raft §7).
        (self.current_term, self.voted_for, self.log,
         self.snapshot_index, self.snapshot_term) = storage.load()
        # Application snapshot bytes at exactly snapshot_index, for
        # InstallSnapshot to lagging peers. Not persisted here — the app
        # primes it via `compact()` (at boot and after each state snapshot).
        self.snapshot_data: Optional[bytes] = None

        # Storage-recovery mode (lms.node sets this after discarding
        # corrupt local state): the node rejoins via the leader's normal
        # replication/InstallSnapshot path, but until its log has caught
        # up to the leader's commit index it neither CAMPAIGNS (an empty
        # log must not depose anyone) nor GRANTS votes (any vote cast
        # before the crash was lost with the WAL; voting again in the
        # same term could double-vote). Cleared on the first successful
        # AppendEntries whose leader_commit we fully hold.
        self.recovering = recovering

        # Volatile state.
        self.role = Role.FOLLOWER
        self.leader_id: Optional[int] = None
        self._proposed_term = self.current_term  # see start_election
        # A state-machine snapshot may cover a prefix of the log; start
        # commit/applied there so replay resumes after it (lms.persistence
        # stores applied_index in its snapshot).
        if last_applied > self.last_log_index:
            # Snapshot ahead of the WAL means log entries the snapshot
            # already covers were lost/truncated. Silently rewinding would
            # re-apply future committed entries ONTO snapshot state (double
            # apply). Fail fast; the operator restores the matching WAL or
            # wipes this node so it re-syncs from the leader.
            raise RuntimeError(
                f"state snapshot applied_index={last_applied} is ahead of "
                f"the WAL (last index {self.last_log_index}): WAL lost or "
                f"truncated; refusing to start to avoid re-applying "
                f"committed entries onto snapshot state"
            )
        if last_applied < self.snapshot_index:
            raise RuntimeError(
                f"state snapshot applied_index={last_applied} predates the "
                f"WAL's compaction point {self.snapshot_index}: entries "
                f"{last_applied + 1}..{self.snapshot_index} are gone, the "
                f"state can never catch up; restore a matching state "
                f"snapshot or wipe this node"
            )
        self.commit_index = last_applied
        self.last_applied = last_applied
        # Follower side: a staged snapshot the runner must hand to the
        # application ((index, data) or None). Raft state does NOT advance
        # until commit_installed_snapshot — see on_install_snapshot.
        self.pending_snapshot: Optional[Tuple[int, bytes]] = None
        self._staged_install: Optional[InstallSnapshotRequest] = None
        self._staged_members: Optional[Dict[int, str]] = None
        self._staged_app_data: bytes = b""
        self.votes: Set[int] = set()
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}
        self._last_heartbeat_sent = 0.0
        # Last time a CURRENT leader contacted us (append/install with a
        # valid term); drives the §4.2.3 vote-disruption guard below.
        self._leader_contact = float("-inf")
        # peer -> time the last InstallSnapshot was dispatched (throttle).
        self._snapshot_sent_at: Dict[int, float] = {}
        # Leadership transfer in flight (thesis §3.10): while set, the
        # leader refuses new proposals, streams the target up to date, and
        # fires TimeoutNow once match catches the log head. Cleared on
        # step-down or deadline expiry.
        self.transfer_target: Optional[int] = None
        self._transfer_deadline = 0.0
        self._timeout_now_sent = False
        # Target side: while a transfer campaign is live, equal-term
        # appends from the abdicating leader must not demote the candidate
        # (the pre-vote mechanism keeps current_term at the OLD term until
        # the first grant, so the old leader's in-flight heartbeats would
        # otherwise cancel the sanctioned campaign). Appends from any
        # OTHER leader of an equal term are a different story — see
        # on_append_request — so the abdicator's id is remembered.
        self._transfer_campaign_deadline = float("-inf")
        self._transfer_abdicating_leader: Optional[int] = None

        # (peer_id, message) pairs for the runner to deliver.
        self.outbox: List[Tuple[int, object]] = []
        self.election_deadline = now + self._election_timeout()

        # Cluster membership (Raft §4, one server at a time). `base_members`
        # is the membership as of snapshot_index (persisted via
        # storage.save_members when membership entries compact out of the
        # log); the CURRENT membership is that base folded with every
        # membership entry in the retained log — recomputed whenever the log
        # gains/loses such entries. A durable base from a previous run wins
        # over the constructor's boot topology.
        stored = getattr(storage, "members", None)
        self.base_members: Dict[int, str] = (
            dict(stored) if stored is not None else boot_members
        )
        self.members: Dict[int, str] = {}
        self.removed = False  # self no longer in membership: stop electing
        self._refresh_membership()

    # ------------------------------------------------------------- helpers

    def _election_timeout(self) -> float:
        return self._rng.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _reset_election_timer(self, now: float) -> None:
        self.election_deadline = now + self._election_timeout()

    @property
    def last_log_index(self) -> int:
        return self.snapshot_index + len(self.log)

    @property
    def last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def entry_at(self, index: int) -> Entry:
        return self.log[index - self.snapshot_index - 1]

    def entry_term(self, index: int) -> int:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        return self.entry_at(index).term

    def quorum(self) -> int:
        return (len(self.peer_ids) + 1) // 2 + 1

    def _persist_meta(self) -> None:
        self.storage.save_meta(self.current_term, self.voted_for)

    # ---------------------------------------------------------- membership

    def _refresh_membership(self) -> None:
        """Recompute current membership = base folded with the retained
        log's membership entries. Called at boot and whenever the log
        gains or loses membership entries (append, truncate, compact,
        snapshot install) — truncation thereby ROLLS BACK an uncommitted
        change, per the takes-effect-on-append rule."""
        members = dict(self.base_members)
        for e in self.log:
            if is_membership(e.command):
                members = decode_membership(e.command)
        self.members = members
        self.peer_ids = [p for p in members if p != self.node_id]
        self.removed = self.node_id not in members
        if self.role is Role.LEADER:
            for p in self.peer_ids:
                self.next_index.setdefault(p, self.last_log_index + 1)
                self.match_index.setdefault(p, 0)
            for p in list(self.next_index):
                if p not in members:
                    self.next_index.pop(p, None)
                    self.match_index.pop(p, None)

    def _fold_base_members(self, upto_log_prefix: int) -> None:
        """Fold membership entries in log[:prefix] (about to be dropped by
        compaction) into the durable base."""
        changed = False
        for e in self.log[:upto_log_prefix]:
            if is_membership(e.command):
                self.base_members = decode_membership(e.command)
                changed = True
        if changed and hasattr(self.storage, "save_members"):
            self.storage.save_members(self.base_members)

    def propose_config(
        self, members: Dict[int, str], now: float
    ) -> int:
        """Leader-only: change membership by exactly one server (§4.1 —
        consecutive one-server configs share a quorum, so no joint
        consensus). The entry takes effect on this leader immediately;
        a further change is rejected until this one commits."""
        if self.role is not Role.LEADER:
            raise NotLeader(self.leader_id)
        if self.transfer_target is not None:
            raise TransferInFlight(self.transfer_target)
        # Safety precondition (Ongaro's 2015 single-server-change bug
        # note): the leader must have COMMITTED an entry of its own term
        # (the election no-op barrier) before appending a config change —
        # otherwise a config entry committed under the new quorum can be
        # overwritten by a resurrected older leader whose election quorum
        # was judged under the old config.
        if self.entry_term(self.commit_index) != self.current_term:
            raise ConfigChangeInFlight(
                self.commit_index,
                "the leader has not yet committed an entry of its term "
                "(election barrier in flight); retry shortly",
            )
        for i in range(
            max(self.commit_index, self.snapshot_index) + 1,
            self.last_log_index + 1,
        ):
            if is_membership(self.entry_at(i).command):
                raise ConfigChangeInFlight(i)
        members = {int(k): v for k, v in members.items()}
        diff = set(members) ^ set(self.members)
        if len(diff) != 1:
            raise ValueError(
                f"exactly one server may be added or removed per change "
                f"(got {sorted(diff)})"
            )
        if self.node_id not in members:
            raise ValueError(
                "the leader cannot remove itself; remove a follower, or "
                "stop this node and let the remainder elect first"
            )
        self.log.append(
            Entry(term=self.current_term, command=encode_membership(members))
        )
        self.storage.append_entries(self.last_log_index, self.log[-1:])
        self._refresh_membership()
        self._advance_commit()
        self.broadcast_append(now)
        return self.last_log_index

    # ---------------------------------------------------------- transitions

    def tick(self, now: float) -> None:
        """Advance timers: elections for followers/candidates, heartbeats
        for leaders."""
        if self.role is Role.LEADER:
            if (
                self.transfer_target is not None
                and now >= self._transfer_deadline
            ):
                # The target never took over (died, partitioned, lost the
                # election): abort and resume normal service (§3.10).
                self.transfer_target = None
                self._timeout_now_sent = False
            if now - self._last_heartbeat_sent >= self.config.heartbeat_interval:
                self.broadcast_append(now)
        elif now >= self.election_deadline:
            if self.recovering:
                # No campaigning from discarded state; wait for a leader.
                self._reset_election_timer(now)
            elif not self.removed:  # a removed server never disrupts the rest
                self.start_election(now)

    def start_election(self, now: float, transfer: bool = False) -> None:
        """Campaign with a PROPOSED term = current + 1 that is adopted
        (persisted, self-voted) only once a voter acknowledges it — the
        wire-compatible equivalent of pre-vote on the frozen RequestVote
        contract. A candidate whose requests are disregarded (the §4.2.3
        lease guard below: a removed server, a node campaigning before its
        AddServer lands, a partitioned node) therefore NEVER inflates its
        own term, so when the leader later contacts it their terms match
        and no step-down/re-election storm follows.

        `transfer` marks a leadership-transfer election (TimeoutNow): the
        vote requests carry the flag that bypasses voters' leader-lease
        guard, since this election is sanctioned by the current leader."""
        self.role = Role.CANDIDATE
        self._proposed_term = self.current_term + 1
        self.leader_id = None
        self.votes = {self.node_id}
        self._transfer_campaign_deadline = (
            now + self.config.election_timeout_min if transfer
            else float("-inf")
        )
        if not transfer:
            self._transfer_abdicating_leader = None
        self._reset_election_timer(now)
        req = VoteRequest(
            term=self._proposed_term,
            candidate_id=self.node_id,
            last_log_index=self.last_log_index,
            last_log_term=self.last_log_term,
            transfer=transfer,
        )
        for peer in self.peer_ids:
            self.outbox.append((peer, req))
        if not self.peer_ids:
            # Single-node cluster: nobody to acknowledge; adopt and win.
            if self._adopt_candidacy():
                self._maybe_win(now)

    def _adopt_candidacy(self) -> bool:
        """Persist the proposed term + self-vote; False if this term is
        already spoken for (we granted another candidate meanwhile)."""
        proposed = self._proposed_term
        if self.current_term > proposed:
            return False
        if self.current_term == proposed:
            if self.voted_for not in (None, self.node_id):
                return False
            if self.voted_for is None:
                self.voted_for = self.node_id
                self._persist_meta()
            return True
        self.current_term = proposed
        self.voted_for = self.node_id
        self._persist_meta()
        return True

    def _step_down(self, term: int, now: float) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_meta()
        self.role = Role.FOLLOWER
        self.votes = set()
        self.transfer_target = None
        self._timeout_now_sent = False
        self._reset_election_timer(now)

    # Vote handling -------------------------------------------------------

    def on_vote_request(self, req: VoteRequest, now: float) -> VoteResponse:
        # Disruption guard (Raft thesis §4.2.3): servers DISREGARD
        # RequestVotes while they believe a current leader exists — a
        # leader believes in itself, a follower within one minimum election
        # timeout of leader contact believes in that leader. Without this,
        # a REMOVED server (which never learns of its removal — the leader
        # stops replicating to it) times out and deposes the live leader
        # with ever-higher terms. Crucially the term is NOT adopted here;
        # a genuinely deposed leader still steps down via the higher term
        # on append/vote RESPONSES or a new leader's appends.
        # A transfer election is leader-sanctioned — the lease guard's
        # purpose (stopping disruptive elections) doesn't apply, and the
        # current leader itself must process it to be deposed promptly.
        if not req.transfer and (
            self.role is Role.LEADER
            or now - self._leader_contact < self.config.election_timeout_min
        ):
            return VoteResponse(term=self.current_term, granted=False)
        if self.recovering:
            # Our pre-crash vote (if any) is gone with the WAL; granting
            # here could be a second vote in the same term. Abstain until
            # healed — the rest of the cluster holds quorum without us.
            return VoteResponse(term=self.current_term, granted=False)
        if req.term > self.current_term:
            self._step_down(req.term, now)
        granted = False
        if req.term == self.current_term:
            up_to_date = (req.last_log_term, req.last_log_index) >= (
                self.last_log_term,
                self.last_log_index,
            )
            if self.voted_for in (None, req.candidate_id) and up_to_date:
                granted = True
                if self.voted_for is None:
                    self.voted_for = req.candidate_id
                    self._persist_meta()
                self._reset_election_timer(now)
        return VoteResponse(term=self.current_term, granted=granted)

    def on_vote_response(self, peer: int, resp: VoteResponse, now: float) -> None:
        proposed = self._proposed_term
        if resp.term > max(self.current_term, proposed):
            self._step_down(resp.term, now)
            return
        if self.role is not Role.CANDIDATE:
            return
        if resp.granted and resp.term == proposed:
            # First acknowledgment adopts the proposed term (see
            # start_election); a grant for a term we could not adopt —
            # we voted for a competitor meanwhile — is discarded.
            if not self._adopt_candidacy():
                return
            self.votes.add(peer)
            self._maybe_win(now)

    def _maybe_win(self, now: float) -> None:
        if self.role is Role.CANDIDATE and len(self.votes) >= self.quorum():
            self.role = Role.LEADER
            self.leader_id = self.node_id
            self.next_index = {p: self.last_log_index + 1 for p in self.peer_ids}
            self.match_index = {p: 0 for p in self.peer_ids}
            # No-op barrier: lets this term commit without waiting for client
            # traffic (and thereby commits all prior-term entries).
            self.log.append(Entry(term=self.current_term, command=NOOP))
            self.storage.append_entries(self.last_log_index, self.log[-1:])
            self._advance_commit()
            self.broadcast_append(now)

    # Append handling -----------------------------------------------------

    def append_request_for(
        self, peer: int, now: Optional[float] = None
    ) -> Optional[Union[AppendRequest, InstallSnapshotRequest]]:
        """Build the next AppendEntries for `peer` from its next_index — or
        an InstallSnapshot when the peer needs entries the log has compacted
        away (Raft §7: the snapshot replaces the missing prefix). Returns
        None when a snapshot to this peer is already in flight (payloads
        are unbounded; re-sending one per heartbeat would multiply the
        transfer dozens of times)."""
        nxt = self.next_index.get(peer, self.last_log_index + 1)
        if nxt <= self.snapshot_index:
            if self.snapshot_data is not None:
                sent = self._snapshot_sent_at.get(peer)
                if (
                    now is not None
                    and sent is not None
                    and now - sent < self.config.snapshot_resend_interval
                ):
                    return None
                if now is not None:
                    self._snapshot_sent_at[peer] = now
                return InstallSnapshotRequest(
                    term=self.current_term,
                    leader_id=self.node_id,
                    last_included_index=self.snapshot_index,
                    last_included_term=self.snapshot_term,
                    # base_members IS the membership at snapshot_index (all
                    # config entries <= it are folded in); envelope it so
                    # the receiver's config survives snapshot-covered
                    # membership changes (thesis §7: snapshots carry the
                    # latest configuration).
                    data=wrap_snapshot(self.base_members, self.snapshot_data),
                )
            # No snapshot bytes primed (shouldn't happen once the app calls
            # compact() at boot): send from the compaction boundary; the
            # peer will conflict until the app primes.
            nxt = self.snapshot_index + 1
        prev = nxt - 1
        off = prev - self.snapshot_index
        entries = tuple(
            self.log[off : off + self.config.max_entries_per_append]
        )
        return AppendRequest(
            term=self.current_term,
            leader_id=self.node_id,
            prev_log_index=prev,
            prev_log_term=self.entry_term(prev),
            entries=entries,
            leader_commit=self.commit_index,
        )

    def broadcast_append(self, now: float) -> None:
        self._last_heartbeat_sent = now
        for peer in self.peer_ids:
            if peer == self.transfer_target and self._timeout_now_sent:
                # The target is campaigning at our sanction; our own
                # heartbeats arriving at its (still equal) term would
                # demote it mid-campaign. Go quiet until the transfer
                # resolves (step-down here, or deadline abort).
                continue
            msg = self.append_request_for(peer, now)
            if msg is not None:
                self.outbox.append((peer, msg))

    def on_append_request(self, req: AppendRequest, now: float) -> AppendResponse:
        if req.term > self.current_term:
            self._step_down(req.term, now)
        if req.term < self.current_term:
            return AppendResponse(term=self.current_term, success=False)
        if (
            self.role is Role.CANDIDATE
            and now < self._transfer_campaign_deadline
            and req.leader_id == self._transfer_abdicating_leader
        ):
            # Transfer campaign in progress: the equal-term append is the
            # ABDICATING leader's in-flight traffic — don't let it cancel
            # the campaign it sanctioned. Reject without demoting; the old
            # leader steps down on seeing our proposed term, and if the
            # campaign fails the election timer recovers normally.
            # An equal-term append from any OTHER leader (one legitimately
            # elected for a term we adopted mid-campaign) falls through to
            # the step-down below: our campaign for that term is already
            # lost, and refusing its appends would only stall convergence
            # by up to an election timeout.
            return AppendResponse(
                term=self.current_term,
                success=False,
                conflict_index=self.last_log_index + 1,
            )
        # Valid leader for this term.
        if self.role is not Role.FOLLOWER:
            self._step_down(req.term, now)
        self.leader_id = req.leader_id
        self._leader_contact = now
        self._reset_election_timer(now)

        if req.prev_log_index > self.last_log_index:
            # Missing entries: tell the leader where our log ends.
            return AppendResponse(
                term=self.current_term,
                success=False,
                conflict_index=self.last_log_index + 1,
            )
        if req.prev_log_index < self.snapshot_index:
            # The request overlaps our snapshot-covered prefix (committed
            # state we can no longer term-check entry by entry). Redirect
            # the leader to resend from the compaction boundary.
            return AppendResponse(
                term=self.current_term,
                success=False,
                conflict_index=self.snapshot_index + 1,
            )
        if (
            req.prev_log_index > self.snapshot_index
            and self.entry_term(req.prev_log_index) != req.prev_log_term
        ):
            # Term conflict: find the first index of the conflicting term so
            # the leader can jump the whole term.
            bad_term = self.entry_term(req.prev_log_index)
            first = req.prev_log_index
            while (
                first > self.snapshot_index + 1
                and self.entry_term(first - 1) == bad_term
            ):
                first -= 1
            return AppendResponse(
                term=self.current_term, success=False, conflict_index=first
            )

        # Append / overwrite. Only truncate on a real mismatch (RPCs may be
        # stale or duplicated).
        index = req.prev_log_index
        membership_dirty = False
        for i, entry in enumerate(req.entries):
            index = req.prev_log_index + 1 + i
            if index <= self.last_log_index:
                if self.entry_term(index) != entry.term:
                    del self.log[index - self.snapshot_index - 1 :]
                    self.storage.truncate_from(index)
                    # Truncation may drop an uncommitted membership entry.
                    membership_dirty = True
                else:
                    continue
            self.log.append(entry)
            self.storage.append_entries(index, [entry])
            if is_membership(entry.command):
                membership_dirty = True
        if membership_dirty:
            self._refresh_membership()

        if req.leader_commit > self.commit_index:
            self.commit_index = min(req.leader_commit, self.last_log_index)
        if self.recovering and self._covers_current_term_commit(req):
            # Healed: the leader has committed an entry OF ITS OWN TERM at
            # req.leader_commit and our re-synced log holds it — by Leader
            # Completeness that point covers every previously committed
            # entry, so no acked write is missing from this replica. (A
            # bare `last_log_index >= leader_commit` is not enough: a
            # just-restarted leader's volatile commit_index can understate
            # the true commit point, and healing against that stale lower
            # bound would end vote abstention before we actually caught
            # up.) Normal election participation resumes.
            self.recovering = False
        return AppendResponse(
            term=self.current_term, success=True, match_index=index
        )

    def _covers_current_term_commit(self, req: AppendRequest) -> bool:
        """True when req.leader_commit names an entry of the leader's own
        term that our log (or our leader-installed snapshot base) holds —
        the earliest point recovery can soundly call itself complete. The
        election no-op barrier guarantees every leader commits in its own
        term promptly, so this resolves within a heartbeat or two."""
        lc = req.leader_commit
        if lc <= 0 or lc > self.last_log_index or lc < self.snapshot_index:
            return False
        return self.entry_term(lc) == req.term

    def on_append_response(
        self, peer: int, resp: AppendResponse, now: float
    ) -> None:
        if resp.term > self.current_term:
            self._step_down(resp.term, now)
            return
        if self.role is not Role.LEADER or resp.term != self.current_term:
            return
        # Same quiet rule as broadcast_append: once TimeoutNow has fired,
        # no more appends to the campaigning target — including the
        # immediate retries below, which would otherwise ping-pong against
        # its campaign-window rejections once per RTT.
        quiet = peer == self.transfer_target and self._timeout_now_sent
        if resp.success:
            if resp.match_index > self.match_index.get(peer, 0):
                self.match_index[peer] = resp.match_index
            self.next_index[peer] = self.match_index[peer] + 1
            self._advance_commit()
            self._maybe_fire_timeout_now(now)
            # Keep streaming if the peer is still behind — otherwise catch-up
            # would be paced at max_entries_per_append per heartbeat.
            if not quiet and self.next_index[peer] <= self.last_log_index:
                msg = self.append_request_for(peer, now)
                if msg is not None:
                    self.outbox.append((peer, msg))
        else:
            if resp.conflict_index > 0:
                self.next_index[peer] = max(1, resp.conflict_index)
            else:
                self.next_index[peer] = max(1, self.next_index.get(peer, 1) - 1)
            if quiet:
                return
            # Retry immediately with the corrected window.
            msg = self.append_request_for(peer, now)
            if msg is not None:
                self.outbox.append((peer, msg))

    def _advance_commit(self) -> None:
        """Majority-match advance, current-term entries only (Raft §5.4.2)."""
        for index in range(self.last_log_index, self.commit_index, -1):
            if self.entry_term(index) != self.current_term:
                break
            count = 1 + sum(
                1 for p in self.peer_ids if self.match_index.get(p, 0) >= index
            )
            if count >= self.quorum():
                self.commit_index = index
                break

    # Leadership transfer (thesis §3.10) ----------------------------------

    def transfer_leadership(
        self, now: float, target: Optional[int] = None
    ) -> int:
        """Leader-only: hand leadership to `target` (default: the most
        caught-up member). New proposals are refused while the transfer is
        in flight (so the target can actually catch the log head); once
        the target's match_index reaches our last index it receives
        TimeoutNow and campaigns immediately — its vote requests bypass
        the leader-lease guard, and this leader steps down on seeing the
        higher term. If nothing happens within an election timeout the
        transfer aborts and normal service resumes."""
        if self.role is not Role.LEADER:
            raise NotLeader(self.leader_id)
        if self.transfer_target is not None:
            # One transfer at a time: overwriting the target could fire a
            # second TimeoutNow and split the transfer vote between two
            # lease-bypassing candidates.
            raise TransferInFlight(self.transfer_target)
        # peer_ids IS the membership minus self (_refresh_membership).
        candidates = list(self.peer_ids)
        if not candidates:
            raise ValueError("no other member to transfer leadership to")
        if target is None:
            target = max(candidates, key=lambda p: self.match_index.get(p, 0))
        if target == self.node_id or target not in self.members:
            raise ValueError(f"target {target} is not another cluster member")
        self.transfer_target = target
        self._transfer_deadline = now + self.config.election_timeout_max
        self._timeout_now_sent = False
        self._maybe_fire_timeout_now(now)
        if not self._timeout_now_sent:
            self.broadcast_append(now)  # stream the target up to date
        return target

    def _maybe_fire_timeout_now(self, now: float) -> None:
        t = self.transfer_target
        if (
            t is None
            or self._timeout_now_sent
            or self.role is not Role.LEADER
            or self.match_index.get(t, 0) < self.last_log_index
        ):
            return
        self._timeout_now_sent = True
        self.outbox.append(
            (t, TimeoutNowRequest(term=self.current_term,
                                  leader_id=self.node_id))
        )

    def on_timeout_now(
        self, req: TimeoutNowRequest, now: float
    ) -> TimeoutNowResponse:
        """The leader chose this node as its successor: campaign NOW."""
        if req.term >= self.current_term and not self.removed:
            self.leader_id = None
            self.start_election(now, transfer=True)
            # Only THIS leader's in-flight appends may be rejected without
            # demoting us during the campaign window.
            self._transfer_abdicating_leader = req.leader_id
        return TimeoutNowResponse(term=self.current_term)

    def on_timeout_now_response(
        self, resp: TimeoutNowResponse, now: float
    ) -> None:
        if resp.term > self.current_term:
            self._step_down(resp.term, now)

    # Client-facing -------------------------------------------------------

    def propose(self, command: str, now: float) -> int:
        """Leader-only: append a command; returns its log index."""
        if self.role is not Role.LEADER:
            raise NotLeader(self.leader_id)
        if self.transfer_target is not None:
            raise TransferInFlight(self.transfer_target)
        self.log.append(Entry(term=self.current_term, command=command))
        self.storage.append_entries(self.last_log_index, self.log[-1:])
        self._advance_commit()  # single-node clusters commit instantly
        self.broadcast_append(now)
        return self.last_log_index

    def take_applies(self) -> List[Tuple[int, Entry]]:
        """Entries newly committed since the last call (for the app FSM).

        DETERMINISM CONTRACT: whatever the runner feeds these entries to
        (`RaftNode.apply_cb`, and transitively the whole `LMSState`
        applier surface) must be a pure function of (index, entry) over
        the prior state — no clock/RNG/env/process-identity reads, no
        unordered set iteration escaping into state, no blocking I/O or
        RPC awaited on the tick loop. Anything a replica should record
        that is not derivable from the entry (timestamps, tokens, salts,
        request ids) is minted leader-side BEFORE propose and rides in
        `Entry.command` (see lms/minting.py). Enforced statically by the
        `state-machine-determinism` lint rule and at runtime by the
        per-apply state-digest chain (`LMSNode._fold_digest`)."""
        out = []
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            out.append((self.last_applied, self.entry_at(self.last_applied)))
        return out

    # Snapshot / compaction ------------------------------------------------

    def compact(self, index: int, data: bytes) -> None:
        """Drop the log prefix <= `index`, now covered by the application
        snapshot `data`. Called by the app after persisting its own state
        snapshot at `index`; also primes the InstallSnapshot payload for
        lagging peers. Never compacts past what this node has applied."""
        if index > self.last_applied:
            raise ValueError(
                f"cannot compact to {index}: only applied {self.last_applied}"
            )
        if index <= self.snapshot_index:
            if index == self.snapshot_index:
                self.snapshot_data = data  # re-prime after restart
            return
        term = self.entry_term(index)
        # Membership entries leaving the log fold into the durable base.
        self._fold_base_members(index - self.snapshot_index)
        del self.log[: index - self.snapshot_index]
        self.snapshot_index = index
        self.snapshot_term = term
        self.snapshot_data = data
        self.storage.compact_to(index, term)

    def on_install_snapshot(
        self, req: InstallSnapshotRequest, now: float
    ) -> InstallSnapshotResponse:
        if req.term > self.current_term:
            self._step_down(req.term, now)
        if req.term < self.current_term:
            return InstallSnapshotResponse(term=self.current_term, success=False)
        if self.role is not Role.FOLLOWER:
            self._step_down(req.term, now)
        self.leader_id = req.leader_id
        self._leader_contact = now
        self._reset_election_timer(now)

        if req.last_included_index <= self.last_applied:
            # Already at/past this point; nothing to install.
            return InstallSnapshotResponse(term=self.current_term, success=True)

        # Stage only: raft state must not move until the application has
        # durably installed the snapshot. If the install callback fails, the
        # runner aborts the staging and answers success=False, and because
        # last_applied never advanced the leader's retry re-attempts the
        # install instead of being absorbed by the early-return above and
        # streaming entries past a hole the app never filled.
        members, app_data = unwrap_snapshot(req.data)
        self._staged_install = req
        self._staged_members = members
        self._staged_app_data = app_data
        self.pending_snapshot = (req.last_included_index, app_data)
        return InstallSnapshotResponse(term=self.current_term, success=True)

    def commit_installed_snapshot(self) -> None:
        """Advance raft state + durable WAL to the staged snapshot.

        Called by the runner AFTER the application persisted its state
        snapshot (durable ordering: a crash between the two leaves the app
        snapshot ahead of the WAL base, which boot replays past; compacting
        the WAL first would leave a base ahead of the app, which the boot
        check rejects as unrecoverable)."""
        req = self._staged_install
        if req is None:
            return
        self._staged_install = None
        if (
            req.last_included_index <= self.last_log_index
            and self.entry_term(req.last_included_index)
            == req.last_included_term
        ):
            # Our log extends past the snapshot and agrees at its boundary:
            # keep the suffix (Raft §7), just move the base forward.
            del self.log[: req.last_included_index - self.snapshot_index]
        else:
            self.log = []
        # The snapshot's enveloped membership (wrap_snapshot) IS the config
        # at its boundary — adopting it covers membership entries the
        # sender compacted away, and the retained suffix's entries refold
        # on top in _refresh_membership. Legacy un-enveloped payloads keep
        # the current folded view as an approximation.
        self.base_members = (
            dict(self._staged_members)
            if self._staged_members is not None
            else dict(self.members)
        )
        if hasattr(self.storage, "save_members"):
            self.storage.save_members(self.base_members)
        self.snapshot_index = req.last_included_index
        self.snapshot_term = req.last_included_term
        self.snapshot_data = self._staged_app_data
        self.commit_index = max(self.commit_index, req.last_included_index)
        self.last_applied = req.last_included_index
        self.storage.install_snapshot(
            self.snapshot_index, self.snapshot_term, self.log
        )
        self._refresh_membership()

    def abort_installed_snapshot(self) -> None:
        """Drop a staged snapshot whose application install failed."""
        self._staged_install = None

    def on_install_snapshot_response(
        self,
        peer: int,
        sent: InstallSnapshotRequest,
        resp: InstallSnapshotResponse,
        now: float,
    ) -> None:
        if resp.term > self.current_term:
            self._step_down(resp.term, now)
            return
        if self.role is not Role.LEADER or resp.term != self.current_term:
            return
        if resp.success:
            if sent.last_included_index > self.match_index.get(peer, 0):
                self.match_index[peer] = sent.last_included_index
            self.next_index[peer] = self.match_index[peer] + 1
            self._advance_commit()
            if self.next_index[peer] <= self.last_log_index:
                msg = self.append_request_for(peer, now)
                if msg is not None:
                    self.outbox.append((peer, msg))

    def drain_outbox(self) -> List[Tuple[int, object]]:
        out, self.outbox = self.outbox, []
        return out


class NotLeader(Exception):
    def __init__(self, leader_id: Optional[int]):
        super().__init__(f"not the leader (known leader: {leader_id})")
        self.leader_id = leader_id


class TransferInFlight(Exception):
    """Raised for proposals while a leadership transfer is in progress —
    retryable: the transfer either completes (retry reaches the new
    leader via NotLeader redirect) or aborts within an election timeout."""

    def __init__(self, target: int):
        super().__init__(
            f"leadership transfer to node {target} in progress; retry"
        )
        self.target = target


class ConfigChangeInFlight(Exception):
    def __init__(self, index: int, reason: Optional[str] = None):
        super().__init__(
            reason
            or f"a membership change at index {index} is not yet "
               f"committed; one change at a time"
        )
        self.index = index
