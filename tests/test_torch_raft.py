"""The port's Raft against the JAX package's, step for step, and the JAX
package's Raft tests carried onto the port.

Lockstep: five JAX `RaftCore`s and five port cores, on the same ids and
seeds (`random.Random(node_id)`), are driven through one schedule of
ticks, deliveries, drops, partitions, proposals, compactions, leadership
transfers and membership changes. After every step each core's
`drain_outbox()` must be equal as dataclass dicts, and so must roles,
terms, votes, logs, commit and apply indexes and memberships (exact
equality: the cores are integer state machines). One scripted schedule
covers every kind of step; a `hypothesis` strategy draws others.

Carried: `tests/test_raft_core.py`, `test_raft_cluster.py`,
`test_raft_compaction.py`, `test_raft_transfer.py`,
`test_raft_membership.py` and `test_raft_grpc.py`, run against the port's
modules (`torch_carry.py`), under the names `test_port_<file>_<case>`.
"""

import dataclasses

import torch_threads  # noqa: F401 (caps torch's threads)
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch_carry import carry, carried_cases

from distributed_lms_raft_llm_tpu import raft as jax_raft
from distributed_lms_raft_llm_tpu.raft import messages as jax_messages
from distributed_lms_raft_llm_tpu_torch import raft as port_raft
from distributed_lms_raft_llm_tpu_torch.raft import messages as port_messages

_CARRIED = {
    "raft_core": carry("test_raft_core"),
    "raft_cluster": carry("test_raft_cluster"),
    "raft_compaction": carry("test_raft_compaction"),
    "raft_transfer": carry("test_raft_transfer",
                           helpers=("test_raft_cluster",)),
    "raft_membership": carry("test_raft_membership",
                             helpers=("test_raft_cluster",)),
    "raft_grpc": carry("test_raft_grpc"),
}
for _name, _module in _CARRIED.items():
    globals().update(carried_cases(_module, f"port_{_name}"))

IDS = (1, 2, 3, 4, 5)
FAST = dict(election_timeout_min=0.11, election_timeout_max=0.22,
            heartbeat_interval=0.05)


class Cluster:
    """Five sans-IO cores of one package, a clock, and the messages in
    flight; each step is applied the same way to either package."""

    def __init__(self, raft, messages):
        self.raft, self.m = raft, messages
        self.now = 0.0
        self.cores = {
            i: raft.RaftCore(i, list(IDS), raft.MemoryStorage(),
                             raft.RaftConfig(**FAST), now=0.0)
            for i in IDS}
        self.pending = []  # (src, dst, message)
        self.cut = set()   # ids on the minority side of a partition
        self.applied = {i: [] for i in IDS}
        self.outcome = None

    def _reachable(self, a, b):
        return (a in self.cut) == (b in self.cut)

    def _deliver(self, src, dst, msg):
        m, now = self.m, self.now
        core, sender = self.cores[dst], self.cores[src]
        if isinstance(msg, m.VoteRequest):
            sender.on_vote_response(dst, core.on_vote_request(msg, now), now)
        elif isinstance(msg, m.AppendRequest):
            sender.on_append_response(dst, core.on_append_request(msg, now),
                                      now)
        elif isinstance(msg, m.InstallSnapshotRequest):
            resp = core.on_install_snapshot(msg, now)
            if core.pending_snapshot is not None:
                core.pending_snapshot = None
                core.commit_installed_snapshot()
            sender.on_install_snapshot_response(dst, msg, resp, now)
        elif isinstance(msg, m.TimeoutNowRequest):
            sender.on_timeout_now_response(core.on_timeout_now(msg, now),
                                           now)

    def _leader(self):
        leaders = [c for c in self.cores.values()
                   if c.role is self.raft.Role.LEADER]
        return max(leaders, key=lambda c: c.current_term) if leaders else None

    def step(self, op):
        """Apply one step; returns the outboxes drained after it."""
        kind = op[0]
        self.outcome = None
        if kind == "advance":
            self.now = round(self.now + op[1], 6)
            for i in IDS:
                self.cores[i].tick(self.now)
        elif kind in ("deliver", "drop") and self.pending:
            src, dst, msg = self.pending.pop(op[1] % len(self.pending))
            if kind == "deliver" and self._reachable(src, dst):
                self._deliver(src, dst, msg)
        elif kind == "partition":
            self.cut = set(op[1])
        elif kind == "heal":
            self.cut = set()
        elif kind in ("propose", "transfer", "config", "compact"):
            leader = self._leader()
            try:
                if leader is None:
                    self.outcome = "no leader"
                elif kind == "propose":
                    self.outcome = leader.propose(
                        self.m.encode_command("SetVal", {"key": "k",
                                                         "value": op[1]}),
                        self.now)
                elif kind == "transfer":
                    self.outcome = leader.transfer_leadership(self.now, None)
                elif kind == "config":
                    members = dict(leader.members)
                    if op[1] in members:
                        members.pop(op[1])
                    else:
                        members[op[1]] = f"127.0.0.1:{50050 + op[1]}"
                    self.outcome = leader.propose_config(members, self.now)
                else:
                    for core in self.cores.values():
                        index = core.last_applied
                        core.compact(index, f"state@{index}".encode())
            except (self.raft.NotLeader, self.raft.TransferInFlight,
                    self.raft.ConfigChangeInFlight, ValueError) as e:
                self.outcome = (type(e).__name__, str(e))
        for i in IDS:
            for index, entry in self.cores[i].take_applies():
                self.applied[i].append((index, entry.term, entry.command))
        drained = []
        for i in IDS:
            for dst, msg in self.cores[i].drain_outbox():
                self.pending.append((i, dst, msg))
                drained.append((i, dst, type(msg).__name__,
                                dataclasses.asdict(msg)))
        return drained

    def view(self):
        return {
            i: dict(role=c.role.value, term=c.current_term,
                    voted_for=c.voted_for, leader=c.leader_id,
                    log=[(e.term, e.command) for e in c.log],
                    snapshot=(c.snapshot_index, c.snapshot_term),
                    commit=c.commit_index, applied=c.last_applied,
                    members=dict(c.members), removed=c.removed,
                    transfer=c.transfer_target,
                    apply_log=list(self.applied[i]))
            for i, c in self.cores.items()}


def run_lockstep(schedule):
    ref = Cluster(jax_raft, jax_messages)
    port = Cluster(port_raft, port_messages)
    for n, op in enumerate(schedule):
        assert port.step(op) == ref.step(op), (n, op)
        assert port.outcome == ref.outcome, (n, op)
        assert port.view() == ref.view(), (n, op)
    return ref, port


def _settle(rounds, dt=0.03):
    """Advance the clock and deliver everything in flight, `rounds` times."""
    ops = []
    for _ in range(rounds):
        ops.append(("advance", dt))
        ops.extend([("deliver", 0)] * 30)
    return ops


def scripted_schedule():
    ops = [("advance", 0.25)] + _settle(8)
    ops += [("propose", f"v{i}") for i in range(4)] + _settle(4)
    # Drops and a minority partition: the cut side cannot commit.
    ops += [("propose", "lost?"), ("drop", 0), ("drop", 3)] + _settle(2)
    ops += [("partition", (4, 5)), ("propose", "p1")] + _settle(10, 0.06)
    ops += [("heal",)] + _settle(8, 0.06)
    # Compaction on every node, then a lagging node needs a snapshot.
    ops += [("compact",), ("partition", (3,))]
    ops += [("propose", f"w{i}") for i in range(3)] + _settle(4)
    ops += [("compact",), ("heal",)] + _settle(10, 0.06)
    # A leadership transfer, then a membership change each way.
    ops += [("transfer",)] + _settle(10)
    ops += [("config", 5)] + _settle(6)
    ops += [("config", 5)] + _settle(8, 0.06)
    # The leader refuses to remove itself; then a follower leaves.
    ops += [("propose", "after"), ("config", 2)] + _settle(6)
    ops += [("config", 3)] + _settle(6)
    return ops


def test_lockstep_scripted_schedule_matches_jax():
    ref, port = run_lockstep(scripted_schedule())
    view = port.view()
    # The schedule really exercised what it names: elections, commits,
    # compaction and a snapshot install, a transfer, membership changes.
    assert any(v["role"] == "leader" for v in view.values())
    assert max(v["commit"] for v in view.values()) >= 10
    assert min(v["snapshot"][0] for v in view.values()) > 0
    assert max(v["term"] for v in view.values()) >= 2
    leader = next(v for v in view.values() if v["role"] == "leader")
    assert sorted(leader["members"]) == [1, 2, 4, 5]
    assert port.outcome == ref.outcome


_OPS = st.one_of(
    st.tuples(st.just("advance"), st.sampled_from([0.01, 0.05, 0.12, 0.3])),
    st.tuples(st.just("deliver"), st.integers(0, 40)),
    st.tuples(st.just("drop"), st.integers(0, 40)),
    st.tuples(st.just("partition"),
              st.sets(st.sampled_from(IDS), min_size=1, max_size=2)
              .map(lambda s: tuple(sorted(s)))),
    st.tuples(st.just("heal")),
    st.tuples(st.just("propose"), st.text("abc", min_size=1, max_size=3)),
    st.tuples(st.just("compact")),
    st.tuples(st.just("transfer")),
    st.tuples(st.just("config"), st.sampled_from(IDS)),
)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_OPS, min_size=10, max_size=80))
def test_lockstep_random_schedules_match_jax(schedule):
    run_lockstep([("advance", 0.25)] + schedule)


def test_codecs_and_snapshot_envelope_match_jax():
    members = {1: "127.0.0.1:50051", 3: "10.0.0.3:50053"}
    for m in (jax_messages, port_messages):
        assert m.decode_command(m.encode_command("Post", {"a": [1, "x"]})) \
            == ("Post", {"a": [1, "x"]})
    assert port_messages.encode_command("SetVal", {"key": "é"}) \
        == jax_messages.encode_command("SetVal", {"key": "é"})
    assert port_messages.encode_membership(members) \
        == jax_messages.encode_membership(members)
    wrapped = jax_messages.wrap_snapshot(members, b"\x00state")
    assert port_messages.wrap_snapshot(members, b"\x00state") == wrapped
    assert port_messages.unwrap_snapshot(wrapped) \
        == jax_messages.unwrap_snapshot(wrapped)
    assert port_messages.unwrap_snapshot(b"legacy") \
        == jax_messages.unwrap_snapshot(b"legacy")
    assert port_messages.is_membership(
        jax_messages.encode_membership(members))


def test_transport_caps_the_reconnect_backoff(monkeypatch):
    """The port's Raft transport dials each peer with gRPC's reconnect
    backoff capped at 1 s (the reference keeps gRPC's defaults, which grow
    to 120 s: a follower back after ~10 s down then waited up to ~7 s more
    to be dialed again). A recorded difference, ROADMAP.md §3."""
    import grpc

    from distributed_lms_raft_llm_tpu.raft import grpc_transport as jax_gt
    from distributed_lms_raft_llm_tpu_torch.raft import grpc_transport

    dialed = []

    def capture(address, options=None):
        dialed.append((address, dict(options or ())))
        return object()

    monkeypatch.setattr(grpc.aio, "insecure_channel", capture)
    monkeypatch.setattr(grpc_transport.rpc, "RaftServiceStub", lambda ch: ch)
    monkeypatch.setattr(jax_gt.rpc, "RaftServiceStub", lambda ch: ch)
    grpc_transport.GrpcTransport({2: "127.0.0.1:1"})._stub(2)
    jax_gt.GrpcTransport({2: "127.0.0.1:1"})._stub(2)
    (port_address, port_options), (_, jax_options) = dialed
    assert port_address == "127.0.0.1:1"
    assert port_options["grpc.max_reconnect_backoff_ms"] == 1000
    assert port_options["grpc.initial_reconnect_backoff_ms"] == 100
    assert jax_options == {}
