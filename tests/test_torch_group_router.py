"""The port's sharded LMS control plane (`lms/group_router.py`) against the
JAX package's.

- Carried (`torch_carry.py`): `tests/test_group_router.py` on the port's
  `lms`, `client`, `utils`, `proto` and `raft`, as
  `test_port_group_router_<case>`, but for one case left out by name:
  `test_groups_config_validates` asserts `SimConfig(lms_groups=0)`
  raises, and the port has no `SimConfig` (its `config.py` checks the
  `[sim]` keys only; `sim/` is not ported). The port's `GroupsConfig`
  validation is `test_groups_config_validates_as_jax` here.
- Pure functions, byte for byte: `stable_hash`, `sign_router_metadata`
  and `RoutingMap.initial` / `group_for` / `to_json` / `from_json` on the
  same inputs.
- Two in-process two-group clusters, one of each package (three members,
  `torch_lms_harness.GroupedCluster`), driven through one RPC script of
  students homed in both groups and an instructor: every reply equal, and
  every group's replicas converged to the same state digest in both
  packages. Minting (salts, session tokens, request ids) is made
  deterministic in both packages for the run, so the states are equal
  byte for byte.
- A mixed grouped cluster (port, JAX, port members): group 0 led by the
  JAX member, group 1 by a port member; raw stubs enter a port router for
  a group-0 user (port -> JAX forward) and the JAX router for a group-1
  user (JAX -> port), and the groups converge to equal digests across the
  two kinds of member.

All comparisons are exact.
"""

import itertools
import types

import grpc
import pytest
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_carry import carry, carried_cases
from torch_lms_harness import GroupedCluster

from distributed_lms_raft_llm_tpu import config as jax_config
from distributed_lms_raft_llm_tpu.lms import group_router as jax_router
from distributed_lms_raft_llm_tpu_torch import config as port_config
from distributed_lms_raft_llm_tpu_torch.lms import group_router as port_router
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
from distributed_lms_raft_llm_tpu_torch.utils import pdf

# `config` stays the JAX package's in the carried module: its one
# `SimConfig` case is not carried (see the docstring).
globals().update(carried_cases(
    carry("test_group_router",
          modules=("lms", "client", "utils", "proto", "raft")),
    "port_group_router", skip=("test_groups_config_validates",)))

NAMES = ["alice", "bob", "carol", "dave", "erin", "frank", "ana", "s0",
         "", "ü-ñ", "course:cs451/student-12", "x" * 200]


def test_stable_hash_equals_jax():
    for name in NAMES:
        assert port_router.stable_hash(name) == jax_router.stable_hash(name)


@pytest.mark.parametrize("secret", ["", "s3cret", "ключ"])
def test_sign_router_metadata_equals_jax(secret):
    pairs_list = [
        [],
        [("x-lms-group", "1")],
        [("x-lms-auth-salt", "ab12"), ("x-lms-group", "0"),
         ("x-lms-hops", "1")],
        [("x-lms-hops", "2"), ("x-lms-auth-token", "t" * 32)],
    ]
    for pairs in pairs_list:
        assert port_router.sign_router_metadata(secret, pairs) \
            == jax_router.sign_router_metadata(secret, pairs)
        # Order on the wire does not change the signature, in either.
        assert port_router.sign_router_metadata(secret, pairs[::-1]) \
            == jax_router.sign_router_metadata(secret, pairs)


@pytest.mark.parametrize("n_groups", [1, 2, 3, 5])
def test_routing_map_json_and_placement_equal_jax(n_groups):
    courses = ["cs451", "cs201", "ma101", "ph210", "cs999"]
    port = port_router.RoutingMap.initial(n_groups, courses)
    ref = jax_router.RoutingMap.initial(n_groups, courses)
    assert port.to_json() == ref.to_json()
    port.overrides = {"alice": n_groups - 1, "bob": 99}
    ref.overrides = {"alice": n_groups - 1, "bob": 99}
    port.version = ref.version = 7
    raw = ref.to_json()
    assert port.to_json() == raw
    assert port_router.RoutingMap.from_json(raw).to_json() == raw
    assert jax_router.RoutingMap.from_json(port.to_json()).to_json() == raw
    course_of = {n: courses[i % len(courses)]
                 for i, n in enumerate(NAMES)}.get
    for name in NAMES:
        assert port.group_for(name) == ref.group_for(name)
        assert port.group_for(name, course_of) \
            == ref.group_for(name, course_of)
    defaults = '{"n_groups": 3}'
    assert port_router.RoutingMap.from_json(defaults).to_json() \
        == jax_router.RoutingMap.from_json(defaults).to_json()


def test_groups_config_validates_as_jax():
    """The port's [groups] takes count > 1 and a secret, and refuses what
    the JAX package's refuses, with the same messages."""
    for kw in ({}, {"count": 2}, {"count": 4, "port_stride": 7,
                                  "secret": "k"}):
        assert vars(port_config.GroupsConfig(**kw)) \
            == vars(jax_config.GroupsConfig(**kw))
    for kw in ({"count": 0}, {"count": -1}, {"port_stride": 0}):
        with pytest.raises(ValueError) as want:
            jax_config.GroupsConfig(**kw)
        with pytest.raises(ValueError) as got:
            port_config.GroupsConfig(**kw)
        assert str(got.value) == str(want.value)


def homed(n_groups=2, per_group=1, prefix="stu"):
    """Usernames whose home group under `RoutingMap.initial(n_groups)` is
    each group in turn, `per_group` of each."""
    out = {g: [] for g in range(n_groups)}
    for i in itertools.count():
        name = f"{prefix}{i}"
        g = port_router.stable_hash(name) % n_groups
        if len(out[g]) < per_group:
            out[g].append(name)
        if all(len(v) == per_group for v in out.values()):
            return out


def _deterministic_minting(monkeypatch):
    """Salts, session tokens and request ids from one counter, in both
    packages' minting modules and clients: the runs mint the same values
    in the same order."""
    from distributed_lms_raft_llm_tpu.client import client as jax_client
    from distributed_lms_raft_llm_tpu.lms import minting as jax_minting
    from distributed_lms_raft_llm_tpu_torch.client import client as p_client
    from distributed_lms_raft_llm_tpu_torch.lms import minting as p_minting

    counter = itertools.count(1)
    fake_uuid = types.SimpleNamespace(uuid4=lambda: types.SimpleNamespace(
        hex=f"{next(counter):032x}"))
    fake_os = types.SimpleNamespace(
        urandom=lambda n: next(counter).to_bytes(n, "big"))
    for mod in (jax_minting, p_minting):
        monkeypatch.setattr(mod, "uuid", fake_uuid)
        monkeypatch.setattr(mod, "os", fake_os)
    for mod in (jax_client, p_client):
        monkeypatch.setattr(mod, "uuid", fake_uuid)


def _script(client_factory, users, instructor="prof"):
    """One RPC script through a package's client: register and log in a
    student homed in each group and an instructor, post, ask, read back
    across groups, grade and respond. Returns every reply, tokens
    included (minting is deterministic)."""
    out = []
    client = client_factory()
    try:
        for name in users + [instructor]:
            role = "instructor" if name == instructor else "student"
            r = client.register(name, "pw", role)
            out.append(("register", name, r.success, r.message))
        out.append(("register-again", client.register(
            users[0], "pw", "student").message))
        assert client.login(instructor, "pw")
        out.append(("login", instructor, client.token, client.role))
        out.append(("material", client.upload_course_material(
            "l1.pdf", pdf.make_pdf("Lecture 1: B-trees"))))
        assert client.logout()
        for name in users:
            assert client.login(name, "pw")
            out.append(("login", name, client.token, client.role))
            out.append(("post", name, client.upload_assignment(
                f"{name}.pdf", pdf.make_pdf(f"{name}'s homework: splits"))))
            out.append(("ask", name, client.ask_instructor(
                f"{name}: when is it due?")))
            out.append(("materials", name, [
                (e.filename, e.instructor) for e in
                client.course_materials()]))
            assert client.logout()
        assert client.login(instructor, "pw")
        out.append(("assignments", sorted(
            (e.id, e.filename, bytes(e.file)) for e in
            client.student_assignments())))
        out.append(("unanswered", sorted(
            (e.id, e.data) for e in client.unanswered_queries())))
        for name in users:
            r = client.grade(name, "A-")
            out.append(("grade", name, r.success, r.message))
            out.append(("respond", name, client.respond_to_query(
                name, f"{name}: next Friday")))
        out.append(("unanswered-after", sorted(
            (e.id, e.data) for e in client.unanswered_queries())))
        assert client.logout()
        for name in users:
            assert client.login(name, "pw")
            out.append(("my-grade", name, client.my_grade()))
            out.append(("responses", name, [
                e.data for e in client.instructor_responses()]))
            assert client.logout()
        out.append(("bad-login", client.login(users[0], "wrong")))
    finally:
        client.close()
    return out


def _run(kind, tmp_path, users):
    cluster = GroupedCluster([kind] * 3, tmp_path / kind).start()
    try:
        # Group 1 led by another member than group 0: the script's
        # group-1 work crosses between routers.
        lead0 = cluster.leader(0).nid
        cluster.transfer_to(1, lead0 % 3 + 1)
        replies = _script(lambda: cluster.client(kind), users)
        states = {gid: cluster.converged(gid) for gid in (0, 1)}
        forwards = sum(m.metrics.snapshot()["counters"].get(
            "router_group_forwards", 0) for m in cluster.members.values())
    finally:
        cluster.close()
    return replies, states, forwards


def test_two_group_clusters_reply_and_converge_as_jax(tmp_path,
                                                      monkeypatch):
    _deterministic_minting(monkeypatch)
    users = [u for us in homed(2, 2).values() for u in us]
    results = {}
    for kind in ("jax", "port"):
        _deterministic_minting(monkeypatch)  # the same counter run
        results[kind] = _run(kind, tmp_path, users)
    (jax_replies, jax_states, jax_forwards), (
        port_replies, port_states, forwards) = results["jax"], results["port"]
    assert port_replies == jax_replies
    for gid in (0, 1):
        assert port_states[gid][0] == jax_states[gid][0]
        assert port_states[gid][1] == jax_states[gid][1]
    # Each group holds its own students' data, and both hold every user.
    for gid, names in homed(2, 2).items():
        data = port_states[gid][1]
        assert set(data["assignments"]) == set(names)
        assert set(data["users"]) == set(users) | {"prof"}
    # The script crossed groups through the routers, in both packages.
    assert forwards > 0 and jax_forwards > 0
    # The instructor's fan-out read saw both groups' assignments.
    assignments = dict((r[0], r[1]) for r in port_replies
                       if r[0] == "assignments")["assignments"]
    assert sorted(a[0] for a in assignments) == sorted(users)


def _stub_call(address, method, request, md=()):
    with grpc.insecure_channel(address) as ch:
        return getattr(rpc.LMSStub(ch), method)(request, timeout=10,
                                                metadata=list(md))


def test_mixed_routers_forward_port_to_jax_and_back(tmp_path):
    cluster = GroupedCluster(["port", "jax", "port"], tmp_path).start()
    try:
        cluster.transfer_to(0, 2)   # the JAX member leads group 0
        cluster.transfer_to(1, 1)   # a port member leads group 1
        (g0,), (g1,) = homed(2, 1, prefix="mix").values()
        port_entry, jax_entry = cluster.addresses[3], cluster.addresses[2]
        # Register and Login fan out to both groups: entered at a port
        # router, group 0's leg goes to the JAX member; entered at the JAX
        # router, group 1's leg goes to a port member.
        for name, entry in ((g0, port_entry), (g1, jax_entry)):
            r = _stub_call(entry, "Register", lms_pb2.RegisterRequest(
                username=name, password="pw", role="student"))
            assert r.success, r.message
        tokens = {}
        for name, entry in ((g0, port_entry), (g1, jax_entry)):
            r = _stub_call(entry, "Login", lms_pb2.LoginRequest(
                username=name, password="pw"))
            assert r.success, r.message
            tokens[name] = r.token
        # Home-group writes: a group-0 post through a port router (port
        # -> JAX), a group-1 post through the JAX router (JAX -> port).
        for name, entry in ((g0, port_entry), (g1, jax_entry)):
            r = _stub_call(entry, "Post", lms_pb2.PostRequest(
                token=tokens[name], type="assignment",
                filename=f"{name}.pdf", file=pdf.make_pdf(name)),
                md=[("x-lms-user", name)])
            assert r.success, r.message
        states = {gid: cluster.converged(gid) for gid in (0, 1)}
        forwards = {nid: m.metrics.snapshot()["counters"].get(
            "router_group_forwards", 0)
            for nid, m in cluster.members.items()}
        kinds = {nid: m.pkg.name for nid, m in cluster.members.items()}
        digests = {gid: {m.nodes[gid].state.digest()
                         for m in cluster.members.values()}
                   for gid in (0, 1)}
    finally:
        cluster.close()
    assert kinds == {1: "port", 2: "jax", 3: "port"}
    assert forwards[3] > 0 and forwards[2] > 0
    for gid, name in ((0, g0), (1, g1)):
        assert len(digests[gid]) == 1  # port and JAX replicas agree
        assert list(states[gid][1]["assignments"]) == [name]
        assert set(states[gid][1]["users"]) == {g0, g1}
