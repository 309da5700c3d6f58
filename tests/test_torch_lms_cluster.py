"""The port's LMS nodes as a Raft cluster, alone and beside JAX nodes, and
its tutoring fleet router against the JAX package's.

- Cluster: three port `LMSNode`s over gRPC elect, commit a student's
  journey through the port's `LMSClient`, and survive a leader kill: the
  session stays valid, a write acknowledged after the kill is read back
  from all three once the killed node restarts on its data directory.
- Mixed cluster: port and JAX nodes in ONE Raft group (one wire), with the
  leader moved to either side, end with equal states and digests.
- Pool: `affinity_key` / `session_affinity_key` and the rendezvous
  placement (`route_snapshot`) equal the JAX `TutoringPool`'s for the
  same fleet, query by query.
- Two groups from the deployment file: three port LMS processes
  (`serving/lms_cluster.py`, `--device cpu`, no gate) from a copy of
  configs/cluster.toml with `[groups] count = 2`, a probed stride and a
  secret: both groups elect a leader, `GET /admin/raft` on every node
  lists both with the same members, `POST /admin/reshard` answers 400
  with the reference's words, and a student homed in each group posts
  through the routers and reads back.

All comparisons are exact.

Carried (`torch_carry.py`), as `test_port_<file>_<case>`:
`tests/test_linearizable_reads.py` (fenced reads),
`test_client_leader_hint.py`, `test_lms_cluster.py` (its JAX tutoring
node and gate in front of port LMS nodes and the port's client) and
`test_tutoring_pool.py` (the port's pool in front of JAX tutoring nodes:
breakers, spill, hedging, drains).
"""

from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_carry import carry, carried_cases
from torch_lms_harness import Cluster

from distributed_lms_raft_llm_tpu.lms import tutoring_pool as jax_pool
from distributed_lms_raft_llm_tpu_torch.lms import tutoring_pool as port_pool
from distributed_lms_raft_llm_tpu_torch.utils import pdf

# The port's host modules; the JAX package's engine, tutoring server and
# sim stand-ins stay the JAX package's in the carried cluster/pool tests.
_HOST = ("lms", "raft", "client", "proto", "utils.pdf", "utils.faults",
         "utils.resilience")
globals().update(carried_cases(
    carry("test_linearizable_reads", helpers=("test_raft_cluster",)),
    "port_linearizable_reads"))
globals().update(carried_cases(carry("test_client_leader_hint"),
                               "port_client_leader_hint"))
globals().update(carried_cases(carry("test_lms_cluster", modules=_HOST),
                               "port_lms_cluster"))
globals().update(carried_cases(
    carry("test_tutoring_pool", modules=("lms", "utils.faults",
                                         "utils.resilience")),
    "port_tutoring_pool"))

REPO = Path(__file__).resolve().parent.parent
HOMEWORK = "Homework 2: implement a B-tree with insert and split"


def _journey(client):
    assert client.register("ana", "pw1", "student").success
    assert client.register("prof", "pw2", "instructor").success
    assert client.login("prof", "pw2")
    assert client.upload_course_material(
        "l4.pdf", pdf.make_pdf("Lecture 4: B-trees"))
    client.logout()
    assert client.login("ana", "pw1")
    assert client.upload_assignment("hw2.pdf", pdf.make_pdf(HOMEWORK))
    assert client.ask_instructor("When is hw2 due?")


@pytest.fixture
def port_cluster(tmp_path):
    cluster = Cluster(["port"] * 3, tmp_path).start()
    yield cluster
    cluster.close()


def test_port_cluster_survives_a_leader_kill(port_cluster):
    cluster = port_cluster
    client = cluster.client()
    try:
        _journey(client)
        token = client.token
        killed = cluster.leader().nid
        cluster.kill(killed)
        assert cluster.leader().nid != killed
        client.discover_leader(force=True)
        # Sessions are replicated: the token taken before the kill holds.
        assert client.token == token
        assert [m.filename for m in client.course_materials()] == ["l4.pdf"]
        assert client.ask_instructor("Acked after the kill?")
        cluster.restart(killed)
        states = cluster.converged()
    finally:
        client.close()
    assert sorted(states) == [1, 2, 3]
    for data in states.values():
        assert [q["query"] for q in data["queries"]["ana"]] == [
            "When is hw2 due?", "Acked after the kill?"]
        assert data == states[killed]


@pytest.mark.parametrize("kinds,leader", [
    (["port", "jax", "port"], 2),   # the JAX node leads
    (["jax", "port", "jax"], 2),    # the port node leads
], ids=["jax-leads", "port-leads"])
def test_mixed_cluster_commits_equal_states(tmp_path, kinds, leader):
    cluster = Cluster(kinds, tmp_path).start()
    client = cluster.client()
    try:
        assert cluster.transfer_to(leader).pkg.name == kinds[leader - 1]
        _journey(client)
        states = cluster.converged()
        digests = {m.node.state_digest for m in cluster.members.values()}
    finally:
        client.close()
        cluster.close()
    assert len(states) == 3 and len(digests) == 1
    first = states[1]
    assert all(data == first for data in states.values())
    assert set(first["users"]) == {"ana", "prof"}


FLEET = [f"10.0.0.{i}:50054" for i in range(1, 6)]
QUERIES = [f"question {i} about B-trees and {w}" for i, w in
           enumerate(["splits", "merges", "LSM trees", "WAL", "Raft",
                      "hash joins", "sorting", "caches"] * 4)]


def test_affinity_keys_match_jax():
    for q in QUERIES:
        assert port_pool.affinity_key(q) == jax_pool.affinity_key(q)
    for sid in ("s-1", "student-42", ""):
        assert port_pool.session_affinity_key(sid) \
            == jax_pool.session_affinity_key(sid)


@pytest.mark.parametrize("fleet_size", [1, 3, 5])
def test_pool_places_each_query_where_jax_does(fleet_size):
    async def routes(mod):
        pool = mod.TutoringPool(FLEET[:fleet_size])
        try:
            return ([pool.route_snapshot(q) for q in QUERIES],
                    [pool.route_snapshot("", session_id=f"s{i}")
                     for i in range(8)],
                    pool.snapshot())
        finally:
            await pool.close()

    import asyncio

    ref = asyncio.run(routes(jax_pool))
    port = asyncio.run(routes(port_pool))
    assert port == ref
    if fleet_size > 1:
        assert len({r["order"][0]["address"] for r in port[0]}) > 1


def test_two_group_processes_from_the_deployment_file(tmp_path):
    from distributed_lms_raft_llm_tpu_torch.client import LMSClient
    from distributed_lms_raft_llm_tpu_torch.lms.group_router import (
        stable_hash,
    )
    from distributed_lms_raft_llm_tpu_torch.serving import lms_cluster

    bases, stride, metrics_ports = lms_cluster.free_group_ports(3, 2, 3)
    changes = {("cluster", "data_dir"): str(tmp_path / "data")}
    for i in (1, 2, 3):
        changes[("cluster.nodes", str(i))] = f"127.0.0.1:{bases[i - 1]}"
    for i in (4, 5):
        changes[("cluster.nodes", str(i))] = lms_cluster.REMOVE
    for key in ("model", "checkpoint", "vocab"):
        changes[("gate", key)] = lms_cluster.REMOVE
    changes.update({("groups", "count"): 2,
                    ("groups", "port_stride"): stride,
                    ("groups", "secret"): "two-group-test"})
    path, applied = lms_cluster.deployment_copy(
        str(REPO / "configs" / "cluster.toml"), str(tmp_path), changes)
    assert "[groups] count = 2 (added)" in applied
    procs = [lms_cluster.LMSProcess(
        path, i, metrics_port=metrics_ports[i - 1], device="cpu",
        log_dir=str(tmp_path / "logs")).start() for i in (1, 2, 3)]
    client = None
    try:
        def topologies():
            docs = []
            for p in procs:
                if not lms_cluster.health(p.metrics_port):
                    return None
                docs.append(lms_cluster.http_json(p.metrics_port,
                                                  "/admin/raft")[1])
            leaders = [{gid: g["leader"] for gid, g in d["groups"].items()}
                       for d in docs]
            ok = all(set(lead) == {"0", "1"} and all(lead.values())
                     for lead in leaders) and len(
                {tuple(sorted(lead.items())) for lead in leaders}) == 1
            return docs if ok else None

        docs, _ = lms_cluster.wait_for(topologies, 30, alive=procs)
        for doc in docs:
            assert doc["routing_map"]["n_groups"] == 2
            for gid, group in doc["groups"].items():
                assert len(group["members"]) == 3
                assert group["term"] >= 1
            ports = [int(a.rsplit(":", 1)[1])
                     for a in doc["groups"]["1"]["members"].values()]
            assert ports == [b + stride for b in bases]
        code, body = lms_cluster.http_json(
            procs[0].metrics_port, "/admin/reshard",
            body={"course": "cs451", "to_group": 1})
        assert (code, body) == (400, {
            "error": "resharding is not enabled on this deployment"})
        users = {}
        for i in range(64):
            users.setdefault(stable_hash(f"u{i}") % 2, f"u{i}")
        client = LMSClient([f"127.0.0.1:{b}" for b in bases],
                           discovery_backoff_s=0.2)
        for gid in (0, 1):
            name = users[gid]
            assert client.register(name, "pw", "student").success
            assert client.login(name, "pw")
            assert client.upload_assignment(f"{name}.pdf",
                                            pdf.make_pdf(f"{name} hw"))
            client.logout()
        assert client.register("prof", "pw", "instructor").success
        assert client.login("prof", "pw")
        assert sorted(e.id for e in client.student_assignments()) == sorted(
            users.values())
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.stop()
