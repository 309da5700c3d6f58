"""The north-star main path on the CPU, whole: one student session through
the JAX package's LMS, gate and tutoring node, and the same session
through the port's LMS, gate and tutoring node.

Each stack is one LMS node (`LMSNode` + `LMSServicer` over gRPC on
127.0.0.1, started by `torch_lms_harness.py`), its relevance gate (tiny
BERT, float32) and a paged tutoring node (tiny GPT-2, float32, greedy
with a repetition penalty, so random weights answer with distinct
tokens). The port's gate and node run on `device="cpu"` with the JAX
trees carried across by `convert.params_from_jax`; the student drives
each stack with that package's `LMSClient`.

The session: Register, Login, Post an assignment (`pdf.make_pdf`), an
on-topic and an off-topic `GetLLMAnswer`, an on-topic `StreamLLMAnswer`,
and, with the tutoring node stopped, the degraded answer (the instructor
queue). Every reply text must be equal between the stacks (exact), the
gate's counters equal, and the final LMS states equal with the minted
fields masked (password hashes and salts, session tokens, request ids:
`os.urandom` / `uuid`). The gate's threshold is the midpoint of the JAX
gate's two similarities, as in `tests/test_torch_gate_lms.py`.

The assignment is the first of `HOMEWORKS` whose on-topic answer decodes
prefix-stably at every token (as `tests/test_torch_tutoring_server.py`
picks its queries): the JAX node's stream hold-back splits a UTF-8
character where one is not, a recorded reference quirk (ROADMAP.md §3).
"""

import asyncio
from pathlib import Path

import grpc
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_lms_harness import Cluster

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import PagedQueue as JaxQueue
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine.gate import GateConfig as JaxGateConfig
from distributed_lms_raft_llm_tpu.engine.gate import RelevanceGate as JaxGate
from distributed_lms_raft_llm_tpu.proto import rpc as jax_rpc
from distributed_lms_raft_llm_tpu.serving import tutoring_server as jax_server
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    GateConfig,
    PagedEngine,
    RelevanceGate,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.models import bert, convert
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.serving.prompts import PROMPT_TEMPLATE
from distributed_lms_raft_llm_tpu_torch.utils import pdf
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

REPO = Path(__file__).resolve().parent.parent
MAX_NEW = 8
PENALTY = 3.0
HOMEWORKS = [
    "Homework 2: implement a B-tree with insert and split",
    "Homework 3: a write-ahead log with checksummed records",
    "Homework 4: leader election in Raft with randomized timeouts",
    "Homework 5: an LSM tree with leveled compaction",
]
OFF_TOPIC = "zzzz ???? 0000 #### qqqq"


def _sound(peng, query):
    """True when the node's answer to `query` decodes prefix-stably."""
    plain = PagedEngine(peng.config, slots=2, chunk=2)
    plain.params = peng.params
    rid = plain.submit(PROMPT_TEMPLATE.format(query=query))
    plain.stream_watch(rid)
    plain.drain()
    toks = plain.pop_final_tokens()[rid]
    tok = plain.tokenizer
    full = tok.decode(toks)
    return all(full.startswith(tok.decode(toks[:k]))
               for k in range(len(toks)))


@pytest.fixture(scope="module")
def reference():
    """The JAX trees (engine and gate), the assignment, the threshold."""
    common = dict(model="tiny", batch_buckets=(1, 2, 4),
                  length_buckets=(16, 32, 48))
    kw = dict(slots=2, chunk=2)
    jeng = JaxPaged(JaxConfig(
        dtype=jnp.float32, param_dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW,
                                    repetition_penalty=PENALTY),
        **common), **kw)
    peng_cfg = EngineConfig(
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW,
                                       repetition_penalty=PENALTY),
        **common)
    params = jax.device_get(jeng.params)
    probe = PagedEngine(peng_cfg, **kw)
    probe.params = convert.params_from_jax(params, device="cpu")
    homework = next((h for h in HOMEWORKS
                     if _sound(probe, pdf.extract_text(pdf.make_pdf(h)))),
                    None)
    assert homework is not None
    on_topic = pdf.extract_text(pdf.make_pdf(homework))
    jgate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32))
    sims = {q: jgate.check(q, on_topic)[1] for q in (on_topic, OFF_TOPIC)}
    assert sims[on_topic] - sims[OFF_TOPIC] > 1e-2, sims
    return dict(jeng=jeng, peng_cfg=peng_cfg, kw=kw, params=params,
                gate_params=jax.device_get(jgate.params), sims=sims,
                threshold=(sims[on_topic] + sims[OFF_TOPIC]) / 2,
                homework=homework, on_topic=on_topic)


def _gate(kind, ref):
    if kind == "jax":
        gate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32,
                                     threshold=ref["threshold"]))
        gate.params = jax.tree_util.tree_map(jnp.asarray, ref["gate_params"])
        return gate
    gate = RelevanceGate(GateConfig(model="tiny", dtype=torch.float32,
                                    threshold=ref["threshold"], device="cpu"))
    gate.params = bert.cast_products(
        convert.params_from_jax(ref["gate_params"], device="cpu"),
        gate.cfg.dtype)
    return gate


async def _tutoring_node(kind, ref):
    """(address, stop) of a tutoring node of `kind` on 127.0.0.1."""
    if kind == "jax":
        metrics = JaxMetrics()
        queue = JaxQueue(ref["jeng"], metrics=metrics)
        await queue.start()
        server = grpc.aio.server()
        jax_rpc.add_TutoringServicer_to_server(
            jax_server.TutoringService(queue, metrics, node_id="jax"),
            server)
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()

        async def stop():
            await server.stop(None)
            await queue.close()

        return f"127.0.0.1:{port}", stop
    peng = PagedEngine(ref["peng_cfg"], **ref["kw"])
    peng.params = convert.params_from_jax(ref["params"], device="cpu")
    server = await tutoring_server.serve_async(0, peng, host="127.0.0.1",
                                               node_id="port")

    async def stop():
        await server.stop(None)
        await server._queue.close()

    return f"127.0.0.1:{server._port}", stop


def run_session(kind, ref, tmp_path):
    """The student session on one stack: (replies, counters, state, the
    node's direct answer)."""
    import contextlib

    metrics = JaxMetrics() if kind == "jax" else Metrics()
    cluster = Cluster([kind], tmp_path)
    tut_address, stop_tutoring = cluster.loop.run(_tutoring_node(kind, ref),
                                                  120)
    cluster.members[1].servicer_kwargs.update(
        gate=_gate(kind, ref), tutoring_address=tut_address, metrics=metrics)
    client = None
    with contextlib.ExitStack() as stack:
        stack.callback(cluster.close)
        stopped = []
        stack.callback(lambda: stopped or cluster.loop.run(stop_tutoring()))
        cluster.start()
        client = cluster.client(kind)
        stack.callback(client.close)
        on = ref["on_topic"]
        replies = [
            ("register", client.register("ana", "pw", "student").success),
            ("login", client.login("ana", "pw")),
            ("post", client.upload_assignment(
                "hw.pdf", pdf.make_pdf(ref["homework"]))),
        ]
        for name, call, query in (("ask", client.ask_llm, on),
                                  ("off-topic", client.ask_llm, OFF_TOPIC),
                                  ("stream", client.ask_llm_stream, on)):
            resp = call(query)
            replies.append((name, resp.success, resp.response))
        direct = cluster.loop.run(_direct(tut_address, on), 120)
        cluster.loop.run(stop_tutoring())
        stopped.append(True)
        resp = client.ask_llm(on)
        replies.append(("degraded", resp.success, resp.response))
        states = cluster.converged()
    counters = metrics.snapshot()["counters"]
    counts = {k: counters.get(k, 0) for k in (
        "llm_requests", "gate_pass", "gate_reject", "tutoring_degraded")}
    return replies, counts, states[1], direct


async def _direct(address, query):
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc

    async with grpc.aio.insecure_channel(address) as channel:
        resp = await rpc.TutoringStub(channel).GetLLMAnswer(
            lms_pb2.QueryRequest(query=query), timeout=60)
    assert resp.success and resp.response
    return resp.response.strip()


@pytest.fixture(scope="module")
def sessions(reference, tmp_path_factory):
    return {kind: run_session(kind, reference,
                              tmp_path_factory.mktemp(f"main-{kind}"))
            for kind in ("jax", "port")}


STEPS = ["register", "login", "post", "ask", "off-topic", "stream",
         "degraded"]


@pytest.mark.parametrize("step", STEPS)
def test_reply_is_the_jax_stacks(sessions, step):
    jax_replies = dict((r[0], r[1:]) for r in sessions["jax"][0])
    port_replies = dict((r[0], r[1:]) for r in sessions["port"][0])
    assert port_replies[step] == jax_replies[step]


def test_answers_come_from_the_node_and_refusals_from_the_gate(sessions,
                                                               reference):
    replies = dict((r[0], r[1:]) for r in sessions["port"][0])
    direct = sessions["port"][3]
    assert direct == sessions["jax"][3]
    assert replies["ask"] == (True, direct)
    assert replies["stream"] == (True, direct)
    sim = reference["sims"][OFF_TOPIC]
    assert replies["off-topic"] == (True, (
        "Your query does not appear related to your assignment "
        f"(similarity {sim:.2f}); please ask your instructor instead."))
    assert replies["degraded"][0] and "instructor" in replies["degraded"][1]


def test_gate_and_degraded_counters_match(sessions):
    assert sessions["port"][1] == sessions["jax"][1]
    assert sessions["port"][1]["gate_pass"] == 3
    assert sessions["port"][1]["gate_reject"] == 1
    assert sessions["port"][1]["tutoring_degraded"] == 1


def _masked(state):
    state = {k: v for k, v in state.items()}
    state["users"] = {u: dict(rec, password="*", salt="*")
                      for u, rec in state["users"].items()}
    state["sessions"] = sorted(state["sessions"].values())
    state["applied_requests"] = len(state["applied_requests"])
    return state


def test_final_states_match_with_minted_fields_masked(sessions, reference):
    port, ref = _masked(sessions["port"][2]), _masked(sessions["jax"][2])
    assert port == ref
    assert port["sessions"] == ["ana"]
    # The degraded ask went to the instructor queue.
    assert [q["query"] for q in port["queries"]["ana"]] == [
        reference["on_topic"]]


def test_lms_processes_started_from_the_deployment_file(reference,
                                                        tmp_path):
    """The port's entry point, as chip_smoke.py's phase 11 runs it on the
    card: three LMS processes started from a copy of configs/cluster.toml
    (`serving/lms_cluster.py`: free ports, the data directory, the tiny
    gate on the CPU, the in-process port tutoring node's address) elect
    one leader that all name through WhoIsLeader; a student's on-topic
    answer is the node's direct answer, over GetLLMAnswer and
    StreamLLMAnswer; the off-topic question is refused by the gate; after
    a SIGKILL of the leader a new one is elected, the session holds and
    the same question gets the same answer; the killed node restarted on
    its data directory catches up to the leader's applied index. Every
    wait has its own bound."""
    from distributed_lms_raft_llm_tpu_torch.client import LMSClient
    from distributed_lms_raft_llm_tpu_torch.serving import lms_cluster
    from torch_lms_harness import LoopThread

    gate = RelevanceGate(GateConfig(model="tiny", device="cpu"))
    on = reference["on_topic"]
    sims = {q: gate.check(q, on)[1] for q in (on, OFF_TOPIC)}
    assert sims[on] > sims[OFF_TOPIC]
    threshold = (sims[on] + sims[OFF_TOPIC]) / 2
    loop = LoopThread()
    procs = []
    client = stop_tutoring = None
    try:
        tut_address, stop_tutoring = loop.run(
            _tutoring_node("port", reference), 120)
        ports = lms_cluster.free_ports(6)
        changes = {("cluster", "data_dir"): str(tmp_path / "data")}
        for i in (1, 2, 3):
            changes[("cluster.nodes", str(i))] = f"127.0.0.1:{ports[i - 1]}"
        for i in (4, 5):
            changes[("cluster.nodes", str(i))] = lms_cluster.REMOVE
        changes.update({
            ("gate", "model"): "tiny",
            ("gate", "checkpoint"): lms_cluster.REMOVE,
            ("gate", "vocab"): lms_cluster.REMOVE,
            ("gate", "threshold"): threshold,
            ("tutoring", "address"): tut_address,
            ("tutoring_fleet", "addresses"): [tut_address],
            ("tutoring_fleet", "health_addresses"): [],
        })
        path, applied = lms_cluster.deployment_copy(
            str(REPO / "configs" / "cluster.toml"), str(tmp_path), changes)
        assert len(applied) == len(changes)
        addresses = [f"127.0.0.1:{p}" for p in ports[:3]]
        procs = [lms_cluster.LMSProcess(
            path, i, metrics_port=ports[2 + i], device="cpu",
            log_dir=str(tmp_path / "logs")).start() for i in (1, 2, 3)]

        def leader():
            named = {lms_cluster.who_is_leader(a) for a in addresses
                     if procs[addresses.index(a)].alive}
            return named.pop() if len(named) == 1 and None not in named \
                else None

        lms_cluster.wait_for(
            lambda: all(lms_cluster.health(p.metrics_port) for p in procs),
            120, alive=procs)
        first, _ = lms_cluster.wait_for(leader, 30, alive=procs)
        client = LMSClient(addresses, discovery_backoff_s=0.2)
        assert client.register("ana", "pw", "student").success
        assert client.login("ana", "pw")
        assert client.upload_assignment("hw.pdf",
                                        pdf.make_pdf(reference["homework"]))
        direct = loop.run(_direct(tut_address, on), 120)
        assert client.ask_llm(on).response == direct
        assert client.ask_llm_stream(on).response == direct
        refusal = client.ask_llm(OFF_TOPIC).response
        assert refusal.startswith("Your query does not appear related")
        code, metrics = lms_cluster.http_json(procs[first - 1].metrics_port,
                                              "/metrics")
        assert code == 200
        assert (metrics["counters"]["gate_pass"],
                metrics["counters"]["gate_reject"]) == (2, 1)

        procs[first - 1].kill()
        second, _ = lms_cluster.wait_for(
            lambda: (lambda n: n if n not in (None, first) else None)(
                leader()), 30)
        client.discover_leader(force=True)
        assert client.ask_llm(on).response == direct  # the session holds
        procs[first - 1].start()
        lead_port = procs[second - 1].metrics_port

        def caught_up():
            mine = lms_cluster.health(procs[first - 1].metrics_port)
            theirs = lms_cluster.health(lead_port)
            return (mine and theirs and mine["leader_id"] == second
                    and mine["applied_index"] >= theirs["applied_index"])

        lms_cluster.wait_for(caught_up, 120, alive=procs)
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.stop()
        try:
            if stop_tutoring is not None:
                loop.run(stop_tutoring())
        finally:
            loop.close()
