"""The main path with the port's relevance gate inside the unchanged JAX LMS.

One JAX `LMSNode` + `LMSServicer` (as tests/test_lms_cluster.py builds
them, one node) takes a student's `GetLLMAnswer` and `StreamLLMAnswer`,
checks the question with a gate, and forwards what passes to the PORT's
tutoring node (tiny, float32, CPU, greedy) over real gRPC on 127.0.0.1.
The gate is the port's `RelevanceGate` (tiny, float32, CPU) or, as the
reference, the JAX gate, on the same weights (the JAX gate's tree carried
across with `params_from_jax`); every test runs against both and expects
the same:

- an on-topic question (the assignment's own text) returns the port
  node's answer, the one its `GetLLMAnswer` gives directly;
- an off-topic question returns the JAX refusal text with the similarity
  the JAX gate reports for the same weights, formatted to 2 places;
- `gate_pass` and `gate_reject` count one each way.

Random tiny weights put every similarity near 1, so the threshold is the
midpoint between the JAX gate's similarities for the two questions.
"""

import asyncio
import threading

import grpc
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.client import LMSClient
from distributed_lms_raft_llm_tpu.engine.gate import (
    GateConfig as JaxGateConfig,
    RelevanceGate as JaxGate,
)
from distributed_lms_raft_llm_tpu.lms.node import LMSNode
from distributed_lms_raft_llm_tpu.lms.service import (
    FileTransferServicer,
    LMSServicer,
)
from distributed_lms_raft_llm_tpu.proto import rpc as jax_rpc
from distributed_lms_raft_llm_tpu.raft import RaftConfig
from distributed_lms_raft_llm_tpu.raft.grpc_transport import RaftServicer
from distributed_lms_raft_llm_tpu.utils import pdf
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    GateConfig,
    RelevanceGate,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.models import bert, convert
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server

FAST = RaftConfig(election_timeout_min=0.11, election_timeout_max=0.22,
                  heartbeat_interval=0.05)
HOMEWORK = "Homework 2: implement a B-tree with insert and split"
ON_TOPIC = pdf.extract_text(pdf.make_pdf(HOMEWORK))  # the LMS's context
OFF_TOPIC = "zzzz ???? 0000 #### qqqq"


@pytest.fixture(scope="module")
def reference():
    """The JAX gate's weights and similarities, and the threshold that
    splits the two questions."""
    jgate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32))
    assert ON_TOPIC.strip() == HOMEWORK
    sims = {q: jgate.check(q, ON_TOPIC)[1] for q in (ON_TOPIC, OFF_TOPIC)}
    assert sims[ON_TOPIC] - sims[OFF_TOPIC] > 1e-2, sims
    threshold = (sims[ON_TOPIC] + sims[OFF_TOPIC]) / 2
    return jax.device_get(jgate.params), sims, threshold


def _gate(kind, params, threshold):
    if kind == "jax":
        gate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32,
                                     threshold=threshold))
        gate.params = jax.tree_util.tree_map(jnp.asarray, params)
        return gate
    gate = RelevanceGate(GateConfig(model="tiny", dtype=torch.float32,
                                    threshold=threshold, device="cpu"))
    gate.params = bert.cast_products(
        convert.params_from_jax(params, device="cpu"), gate.cfg.dtype)
    return gate


@pytest.fixture(scope="module", params=["jax", "port"])
def stack(request, reference, tmp_path_factory):
    """The port's tutoring node and one JAX LMS node with the `param` gate,
    on a private event-loop thread."""
    params, sims, threshold = reference
    tmp = tmp_path_factory.mktemp(f"gate-{request.param}")
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state = dict(kind=request.param, sims=sims, loop=loop)

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            engine = TutoringEngine(EngineConfig(
                model="tiny", length_buckets=(32,), batch_buckets=(1, 2, 4),
                sampling=SamplingParams.greedy(max_new_tokens=6),
                dtype=torch.float32, param_dtype=torch.float32,
                device="cpu"))
            tut = await tutoring_server.serve_async(0, engine,
                                                    host="127.0.0.1")
            server = grpc.aio.server()
            port = server.add_insecure_port("127.0.0.1:0")
            addresses = {1: f"127.0.0.1:{port}"}
            node = LMSNode(1, addresses, str(tmp / "node1"), raft_config=FAST)
            metrics = JaxMetrics()
            servicer = LMSServicer(
                node.node, node.state, node.blobs,
                gate=_gate(request.param, params, threshold),
                tutoring_address=f"127.0.0.1:{tut._port}", metrics=metrics)
            jax_rpc.add_LMSServicer_to_server(servicer, server)
            jax_rpc.add_RaftServiceServicer_to_server(
                RaftServicer(node.node, addresses, kv=node.state.data["kv"]),
                server)
            jax_rpc.add_FileTransferServiceServicer_to_server(
                FileTransferServicer(node.blobs), server)
            await server.start()
            await node.start()
            state.update(node=node, server=server, tut=tut, metrics=metrics,
                         servicer=servicer, address=addresses[1],
                         tut_address=f"127.0.0.1:{tut._port}")
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(60)
    client = LMSClient([state["address"]], discovery_backoff_s=0.2)
    assert client.register("ana", "pw", "student").success
    assert client.login("ana", "pw")
    assert client.upload_assignment("hw2.pdf", pdf.make_pdf(HOMEWORK))
    state["client"] = client
    yield state
    client.close()

    async def teardown():
        await state["node"].stop()
        await state["server"].stop(None)
        await state["tut"].stop(None)
        await state["tut"]._queue.close()

    asyncio.run_coroutine_threadsafe(teardown(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)
    assert not thread.is_alive()


def _direct_answer(stack, query):
    """The port tutoring node's own answer to `query`."""
    async def ask():
        async with grpc.aio.insecure_channel(stack["tut_address"]) as ch:
            return await rpc.TutoringStub(ch).GetLLMAnswer(
                lms_pb2.QueryRequest(query=query), timeout=60)

    resp = asyncio.run_coroutine_threadsafe(ask(), stack["loop"]).result(90)
    assert resp.success and resp.response
    return resp.response


def _counts(stack):
    counters = stack["metrics"].snapshot()["counters"]
    return counters.get("gate_pass", 0), counters.get("gate_reject", 0)


def _refusal(sim):
    return ("Your query does not appear related to your assignment "
            f"(similarity {sim:.2f}); please ask your instructor instead.")


def test_context_is_the_assignment_text(stack):
    (assignment,) = stack["node"].state.assignments_of("ana")
    assert assignment["text"] == ON_TOPIC
    assert isinstance(stack["servicer"].gate,
                      RelevanceGate if stack["kind"] == "port" else JaxGate)


@pytest.mark.parametrize("stream", [False, True])
def test_on_topic_question_gets_the_port_nodes_answer(stack, stream):
    before = _counts(stack)
    client = stack["client"]
    resp = (client.ask_llm_stream(ON_TOPIC) if stream
            else client.ask_llm(ON_TOPIC))
    assert resp.success
    assert resp.response == _direct_answer(stack, ON_TOPIC).strip()
    assert "instructor" not in resp.response
    assert _counts(stack) == (before[0] + 1, before[1])


@pytest.mark.parametrize("stream", [False, True])
def test_off_topic_question_gets_the_jax_refusal(stack, stream):
    before = _counts(stack)
    client = stack["client"]
    resp = (client.ask_llm_stream(OFF_TOPIC) if stream
            else client.ask_llm(OFF_TOPIC))
    assert resp.success
    assert resp.response == _refusal(stack["sims"][OFF_TOPIC])
    assert _counts(stack) == (before[0], before[1] + 1)


def test_port_gate_similarity_is_the_jax_gates(stack):
    gate = stack["servicer"].gate
    for query, sim in stack["sims"].items():
        passed, got = gate.check(query, ON_TOPIC)
        assert got == pytest.approx(sim, abs=1e-5)
        assert passed == (query == ON_TOPIC)
