"""A bulk-grading job from the unchanged JAX LMS, scored on a port node.

One JAX `LMSNode` + `LMSServicer` (as tests/test_torch_gate_lms.py builds
them) holds two students' submitted assignments. Its admin plane
(`serving/lms_server.make_admin`, POST /admin/score {"purpose":
"grading"}) collects the submissions' text and sends the job through the
JAX `TutoringPool.submit_score_job` (the fleet's background route, over
the nodes' admin planes) to a tutoring node; GET /admin/score/<id> on the
LMS proxies the node's job (`TutoringPool.score_job_status`).

The nodes, on 127.0.0.1:

- the PORT's tutoring node, started the way its `main` starts one from
  configs/dev.toml (`resolve_args` with `--config`, `engine_from_args`,
  `serve_args`): the tiny paged engine with the file's options and the
  scoring tenant on, in float32 on the CPU;
- a JAX tutoring node with the scoring tenant on, whose engine's weights
  the port's engine carries (`params_from_jax`).

The same job sent to each node gives per submission equal `tokens` and
`truncated` and `logprob` within SCORE_RTOL / SCORE_ATOL (float32, the
same products summed in different orders).
"""

import asyncio
import itertools
import math
import threading
from pathlib import Path

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # noqa: F401
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.client import LMSClient
from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.lms.node import LMSNode
from distributed_lms_raft_llm_tpu.lms.service import (
    FileTransferServicer,
    LMSServicer,
)
from distributed_lms_raft_llm_tpu.lms.tutoring_pool import TutoringPool
from distributed_lms_raft_llm_tpu.proto import rpc as jax_rpc
from distributed_lms_raft_llm_tpu.raft import RaftConfig
from distributed_lms_raft_llm_tpu.raft.grpc_transport import RaftServicer
from distributed_lms_raft_llm_tpu.serving import tutoring_server as jax_server
from distributed_lms_raft_llm_tpu.serving.lms_server import make_admin
from distributed_lms_raft_llm_tpu.utils import pdf
from distributed_lms_raft_llm_tpu.utils.diskfaults import DiskFaultInjector
from distributed_lms_raft_llm_tpu.utils.faults import (
    CampaignRunner,
    FaultInjector,
)
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server

SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-4
_JOB_IDS = itertools.count()
DEV = str(Path(__file__).resolve().parent.parent / "configs" / "dev.toml")
FAST = RaftConfig(election_timeout_min=0.11, election_timeout_max=0.22,
                  heartbeat_interval=0.05)
SUBMISSIONS = {
    "ana": ("hw1.pdf", "Homework 1: a B-tree keeps its keys sorted and "
            "splits a full node in two"),
    "bo": ("hw1.pdf", "Homework 1: raft"),
}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The LMS node, the port's node and a JAX node on a private event-loop
    thread; the LMS holds both students' submissions."""
    tmp = tmp_path_factory.mktemp("scoring-lms")
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state = dict(loop=loop)

    def run():
        asyncio.set_event_loop(loop)
        jeng = JaxPaged(JaxConfig(
            model="tiny", dtype=jnp.float32, param_dtype=jnp.float32,
            sampling=JaxSampling.greedy(max_new_tokens=8),
            kv_quant=True, scoring=True), slots=2, chunk=2)
        jeng.warmup()
        args = tutoring_server.resolve_args(
            ["--config", DEV, "--device", "cpu", "--port", "0",
             "--metrics-port", "0", "--node-id", "port-1"])
        engine = tutoring_server.engine_from_args(args)
        engine.params = params_from_jax(jax.device_get(jeng.params),
                                        device="cpu")
        engine.warmup()

        async def boot():
            jax_tut = await jax_server.serve_async(
                0, jeng, metrics_port=0, scoring=True, telemetry=False)
            tut = await tutoring_server.serve_args(args, engine,
                                                   host="127.0.0.1")
            server = grpc.aio.server()
            port = server.add_insecure_port("127.0.0.1:0")
            addresses = {1: f"127.0.0.1:{port}"}
            node = LMSNode(1, addresses, str(tmp / "node1"), raft_config=FAST)
            servicer = LMSServicer(
                node.node, node.state, node.blobs,
                tutoring_address=f"127.0.0.1:{tut._port}",
                metrics=JaxMetrics())
            jax_rpc.add_LMSServicer_to_server(servicer, server)
            jax_rpc.add_RaftServiceServicer_to_server(
                RaftServicer(node.node, addresses, kv=node.state.data["kv"]),
                server)
            jax_rpc.add_FileTransferServiceServicer_to_server(
                FileTransferServicer(node.blobs), server)
            await server.start()
            await node.start()
            state.update(
                node=node, server=server, tut=tut, jax_tut=jax_tut,
                engine=engine, args=args, address=addresses[1],
                nodes={
                    "port": (f"127.0.0.1:{tut._port}",
                             f"127.0.0.1:{tut._health.port}"),
                    "jax": (f"127.0.0.1:{jax_tut._port}",
                            f"127.0.0.1:{jax_tut._health.port}")})
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(120)
    client = LMSClient([state["address"]], discovery_backoff_s=0.2)
    for who, (name, text) in SUBMISSIONS.items():
        assert client.register(who, "pw", "student").success
        assert client.login(who, "pw")
        assert client.upload_assignment(name, pdf.make_pdf(text))
    client.close()
    yield state

    async def teardown():
        await state["node"].stop()
        await state["server"].stop(None)
        for key in ("tut", "jax_tut"):
            await state[key].stop(None)
            await state[key]._queue.close()
        for task in (state["jax_tut"]._metrics_task,
                     state["jax_tut"]._watchdog_task):
            task.cancel()
        await asyncio.gather(state["jax_tut"]._metrics_task,
                             state["jax_tut"]._watchdog_task,
                             return_exceptions=True)

    asyncio.run_coroutine_threadsafe(teardown(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)
    assert not thread.is_alive()


def _on_loop(stack, coro, timeout=120):
    return asyncio.run_coroutine_threadsafe(coro, stack["loop"]).result(
        timeout)


def _lms_job(stack, node, body):
    """POST /admin/score on the LMS's admin plane with a one-node fleet of
    `node`; poll the LMS's proxy GET until the job is done. Returns (the
    POST's document, the finished job's)."""
    address, health = stack["nodes"][node]
    pool = TutoringPool([address], health_addresses=[health])
    faults, disk = FaultInjector(seed=0), DiskFaultInjector(seed=0)
    admin, admin_get = make_admin(
        stack["node"], faults, disk, CampaignRunner(faults, disk),
        pool=pool)

    async def run():
        posted = await admin("/admin/score", dict(body))
        for _ in range(600):
            doc = await admin_get(f"/admin/score/{posted['job_id']}")
            if doc["status"] in ("done", "failed"):
                return posted, doc
            await asyncio.sleep(0.05)
        raise AssertionError(f"job never finished: {doc}")

    return _on_loop(stack, run())


def test_the_port_node_started_from_the_dev_file(stack):
    engine, args = stack["engine"], stack["args"]
    assert isinstance(engine, PagedEngine) and engine.config.scoring
    assert args.scoring_max_job_texts == 256 and args.scoring_jobs_retained == 8
    assert stack["tut"]._scorer.max_job_texts == 256


@pytest.mark.parametrize("body", [
    {"purpose": "grading"},
    {"purpose": "grading", "student": "bo"},
    {"texts": ["raft elects a leader", "a quorum votes", "x" * 90],
     "purpose": "relevance"},
], ids=["grading", "one-student", "texts"])
def test_bulk_job_scores_on_the_port_node_as_on_a_jax_node(stack, body):
    results = {}
    for node in ("port", "jax"):
        job_id = f"{node}-{body['purpose']}-{next(_JOB_IDS)}"
        posted, doc = _lms_job(stack, node,
                               dict(body, job_id=job_id))
        assert posted["job_id"] == job_id
        assert posted["node"] == stack["nodes"][node][0]
        assert doc["node"] == stack["nodes"][node][0]
        assert doc["status"] == "done" and doc["error"] is None
        n = (len(body["texts"]) if "texts" in body
             else 1 if "student" in body else len(SUBMISSIONS))
        assert posted["submitted_texts"] == doc["texts"] == n
        results[node] = doc["results"]
    port, ref = results["port"], results["jax"]
    assert [r["tokens"] for r in port] == [r["tokens"] for r in ref]
    assert [r["truncated"] for r in port] == [r["truncated"] for r in ref]
    assert all(math.isfinite(r["logprob"]) and r["tokens"] > 0
               for r in port)
    np.testing.assert_allclose([r["logprob"] for r in port],
                               [r["logprob"] for r in ref],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    if "texts" in body:
        assert [r["truncated"] for r in port] == [False, False, True]


def test_unknown_job_is_404_through_the_lms(stack):
    address, health = stack["nodes"]["port"]
    pool = TutoringPool([address], health_addresses=[health])
    pool._score_jobs["gone"] = pool.nodes[0]  # routed, then trimmed

    async def run():
        with pytest.raises(KeyError):
            await pool.score_job_status("gone")
        with pytest.raises(KeyError):
            await pool.score_job_status("never-routed")

    _on_loop(stack, run())
