"""A JAX tutoring node and a port tutoring node in one fleet, on the CPU.

Both nodes serve tiny paged engines on the same weights (the JAX engine's
tree carried across with `params_from_jax`), float32, greedy, over real
gRPC on 127.0.0.1, behind the JAX package's unchanged `TutoringPool`:

- a stream that breaks after its first chunk on one node (the fault
  injector's `error` fault, as in tests/test_streaming.py) resumes on the
  other at the delivered offset, with no gap and no duplicate, in both
  directions, and its digest is the unary answer's;
- the port node's /healthz carries what the JAX node's does (`draining`,
  `queued`, `node_id`, `sessions`), its /admin/trace holds a fragment
  under the trace id the pool sent, parented on the pool's span, and
  /admin/score answers 404, as on a JAX node without a scorer;
- a drained port node refuses both RPCs with UNAVAILABLE and the pool's
  stream spills to the JAX node; un-drained, it answers again.
"""

import asyncio
import hashlib
import json
import random

import grpc
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import PagedQueue as JaxQueue
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.lms.tutoring_pool import (
    TutoringPool,
    session_affinity_key,
)
from distributed_lms_raft_llm_tpu.proto import lms_pb2 as jax_pb2
from distributed_lms_raft_llm_tpu.proto import rpc as jax_rpc
from distributed_lms_raft_llm_tpu.serving import tutoring_server as jax_server
from distributed_lms_raft_llm_tpu.utils import tracing as jax_tracing
from distributed_lms_raft_llm_tpu.utils.faults import FaultInjector
from distributed_lms_raft_llm_tpu.utils.healthz import (
    HealthServer as JaxHealthServer,
)
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu.utils.timeline import (
    render_prometheus as jax_render_prometheus,
)
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.serving.prompts import PROMPT_TEMPLATE
from distributed_lms_raft_llm_tpu_torch.utils import tracing
from distributed_lms_raft_llm_tpu_torch.utils.healthz import render_prometheus
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

MAX_NEW = 16
# Argmax decoding with a repetition penalty, so random tiny weights answer
# with many distinct tokens (and so several stream deltas).
PENALTY = 3.0
QUERIES = [f"question number {i} about distributed logs?" for i in range(12)]


@pytest.fixture(scope="module")
def engines():
    common = dict(model="tiny", batch_buckets=(1, 2, 4),
                  length_buckets=(16, 32, 48))
    kw = dict(slots=2, chunk=2, prefix_cache=True, prefix_block_tokens=4)
    jeng = JaxPaged(JaxConfig(
        dtype=jnp.float32, param_dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW,
                                    repetition_penalty=PENALTY),
        **common), **kw)
    peng = PagedEngine(EngineConfig(
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW,
                                       repetition_penalty=PENALTY),
        **common), **kw)
    peng.params = params_from_jax(jax.device_get(jeng.params), device="cpu")
    sound = _sound_queries(peng)
    assert len(sound) >= 2
    return jeng, peng, sound


def _sound_queries(peng):
    """The queries whose answers decode prefix-stably at every token
    boundary. The JAX node's hold-back delivers a token that ends inside a
    UTF-8 character, and when a later token completes that character its
    stream no longer assembles to its answer (tests/test_torch_streaming.py
    ::test_jax_hold_back_delivers_a_split_character); a resume there
    shows that fault of the reference, not the resume."""
    plain = PagedEngine(peng.config, slots=2, chunk=2)
    plain.params = peng.params
    tok = plain.tokenizer
    sound = []
    for query in QUERIES:
        rid = plain.submit(PROMPT_TEMPLATE.format(query=query))
        plain.stream_watch(rid)
        plain.drain()
        toks = plain.pop_final_tokens()[rid]
        full = tok.decode(toks)
        if all(full.startswith(tok.decode(toks[:k]))
               for k in range(len(toks))):
            sound.append(query)
    return sound


async def _jax_node(jeng):
    """A JAX tutoring node as its serve_async builds one (service, paged
    queue, health plane with the drain admin and /admin/trace), bound to
    127.0.0.1."""
    metrics = JaxMetrics()
    queue = JaxQueue(jeng, metrics=metrics)
    await queue.start()
    service = jax_server.TutoringService(queue, metrics, node_id="jax-node")
    server = grpc.aio.server()
    jax_rpc.add_TutoringServicer_to_server(service, server)
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()

    async def admin_get(path):
        return jax_tracing.trace_admin_get(path)

    health = JaxHealthServer(
        metrics,
        health=jax_server.make_tutoring_health(service, queue, "PagedEngine",
                                               0),
        admin=jax_server.make_tutoring_admin(service), admin_get=admin_get)
    hport = await health.start()

    async def stop():
        await health.stop()
        await server.stop(None)
        await queue.close()

    return f"127.0.0.1:{port}", hport, stop


async def _port_node(peng):
    server = await tutoring_server.serve_async(
        0, peng, host="127.0.0.1", metrics_port=0, node_id="port-node")

    async def stop():
        await server.stop(None)
        await server._queue.close()

    return f"127.0.0.1:{server._port}", server._health.port, stop


async def _http(port, method, path, payload=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, resp = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(resp)


def _with_fleet(engines, body):
    """Run `body(fleet)` with both nodes up behind a TutoringPool; `fleet`
    maps "jax"/"port" to (address, health port) and holds the pool and its
    fault injector."""
    jeng, peng, sound = engines

    async def run():
        jaddr, jhealth, jstop = await _jax_node(jeng)
        paddr, phealth, pstop = await _port_node(peng)
        injector = FaultInjector()
        pool = TutoringPool([jaddr, paddr], metrics=JaxMetrics(),
                            fault_injector=injector, hedge_after_s=0.0,
                            stream_stall_s=0.0)
        fleet = dict(jax=(jaddr, jhealth), port=(paddr, phealth), pool=pool,
                     injector=injector, sound=sound)
        try:
            return await body(fleet)
        finally:
            await pool.close()
            await pstop()
            await jstop()

    return asyncio.run(run())


def _route_to(fleet, name, skip=0):
    """(sound query, session id) that the pool routes to the node `name`
    first. The ports are ephemeral, so the ring is searched by session id
    (a session's key replaces the query's); a session's first turn is
    framed like a fresh query, on either node."""
    address = fleet[name][0]
    query = fleet["sound"][skip % len(fleet["sound"])]
    session = next(
        f"session-{i}" for i in range(10_000)
        if fleet["pool"].rendezvous_order(session_affinity_key(
            f"session-{i}"))[0].address == address)
    return query, session


async def _unary(address, stub_module, pb2, query):
    async with grpc.aio.insecure_channel(address) as channel:
        return await stub_module.TutoringStub(channel).GetLLMAnswer(
            pb2.QueryRequest(token="tok", query=query), timeout=60)


def _check_contract(chunks, start=0):
    assert chunks, "stream yielded nothing"
    delivered = start
    for ch in chunks:
        assert ch.success
        assert ch.offset == delivered, (
            f"offset gap: chunk at {ch.offset}, delivered {delivered}")
        delivered += ch.count
    assert [c.final for c in chunks].count(True) == 1
    assert chunks[-1].final
    return "".join(c.text for c in chunks), chunks[-1].digest


@pytest.mark.parametrize("broken", ["jax", "port"])
def test_stream_broken_on_one_node_resumes_on_the_other(engines, broken):
    async def body(fleet):
        pool, injector = fleet["pool"], fleet["injector"]
        query, session = _route_to(fleet, broken)
        winner = pool.rendezvous_order(session_affinity_key(session))[0]
        injector.configure(winner.fault_target(), error=1.0)
        chunks = [ch async for ch in pool.forward_stream(
            query, "tok", session_id=session)]
        resumes = pool.metrics.snapshot()["counters"].get("stream_resumes",
                                                          0)
        injector.clear(winner.fault_target())
        unary = {name: await _unary(fleet[name][0], mod, pb2, query)
                 for name, mod, pb2 in (("jax", jax_rpc, jax_pb2),
                                        ("port", rpc, lms_pb2))}
        return chunks, resumes, unary

    chunks, resumes, unary = _with_fleet(engines, body)
    assert resumes >= 1, "the broken stream must resume, not restart"
    assert chunks[0].count > 0 and not chunks[0].final
    full, digest = _check_contract(chunks)
    assert unary["jax"].success and unary["port"].success
    assert unary["jax"].response == unary["port"].response
    assert full.strip() == unary["port"].response
    assert digest == hashlib.sha256(full.strip().encode()).hexdigest()


def test_port_node_health_trace_and_score_planes(engines):
    async def body(fleet):
        pool = fleet["pool"]
        jhealth, phealth = fleet["jax"][1], fleet["port"][1]
        query, session = _route_to(fleet, "port")
        tracer = jax_tracing.get_tracer()
        with tracer.trace("lms.StreamLLMAnswer", trace_id="mixed-fleet-1"):
            chunks = [ch async for ch in pool.forward_stream(
                query, "tok", session_id=session)]
        query, session = _route_to(fleet, "jax")
        with tracer.trace("lms.StreamLLMAnswer", trace_id="mixed-fleet-2"):
            [ch async for ch in pool.forward_stream(query, "tok",
                                                    session_id=session)]
        return dict(
            chunks=chunks,
            jax_trace=await _http(jhealth, "GET",
                                  "/admin/trace/mixed-fleet-2"),
            jax_health=await _http(jhealth, "GET", "/healthz"),
            port_health=await _http(phealth, "GET", "/healthz"),
            port_trace=await _http(phealth, "GET",
                                   "/admin/trace/mixed-fleet-1"),
            listing=await _http(phealth, "GET", "/admin/trace"),
            pool_trace=tracer.tree("mixed-fleet-1"),
            score_post=await _http(phealth, "POST", "/admin/score",
                                   {"texts": ["a"]}),
            score_get=await _http(phealth, "GET", "/admin/score"),
            jax_score_post=await _http(jhealth, "POST", "/admin/score",
                                       {"texts": ["a"]}),
            metrics=await _http(phealth, "GET", "/metrics"))

    out = _with_fleet(engines, body)
    _check_contract(out["chunks"])
    (jstatus, jdoc), (status, doc) = out["jax_health"], out["port_health"]
    assert status == jstatus == 200
    assert set(doc) == set(jdoc)
    assert doc["node_id"] == "port-node" and doc["draining"] is False
    assert doc["queued"] == 0 and doc["sessions"] == jdoc["sessions"] == 1
    assert doc["engine"] == jdoc["engine"] == "PagedEngine"
    # The port's fragment continues the pool's x-trace-context: same
    # trace id, parented on the pool's tutoring.stream span.
    status, trace = out["port_trace"]
    assert status == 200 and trace["trace"]["trace_id"] == "mixed-fleet-1"
    roots = trace["trace"]["spans"]
    assert [r["name"] for r in roots] == ["tutoring.StreamLLMAnswer"]

    def span_ids(spans):
        for sp in spans:
            yield sp["span_id"]
            yield from span_ids(sp.get("children", []))

    assert roots[0]["parent_id"] in set(span_ids(out["pool_trace"]["spans"]))

    def find(spans, name):
        for sp in spans:
            if sp["name"] == name:
                return sp
            hit = find(sp.get("children", []), name)
            if hit is not None:
                return hit
        return None

    def shape(span):
        """The handler span, its children, and their children's names:
        which programs ran depends on each node's prefix cache."""
        kids = span.get("children", [])
        return (span["name"], sorted(k["name"] for k in kids),
                all(g["name"].startswith("engine.")
                    for k in kids for g in k.get("children", [])))

    # The same span tree as a JAX node's fragment for a streamed answer
    # (which this process's JAX tracer grafted under the pool's span):
    # queue.wait and engine.decode, with the shared engine.<program> spans.
    jax_handler = find(out["jax_trace"][1]["trace"]["spans"],
                       "tutoring.StreamLLMAnswer")
    assert shape(roots[0]) == shape(jax_handler) == (
        "tutoring.StreamLLMAnswer", ["engine.decode", "queue.wait"], True)
    decode = find(roots, "engine.decode")
    assert decode["children"] and all(
        c["attrs"]["shared"] for c in decode["children"])
    assert any(r["trace_id"] == "mixed-fleet-1"
               for r in out["listing"][1]["recent"]
               + out["listing"][1]["exemplars"])
    assert out["score_post"][0] == out["jax_score_post"][0] == 404
    assert out["score_get"][0] == 404
    counters = out["metrics"][1]["counters"]
    assert counters["stream_chunks"] == len(out["chunks"])
    assert counters["llm_requests"] == 1


def test_drained_port_node_refuses_and_the_pool_spills(engines):
    async def body(fleet):
        pool = fleet["pool"]
        paddr, phealth = fleet["port"]
        query, session = _route_to(fleet, "port", skip=1)
        drained = await _http(phealth, "POST", "/admin/drain",
                              {"drain": True})
        health = await _http(phealth, "GET", "/healthz")
        codes = []
        async with grpc.aio.insecure_channel(paddr) as channel:
            stub = rpc.TutoringStub(channel)
            for call in (
                    lambda: stub.GetLLMAnswer(
                        lms_pb2.QueryRequest(token="tok", query=query),
                        timeout=30),
                    lambda: stub.StreamLLMAnswer(
                        lms_pb2.StreamRequest(token="tok", query=query),
                        timeout=30).read()):
                with pytest.raises(grpc.aio.AioRpcError) as err:
                    await call()
                codes.append(err.value.code())
        spilled = [ch async for ch in pool.forward_stream(
            query, "tok", session_id=session)]
        await _http(phealth, "POST", "/admin/drain", {"drain": False})
        again = await _unary(paddr, rpc, lms_pb2, query)
        jax_answer = await _unary(fleet["jax"][0], jax_rpc, jax_pb2, query)
        metrics = await _http(phealth, "GET", "/metrics")
        return drained, health, codes, spilled, again, jax_answer, metrics

    drained, health, codes, spilled, again, jax_answer, metrics = \
        _with_fleet(engines, body)
    assert drained == (200, {"ok": True, "draining": True,
                             "node_id": "port-node"})
    assert health[1]["draining"] is True
    assert codes == [grpc.StatusCode.UNAVAILABLE] * 2
    full, _ = _check_contract(spilled)
    assert full.strip() == jax_answer.response
    assert again.success and again.response == jax_answer.response
    snap = metrics[1]
    assert snap["counters"]["tutoring_drain_rejections"] >= 2
    assert snap["gauges"]["tutoring_draining"] == 0.0


# JAX's tutoring_server main(): --metrics-port None, --queue-depth 64,
# --node-id None (tut-<port>), and without a TOML [sessions] a session TTL
# of 600 s and 256 sessions a node.
@pytest.mark.parametrize("argv,field,want", [
    ([], "metrics_port", None),
    (["--metrics-port", "0"], "metrics_port", 0),
    ([], "queue_depth", 64),
    ([], "node_id", None),
    ([], "session_ttl", 600.0),
    ([], "session_max", 256),
    (["--session-ttl", "30", "--session-max", "4"], "session_max", 4),
])
def test_cli_takes_the_jax_names_and_defaults(argv, field, want):
    assert getattr(tutoring_server.build_parser().parse_args(argv),
                   field) == want


@pytest.mark.parametrize("flag", [
    ["--scoring"], ["--no-telemetry"], ["--telemetry-interval", "1"],
    # (--spec-tokens is served since speculation was ported: the
    # approximate top-k the port does not carry takes its place.)
    ["--approx-topk"], ["--strict-dispatch"], ["--config", "x.toml"],
])
def test_cli_refuses_what_the_port_does_not_implement(flag):
    """A JAX flag the port does not carry is refused, never accepted and
    ignored."""
    with pytest.raises(SystemExit):
        tutoring_server.build_parser().parse_args(flag)


def _trace_workload(mod):
    """One scripted sequence of spans, flags and continuations on a tracer
    of `mod` (ids from a seeded `random`, clocks scripted); returns every
    query's answer."""
    random.seed(7)
    now = [0.0]
    tracer = mod.Tracer(ring_size=3, exemplars_per_route=1, flagged_max=2,
                        max_spans_per_trace=6, clock=lambda: now[0],
                        wall=lambda: 1000.0 + now[0])
    for i in range(7):
        with tracer.trace(f"route{i % 2}", trace_id=f"t{i}") as span:
            wait = span.child("queue.wait")
            now[0] += 0.01 * (i + 1)
            wait.end(duration_s=0.005 if i % 3 else None)
            span.child_timed("engine.decode", 1000.5, 0.2 * i, shared=True)
            if i in (3, 5):
                span.flag(mod.FLAG_DEADLINE)
            for _ in range(i):
                with tracer.span("engine.step", k=i):
                    now[0] += 0.001
    with tracer.continue_trace("tutoring.StreamLLMAnswer", "t6", "feed"):
        now[0] += 0.5
    contexts = [mod.parse_trace_context(v)
                for v in ("a/b", "a/", "/b", "ab", None, "x/y/z")]
    return (tracer.summaries(), [tracer.tree(f"t{i}") for i in range(7)],
            contexts)


def test_tracer_records_like_the_jax_tracer():
    """The port's trimmed tracer keeps the JAX flight recorder's
    behaviour: ring eviction, flagged and slowest-per-route pins, span
    budgets, remote-parented fragments, trace-context parsing."""
    got = _trace_workload(tracing)
    assert got == _trace_workload(jax_tracing)
    assert got[0]["exemplars"] and got[2] == [("a", "b"), None, None, None,
                                              None, ("x", "y/z")]


def test_prometheus_exposition_equals_the_jax_one():
    """/metrics.prom text of the slice's series (HELP and TYPE from the
    port's copy of the registry) is the JAX node's, byte for byte."""
    snaps = []
    for metrics_cls in (Metrics, JaxMetrics):
        m = metrics_cls()
        m.inc("stream_chunks", 12)
        m.inc("tutoring_drain_rejections")
        m.inc("engine_prog_unknown_counter", 2)
        m.set_gauge("session_active", 3)
        m.set_gauge("host_dispatches_per_token", 0.0039)
        for x in (0.1, 0.25, 0.4):
            m.hist("ttft").observe(x)
            m.hist("engine_prog_megastep").observe(x / 10)
        snaps.append(m.snapshot())
    assert snaps[0] == snaps[1]
    assert render_prometheus(snaps[0]) == jax_render_prometheus(snaps[1])
