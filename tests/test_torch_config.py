"""The port's tutoring node started from the deployment file, against the
JAX node, and its telemetry plane.

- For configs/cluster.toml and configs/dev.toml, every flag the JAX
  node's `main` fills from the file through `apply_file_defaults` (the
  overrides it passes are captured) resolves to the same value in the
  port's `resolve_args`, and so do what both read from the file beside
  their flags (the [sampling] overrides, the [sessions] knobs, the
  telemetry switch). The one recorded difference: without a
  `chip_ceiling_tokens_per_s` in the file the port has no ceiling (the
  JAX default is a TPU figure).
- An explicit flag beats the file on both nodes, also one given with its
  parser default.
- An unknown section, or an unknown key in any section (also those the
  port does not parse), is refused by both loaders.
- configs/dev.toml builds the port's paged engine with the file's options
  and the scoring tenant on.
- The port's LMS server (`serving/lms_server.py`) resolves the same
  arguments from both files as the JAX LMS server's `main` (captured at
  its `asyncio.run`), with and without overriding flags, and in the
  positional form; its `--device` stands where the JAX server has
  `--jax-platform`. `--groups 2` (and `[groups] count = 2` with a stride
  and a secret) resolves as the JAX server's: the sharded control plane
  is served, no longer refused.
- `--strict-dispatch` and `--approx-topk` (by flag, and `approx_top_k`
  from the file) resolve in the port's node as in the JAX node's `main`.
- The telemetry timeline and the serving watchdog: the port's `Timeline`
  folds snapshots into the JAX `Timeline`'s document (the JAX scraper's
  `from_dict` reads it back), the sampler samples, `GET /admin/timeline`
  serves it, and `LoopWatchdog` records lag and stalls as the JAX one does.
"""

import asyncio
import json
import time
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu import config as jax_config
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.serving import lms_server as jax_lms_server
from distributed_lms_raft_llm_tpu.serving import tutoring_server as jax_server
from distributed_lms_raft_llm_tpu.utils import guards as jax_guards
from distributed_lms_raft_llm_tpu.utils import timeline as jax_timeline
from distributed_lms_raft_llm_tpu.utils import tracing as jax_tracing
from distributed_lms_raft_llm_tpu_torch import config
from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
from distributed_lms_raft_llm_tpu_torch.serving import lms_server
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils import guards, timeline
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

REPO = Path(__file__).resolve().parent.parent
FILES = {name: str(REPO / "configs" / f"{name}.toml")
         for name in ("cluster", "dev")}


class _Stop(Exception):
    pass


def jax_resolve(argv, monkeypatch):
    """The JAX node's `main(argv)` up to its engine: (its args, the
    overrides it passed to `apply_file_defaults`)."""
    seen = {}
    merge = jax_config.apply_file_defaults

    def capture(args, parser, overrides, *, argv):
        merge(args, parser, overrides, argv=argv)
        seen.update(args=args, overrides=dict(overrides))

    def stop():
        raise _Stop

    monkeypatch.setattr(jax_config, "apply_file_defaults", capture)
    monkeypatch.setattr(jax_tracing, "configure_from", lambda cfg: None)
    monkeypatch.setattr(jax_mesh, "initialize_multihost", stop)
    with pytest.raises(_Stop):
        jax_server.main(argv)
    return seen["args"], seen["overrides"]


@pytest.mark.parametrize("name", sorted(FILES))
def test_config_resolves_what_the_jax_node_resolves(name, monkeypatch):
    argv = ["--config", FILES[name]]
    want, overrides = jax_resolve(argv, monkeypatch)
    got = tutoring_server.resolve_args(argv)
    assert len(overrides) == 31
    for key in overrides:
        assert getattr(got, key) == getattr(want, key), key
    assert got.sampling_overrides == want.sampling_overrides
    assert (got.session_ttl, got.session_max) == (want.session_ttl_s,
                                                  want.session_max)
    assert got.telemetry == want.telemetry is True
    assert got.scoring is True and got.tracing is not None
    # The one recorded difference: the ceiling comes from the file or not
    # at all (the JAX default is a TPU saturation figure).
    if name == "cluster":
        assert got.scoring_chip_ceiling == want.scoring_chip_ceiling
    else:
        assert got.scoring_chip_ceiling is None
        assert want.scoring_chip_ceiling > 0


@pytest.mark.parametrize("flags,approx", [
    (["--strict-dispatch"], False),
    (["--approx-topk"], True),
    (["--strict-dispatch", "--approx-topk"], True),
    ([], True),  # approx_top_k = true in the file
])
def test_strict_dispatch_and_approx_topk_resolve_as_the_jax_node(
        flags, approx, tmp_path, monkeypatch):
    from distributed_lms_raft_llm_tpu_torch.serving import lms_cluster

    src = FILES["dev"]
    if not flags:
        src, _ = lms_cluster.deployment_copy(
            FILES["dev"], str(tmp_path), {("sampling", "approx_top_k"): True})
    argv = ["--config", src] + flags
    want, _ = jax_resolve(argv, monkeypatch)
    got = tutoring_server.resolve_args(argv)
    assert (got.strict_dispatch, got.approx_topk) == (
        want.strict_dispatch, want.approx_topk) == (
        "--strict-dispatch" in flags, approx)


def test_explicit_flags_beat_the_file(monkeypatch):
    # --inflight 2 is the parser default and the file says 3: explicit
    # still wins.
    argv = ["--config", FILES["cluster"], "--slots", "4", "--inflight", "2",
            "--max-new-tokens", "16", "--scoring-jobs-retained", "3",
            "--port", "6000"]
    want, _ = jax_resolve(argv, monkeypatch)
    got = tutoring_server.resolve_args(argv)
    for key, value in (("slots", 4), ("inflight", 2), ("max_new_tokens", 16),
                       ("scoring_jobs_retained", 3), ("port", 6000),
                       ("megastep", 4), ("quant", "int8")):
        assert getattr(got, key) == getattr(want, key) == value, key
    assert got.session_ttl == 600.0  # no [sessions] in the file


def test_explicit_session_flags_beat_the_file(tmp_path):
    path = tmp_path / "s.toml"
    path.write_text("[sessions]\nttl_s = 30.0\nmax_sessions = 8\n")
    got = tutoring_server.resolve_args(["--config", str(path)])
    assert (got.session_ttl, got.session_max) == (30.0, 8)
    got = tutoring_server.resolve_args(["--config", str(path),
                                        "--session-max", "2"])
    assert (got.session_ttl, got.session_max) == (30.0, 2)


def test_llama_tutoring_section_resolves_as_the_jax_node(tmp_path,
                                                         monkeypatch):
    """configs/cluster.toml with `[tutoring] model = "llama3-8b"` and a
    `tokenizer_json`: the port's node resolves the model as the JAX node's
    `main` does and the tokenizer as the JAX `config.engine_config` does,
    and hands both to its engine (captured, not built: a full-width
    model)."""
    text = Path(FILES["cluster"]).read_text().replace(
        'model = "gpt2"',
        'model = "llama3-8b"\ntokenizer_json = "data/llama/tokenizer.json"',
        1)
    path = tmp_path / "llama.toml"
    path.write_text(text)
    argv = ["--config", str(path)]
    want, overrides = jax_resolve(argv, monkeypatch)
    got = tutoring_server.resolve_args(argv)
    assert got.model == want.model == "llama3-8b"
    ref = jax_config.engine_config(jax_config.load_config(str(path)))
    assert got.tokenizer_json == ref.tokenizer_json == (
        "data/llama/tokenizer.json")
    seen = {}

    def capture(config, **kw):
        seen.update(config=config, **kw)
        return "engine"

    monkeypatch.setattr(tutoring_server, "PagedEngine", capture)
    assert tutoring_server.engine_from_args(got) == "engine"
    config = seen["config"]
    assert (config.model, config.tokenizer_json) == (ref.model,
                                                     ref.tokenizer_json)
    assert (config.quant, config.kv_quant, seen["slots"]) == ("int8", True,
                                                              16)
    # an explicit flag still wins over the file
    flagged = tutoring_server.resolve_args(argv + ["--tokenizer-json",
                                                   "t.json"])
    assert flagged.tokenizer_json == "t.json"


@pytest.mark.parametrize("text,match", [
    ("[tutorin]\nmodel = 'tiny'\n", "unknown section"),
    ("[tutoring]\nslotz = 4\n", "slotz"),
    ("[scoring]\nenable = true\n", "enable"),
    ("[storage]\nfsyncc = 'never'\n", "fsyncc"),
    ("[cluster]\ndata_dirr = 'x'\n", "data_dirr"),
    ("[storage]\nfsync = 'on'\n", "fsync"),            # a bad value
    ("[tutoring_fleet]\nhealth_poll_s = 0\n", "health_poll_s"),
    ("[groups]\ncount = 0\n", "count"),
    ("[sim]\nseedz = 1\n", "seedz"),                   # not parsed by the port
    ("[telemetry]\nring_points = 1\n", "ring_points"),  # a bad value
])
def test_unknown_sections_and_keys_are_refused_by_both(text, match,
                                                       tmp_path):
    path = tmp_path / "bad.toml"
    path.write_text(text)
    for load in (jax_config.load_config, config.load_config):
        with pytest.raises(ValueError, match=match):
            load(str(path))


@pytest.mark.parametrize("name", sorted(FILES))
def test_both_deployment_files_load(name):
    cfg = config.load_config(FILES[name])
    ref = jax_config.load_config(FILES[name])
    for section in ("tutoring", "sampling", "scoring", "sessions",
                    "resilience", "tracing", "cluster", "tutoring_fleet",
                    "gate", "groups", "storage"):
        assert (vars(getattr(cfg, section))
                == vars(getattr(ref, section))), section


def test_dev_file_builds_the_paged_scoring_node():
    args = tutoring_server.resolve_args(
        ["--config", FILES["dev"], "--device", "cpu"])
    engine = tutoring_server.engine_from_args(args)
    assert isinstance(engine, PagedEngine)
    assert engine.config.model == "tiny" and engine.cfg.quant_kv
    assert engine.config.scoring and engine.score_shapes
    assert (engine.spec, engine.megastep_max, engine.prefill_chunk) == (
        4, 4, 16)
    assert engine.config.sampling.max_new_tokens == 32
    assert engine.config.sampling.temperature == 0.7
    assert engine.cfg.dtype == torch.float32


# ------------------------------------------------- timeline and watchdog


def _snapshots():
    """Cumulative snapshots of a node, one a second: counters rising (one
    reset, as after a restart), a gauge, a histogram."""
    counts = [0, 5, 12, 3, 10]
    return [{"counters": {"llm_requests": c, "scoring_quanta": 2 * i},
             "gauges": {"serving_queue_depth": float(i)},
             "latency": {"ttft": {"count": c, "p95_s": 0.1 * i}}}
            for i, c in enumerate(counts)]


def test_timeline_document_is_the_jax_timelines():
    port, ref = timeline.Timeline(max_points=4), jax_timeline.Timeline(
        max_points=4)
    for i, snap in enumerate(_snapshots()):
        port.append(snap, t=1000.0 + i)
        ref.append(snap, t=1000.0 + i)
    doc = port.to_dict()
    assert doc == ref.to_dict()
    assert len(doc["points"]) == 4  # the ring keeps the newest
    assert doc["points"][2]["rates"]["llm_requests"] == 3.0  # the reset
    back = jax_timeline.Timeline.from_dict(json.loads(json.dumps(doc)))
    assert back.counter_rate("llm_requests", 10.0, now=1004.0) == 5.5


def test_sampler_samples_and_stops():
    metrics = Metrics()
    sampler = timeline.TimelineSampler(metrics, interval_s=0.02).start()
    for i in range(10):
        metrics.inc("llm_requests")
        time.sleep(0.01)
    sampler.stop()
    assert sampler.samples >= 2 and sampler._thread is None
    assert len(sampler.timeline.points()) == sampler.samples
    with pytest.raises(ValueError):
        timeline.TimelineSampler(metrics, interval_s=0)


def test_watchdog_records_as_the_jax_one():
    snaps = []
    for make in (guards.make_serving_watchdog,
                 jax_guards.make_serving_watchdog):
        metrics = Metrics()
        dog = make(metrics, warn_above_s=0.25)
        for lag in (0.01, 0.3, -1.0, 0.5):
            dog.observe(lag)
        assert (dog.stalls, dog.max_lag_s) == (2, 0.5)
        snap = metrics.snapshot()
        snaps.append((snap["counters"], snap["latency"]))
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == {"serving_tick_stalls": 2}


@pytest.mark.parametrize("telemetry", [True, False])
def test_node_serves_its_timeline(telemetry):
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
        TutoringEngine,
    )

    engine = TutoringEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=4),
        dtype=torch.float32, param_dtype=torch.float32, device="cpu"))

    async def get(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), json.loads(body)

    async def run():
        server = await tutoring_server.serve_async(
            0, engine, host="127.0.0.1", metrics_port=0,
            telemetry=telemetry, telemetry_interval_s=0.05)
        try:
            await asyncio.sleep(0.12)  # the first sample seeds baselines
            await server._service.GetLLMAnswer(
                tutoring_server.lms_pb2.QueryRequest(query="raft?"), None)
            await asyncio.sleep(0.3)
            return await get(server._health.port, "/admin/timeline")
        finally:
            await server.stop(0)
            await server._queue.close()
            assert server._telemetry_sampler is None or (
                server._telemetry_sampler._thread is None)

    code, doc = asyncio.run(run())
    if not telemetry:
        assert code == 400 and "disabled" in doc["error"]
        return
    assert code == 200 and doc["ok"]
    points = doc["timeline"]["points"]
    assert len(points) >= 3
    assert sum(p["rates"].get("llm_requests", 0.0) for p in points) > 0
    assert any("serving_tick_lag" in p["hists"] for p in points)


def _lms_main_args(module, tracing, argv, monkeypatch):
    """An LMS server's `main(argv)` stopped at its `asyncio.run`: the
    resolved args (its tracer configuration is not applied)."""
    seen = {}

    def run(coro):
        seen["args"] = coro.cr_frame.f_locals["args"]
        coro.close()

    monkeypatch.setattr(module, "asyncio", type("A", (), {"run": run}))
    monkeypatch.setattr(tracing, "configure_from", lambda cfg: None)
    module.main(argv)
    return vars(seen["args"])


LMS_ARGVS = {
    "cluster": ["--config", FILES["cluster"], "--id", "3"],
    "dev": ["--config", FILES["dev"], "--id", "1"],
    "cluster-flags": ["--config", FILES["cluster"], "--id", "2",
                      "--tutoring", "127.0.0.1:6000", "--gate-threshold",
                      "0.6", "--gate-model", "tiny", "--snapshot-every", "8",
                      "--data-dir", "elsewhere", "--no-telemetry",
                      "--no-linearizable-reads", "--storage-fsync", "never",
                      "--metrics-port", "0"],
    "positional": ["1", "50051", "50051", "50052", "50053",
                   "--tutoring", "127.0.0.1:50054", "--gate-model", "tiny"],
}


@pytest.mark.parametrize("case", sorted(LMS_ARGVS))
def test_lms_server_resolves_what_the_jax_lms_server_resolves(case,
                                                              monkeypatch):
    from distributed_lms_raft_llm_tpu_torch.utils import tracing

    argv = LMS_ARGVS[case]
    want = _lms_main_args(jax_lms_server, jax_tracing, argv, monkeypatch)
    got = _lms_main_args(lms_server, tracing, argv, monkeypatch)
    assert want.pop("jax_platform") == "cpu"
    assert got.pop("device") == "cuda"  # the port's gate runs on the card
    assert got == want
    if case == "cluster-flags":
        assert (got["tutoring"], got["data_dir"], got["snapshot_every"],
                got["telemetry"], got["linearizable_reads"]) == (
            "127.0.0.1:6000", "elsewhere", 8, False, False)
    if case == "cluster":
        assert got["tutoring"] == ",".join(
            config.load_config(FILES["cluster"]).tutoring_fleet.addresses)
        assert got["gate_model"] == "bert-base-uncased"


def test_lms_server_refuses_more_than_one_group(tmp_path, monkeypatch):
    """Since the group router was ported, nothing refuses more than one
    group: `--groups 2`, and `[groups]` from the file, resolve to what the
    JAX LMS server's `main` resolves, and `serve_async` no longer raises
    before it builds the groups."""
    from distributed_lms_raft_llm_tpu_torch.serving import lms_cluster
    from distributed_lms_raft_llm_tpu_torch.utils import tracing

    path, _ = lms_cluster.deployment_copy(
        FILES["dev"], str(tmp_path), {("groups", "count"): 2,
                                      ("groups", "port_stride"): 517,
                                      ("groups", "secret"): "k"})
    for argv in (["--config", FILES["dev"], "--id", "1", "--groups", "2",
                  "--groups-secret", "s"],
                 ["--config", path, "--id", "1"]):
        want = _lms_main_args(jax_lms_server, jax_tracing, argv, monkeypatch)
        got = _lms_main_args(lms_server, tracing, argv, monkeypatch)
        want.pop("jax_platform"), got.pop("device")
        assert got == want and got["groups"] == 2
    assert (got["groups_port_stride"], got["groups_secret"]) == (517, "k")
    assert not hasattr(lms_server, "GROUPS_NOT_PORTED")


def test_raft_config_matches_jax():
    for name in FILES:
        got = config.raft_config(config.load_config(FILES[name]))
        want = jax_config.raft_config(jax_config.load_config(FILES[name]))
        assert vars(got) == vars(want)


def test_lms_server_gate_on_cuda_without_a_card_raises(tmp_path,
                                                       monkeypatch):
    """The LMS server builds its gate on the card by default; without one
    it raises instead of building the gate on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        lms_server.main(["1", "0", "0", "--gate-model", "tiny",
                         "--data-dir", str(tmp_path / "node1")])
