"""The port's tools against the JAX package's: `gpt2_config_from_hf`,
`config.engine_config`/`sampling_params`, the metrics registry's rendering
half and its README block, and `tools/trace_report` (waterfall and --diff)
and `tools/telemetry --capacity` against the JAX scripts on the same saved
JSON, which the test writes from a seed.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (caps torch's threads)
import transformers
from test_timeline import _capacity_export, _load_script

from distributed_lms_raft_llm_tpu import config as jax_config
from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.utils import metrics_registry as jax_registry
from distributed_lms_raft_llm_tpu_torch import config as port_config
from distributed_lms_raft_llm_tpu_torch.models import convert
from distributed_lms_raft_llm_tpu_torch.tools import (
    gen_metrics_table,
    telemetry,
    trace_report,
)
from distributed_lms_raft_llm_tpu_torch.utils import metrics_registry

REPO = Path(__file__).resolve().parent.parent


def test_gpt2_config_from_hf_is_the_jax_mapping():
    hf = transformers.GPT2Config(vocab_size=211, n_positions=64, n_embd=48,
                                 n_layer=3, n_head=4).to_dict()
    got, want = convert.gpt2_config_from_hf(hf), jax_convert.gpt2_config_from_hf(hf)
    for name in ("vocab_size", "max_position_embeddings", "hidden_size",
                 "num_layers", "num_heads", "layer_norm_eps"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("path", [None, "configs/cluster.toml",
                                  "configs/dev.toml"])
def test_engine_config_is_the_jax_engine_config(path):
    apps = [mod.AppConfig() if path is None
            else mod.load_config(str(REPO / path))
            for mod in (port_config, jax_config)]
    assert dataclasses.asdict(port_config.sampling_params(apps[0])) == (
        dataclasses.asdict(jax_config.sampling_params(apps[1])))
    got, want = (port_config.engine_config(apps[0]),
                 jax_config.engine_config(apps[1]))
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)}
              - {"dtype", "param_dtype", "sampling"})
    assert {"model", "checkpoint", "tp", "ep", "quant", "kv_quant",
            "spec_tokens", "draft_source", "scoring"} <= shared
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name


def test_metrics_table_renders_the_registry_into_its_readme_block():
    assert gen_metrics_table.main(["--check"]) == 0
    text = (REPO / "README.md").read_text()
    assert gen_metrics_table.rendered_block() in text
    assert "<!-- metrics-table:begin -->" not in gen_metrics_table.BEGIN
    # The JAX registry's names, kinds and help, but scoring_utilization's,
    # whose JAX text quotes a TPU ceiling.
    for m in metrics_registry.all_metrics():
        assert metrics_registry.spec(m.name) == m
        want = jax_registry.spec(m.name)
        assert m.kind == want.kind, m.name
        assert (m.help == want.help) != (m.name == "scoring_utilization")
    with pytest.raises(ValueError, match="declared twice"):
        metrics_registry.counter("llm_requests", "again")


def _seeded_trace(seed):
    """Two fragments of one trace: the LMS side (a root and its children)
    and the tutoring side, whose root's parent is a span of the first."""
    rng = np.random.default_rng(seed)
    t0 = 1.7e9 + float(rng.uniform(0, 10))

    def span(name, sid, parent, start, children=()):
        return {"name": name, "span_id": sid, "parent_id": parent,
                "start_s": start, "duration_s": float(rng.uniform(0.001, 0.3)),
                "status": "ok" if rng.uniform() > 0.2 else "error",
                "attrs": {"n": int(rng.integers(0, 9))},
                "children": list(children)}

    lms = span("lms.GetLLMAnswer", "a1", "", t0, [
        span("gate.check", "a2", "a1", t0 + 0.01),
        span("tutoring.forward", "a3", "a1", t0 + 0.05)])
    tut = span("tutoring.GetLLMAnswer", "b1", "a3", t0 + 0.06, [
        span("queue.wait", "b2", "b1", t0 + 0.061),
        span("engine.batch", "b3", "b1", t0 + 0.09)])
    return ({"trace": {"trace_id": "r1", "route": "ask", "flags": ["slow"],
                       "spans": [lms]}},
            {"trace": {"trace_id": "r1", "route": "ask", "flags": [],
                       "spans": [tut]}})


def _run(mod, argv, capsys):
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def test_trace_report_waterfall_and_diff_equal_the_jax_script(tmp_path,
                                                              capsys):
    jax_report = _load_script("trace_report")
    paths = []
    for i, doc in enumerate(_seeded_trace(7)):
        paths.append(tmp_path / f"frag{i}.json")
        paths[-1].write_text(json.dumps(doc))
    argv = ["--json", str(paths[0]), "--json", str(paths[1]), "r1"]
    port = _run(trace_report, argv, capsys)
    assert port == _run(jax_report, argv, capsys)
    assert "tutoring.GetLLMAnswer" in port and "queue.wait" in port
    bare = tmp_path / "after.json"
    bare.write_text(json.dumps({"engine.batch": {"count": 3, "p95_s": 0.2},
                                "queue.wait": {"count": 3, "p95_s": 0.01}}))
    for a in (paths[1], bare):
        argv = ["--diff", str(a), str(bare)]
        assert _run(trace_report, argv, capsys) == _run(jax_report, argv,
                                                        capsys)


def test_telemetry_capacity_equals_the_jax_fit(tmp_path, capsys):
    jax_telemetry = _load_script("telemetry")
    for kw in ({}, {"saturate": False, "tokens": False}):
        doc = _capacity_export(**kw)
        want = jax_telemetry.fit_capacity(doc, slo_p95_s=6.0,
                                          ceiling_tokens_per_s=1000.0)
        assert telemetry.fit_capacity(
            doc, slo_p95_s=6.0, ceiling_tokens_per_s=1000.0) == want
    path = tmp_path / "timeline.json"
    path.write_text(json.dumps(_capacity_export()))
    argv = ["--capacity", str(path), "--slo-p95", "6.0"]
    model = json.loads(_run(telemetry, argv + ["--ceiling", "1000"], capsys))
    assert model.pop("ceiling_source") == "--ceiling"
    assert model == json.loads(json.dumps(jax_telemetry.fit_capacity(
        _capacity_export(), slo_p95_s=6.0, ceiling_tokens_per_s=1000.0)))
    bare = json.loads(_run(telemetry, argv, capsys))
    assert bare["ceiling_source"] is None and bare["utilization"] is None
    assert bare["value"] == model["value"]
    cfg = json.loads(_run(telemetry, argv + [
        "--config", str(REPO / "configs/cluster.toml")], capsys))
    assert cfg["ceiling_source"].endswith(
        "[telemetry] chip_ceiling_tokens_per_s")
