"""The port's program inventory against the JAX package's.

- The port's static domains equal the JAX package's for config.py's
  defaults, both configs/*.toml and a grid of engine options, key for key,
  but the megastep's (its stated difference: the chunk graphs per width).
- A warmed tiny port `PagedEngine` (fused + prefix cache, sequential +
  prefix cache, spec 8) holds exactly the manifest's key counts, passes
  `compile_count_guard(expected_from_inventory(eng))` around live traffic,
  and its counts equal a warmed JAX `PagedEngine`'s (whose own guard
  holds) for every program both count alike.
- Both drift directions raise: a width warmup skipped (at the first
  request that needs it) and a stale expectation; engines with no
  warmup-covered set are refused as the JAX package refuses them.
- The generator's --check holds on the tree and its scan finds every
  program site.
"""

import itertools
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu import config as jax_config
from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import program_inventory as jinv
from distributed_lms_raft_llm_tpu.utils import guards as jguards
from distributed_lms_raft_llm_tpu_torch import config as port_config
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    RelevanceGate,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.engine import GateConfig
from distributed_lms_raft_llm_tpu_torch.engine import program_inventory as inv
from distributed_lms_raft_llm_tpu_torch.engine.scoring import (
    derive_score_shapes,
)
from distributed_lms_raft_llm_tpu_torch.tools import gen_program_inventory
from distributed_lms_raft_llm_tpu_torch.utils.guards import (
    InventoryMismatchError,
    RecompileError,
    compile_count_guard,
    expected_from_inventory,
)

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ("k v", "a longer question about raft elections and logs",
           "a longer question about raft elections and logs, again")


def _port_megastep_keys(dom, fused):
    ladder_climbs = len(dom["k_ladder"]) > 1
    return len(dom["widths"]) * (2 if fused else 1) if (
        fused or ladder_climbs) else 0


def _assert_domains_equal(kw):
    port, jax_ = inv.static_paged_domain(**kw), jinv.static_paged_domain(**kw)
    assert port.keys() == jax_.keys()
    assert {k: v for k, v in port.items() if k != "megastep_pairs"} == {
        k: v for k, v in jax_.items() if k != "megastep_pairs"}
    assert port["megastep_pairs"] == _port_megastep_keys(
        port, kw.get("fused_prefill", False))


@pytest.mark.parametrize("spec,megastep_max",
                         list(itertools.product((0, 8), (0, 4, 6, 8))))
def test_static_paged_domain_is_the_jax_domain(spec, megastep_max):
    for prefix, fused, tp, ep in itertools.product(
            (False, True), (False, True), (1, 2), (1, 2)):
        for mpe, max_new, buckets in ((64, 8, (4, 16)),
                                      (1024, 128, (32, 64, 128, 256))):
            _assert_domains_equal(dict(
                max_position_embeddings=mpe, max_new_tokens=max_new,
                length_buckets=buckets, spec_tokens=spec,
                megastep_max=megastep_max, prefix_cache=prefix,
                prefix_block_tokens=4 if mpe == 64 else 16,
                fused_prefill=fused, tp=tp, ep=ep))


@pytest.mark.parametrize("path", [None, "configs/cluster.toml",
                                  "configs/dev.toml"])
def test_shipped_configs_domains_are_the_jax_domains(path):
    """Each shipped configuration through each package's engine_config, as
    both generators read them."""
    load = {port_config: port_config.load_config,
            jax_config: jax_config.load_config}
    got = {}
    for mod, loader in load.items():
        app = mod.AppConfig() if path is None else loader(str(REPO / path))
        ec = mod.engine_config(app)
        t = app.tutoring
        got[mod] = (ec, t, app.scoring.enabled)
    (ec, t, scoring), (jec, _, _) = got[port_config], got[jax_config]
    assert ec.model == jec.model and tuple(ec.length_buckets) == tuple(
        jec.length_buckets) and ec.batch_buckets == jec.batch_buckets
    mpe = 64 if ec.model == "tiny" else 1024
    _assert_domains_equal(dict(
        max_position_embeddings=mpe,
        max_new_tokens=ec.sampling.max_new_tokens,
        length_buckets=tuple(ec.length_buckets),
        spec_tokens=ec.spec_tokens,
        megastep_max=inv.effective_megastep_max(t.megastep, t.megastep_max),
        prefix_cache=t.prefix_cache,
        fused_prefill=t.prefill_chunk_tokens > 0, tp=ec.tp, ep=ec.ep))
    for sp in (1, 2, 4):
        args = (tuple(ec.length_buckets), tuple(ec.batch_buckets), mpe)
        port = inv.static_score_domain(*args, sp=sp, enabled=scoring)
        assert port == jinv.static_score_domain(*args, sp=sp,
                                                enabled=scoring)
        if scoring:
            assert port["pairs"] == derive_score_shapes(*args, sp=sp)


CONFIGS = {
    "fused_prefix": dict(prefix_cache=True, prefix_block_tokens=4,
                         prefill_chunk_tokens=4, megastep=2, megastep_max=4),
    "sequential_prefix": dict(prefix_cache=True, prefix_block_tokens=4,
                              megastep=2, megastep_max=4),
    "spec8": dict(spec_tokens=8),
}


def _engines(opts):
    opts = dict(opts)
    spec = opts.pop("spec_tokens", 0)
    common = dict(model="tiny", length_buckets=(4, 16), batch_buckets=(1, 2),
                  spec_tokens=spec)
    port = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=8), device="cpu",
        dtype=torch.float32, param_dtype=torch.float32, **common),
        slots=2, chunk=2, **opts)
    jax_ = JaxPaged(JaxConfig(
        sampling=JaxSampling.greedy(max_new_tokens=8), dtype=jnp.float32,
        **common), slots=2, chunk=2, **opts)
    return port, jax_


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warmed_engine_holds_the_manifest_and_the_jax_counts(name):
    eng, jeng = _engines(CONFIGS[name])
    eng.warmup()
    expectation = expected_from_inventory(eng)
    assert expectation.mismatches() == {}
    with compile_count_guard(expectation) as guard:
        eng.submit(PROMPTS[0])
        eng.step()
        for p in PROMPTS[1:]:
            eng.submit(p)
        answers = eng.drain()
    assert guard.new_compiles() == 0 and guard.counter_deltas() == {}
    assert len(answers) == len(PROMPTS)
    jeng.warmup()
    jexpect = jguards.expected_from_inventory(jeng)
    assert jexpect.mismatches() == {}
    shared = set(expectation.expected) & set(jexpect.expected) - {
        "_megastep"}
    assert shared == set(jexpect.expected) - {"_megastep"}
    assert {k: expectation.expected[k] for k in shared} == {
        k: jexpect.expected[k] for k in shared}
    assert expectation.expected["_megastep"] == (
        len(eng.widths) * (2 if eng.fused else 1)
        if eng.fused or len(eng.megastep_ks) > 1 else 0)


def _sequential(buckets=(4, 16)):
    return PagedEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=8),
        length_buckets=buckets, batch_buckets=(1, 2), device="cpu",
        dtype=torch.float32, param_dtype=torch.float32), slots=2, chunk=2)


def test_skipped_width_raises_at_the_first_request_that_needs_it():
    eng = _sequential(buckets=(4, 16, 32))
    widths = eng.widths
    eng.widths = widths[:-1]  # warmup skips the widest width
    eng.warmup()
    eng.widths = widths
    programs = list(eng.programs.values())
    with compile_count_guard(*programs):
        for p in ("k v", "why raft?"):  # 3 and 9 byte ids: the warmed widths
            eng.submit(p)
        eng.drain()
    with pytest.raises(RecompileError, match="new program key"):
        with compile_count_guard(*programs):
            eng.submit(" ".join(PROMPTS))
            eng.drain()


def test_unwarmed_engine_and_stale_expectation_fail_the_guard():
    eng = _sequential()
    with pytest.raises(RecompileError):
        with compile_count_guard(expected_from_inventory(eng)):
            eng.submit("hello")
            eng.drain()
    eng.warmup()
    expectation = expected_from_inventory(eng)
    expectation.expected["_step"] += 1  # a stale manifest claim
    with pytest.raises(InventoryMismatchError, match="stale"):
        with compile_count_guard(expectation):
            pass


def test_engines_without_a_warmup_set_are_refused():
    cfg = dict(model="tiny", sampling=SamplingParams.greedy(max_new_tokens=4),
               length_buckets=(8,), batch_buckets=(1,), device="cpu",
               dtype=torch.float32, param_dtype=torch.float32)
    with pytest.raises(InventoryMismatchError, match="warmup-covered"):
        expected_from_inventory(TutoringEngine(EngineConfig(**cfg)))
    gate = RelevanceGate(GateConfig(model="tiny", dtype=torch.float32,
                                    device="cpu"))
    with pytest.raises(InventoryMismatchError, match="no warmup-covered"):
        expected_from_inventory(gate)
    eng = TutoringEngine(EngineConfig(scoring=True, **cfg))
    eng.warmup(batch=1)
    expectation = expected_from_inventory(eng)
    assert expectation.expected == {"_score": len(eng.score_shapes)}
    with compile_count_guard(expectation):
        eng.score(["one text", "another text to score"])


def test_generator_check_and_scan_find_every_program_site():
    assert gen_program_inventory.main(["--check"]) == 0
    sites = {(s.engine, s.name) for s in gen_program_inventory.scanned_sites()}
    assert sites == set(gen_program_inventory.CLASSIFICATION)
    assert {e.attr for e in inv.entries_for("PagedEngine")} == {
        e.attr for e in jinv.entries_for("PagedEngine")}
