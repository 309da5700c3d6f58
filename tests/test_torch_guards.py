"""The port's compile-count guard (utils/guards.py): the JAX package's
tests/test_guards.py cases over the port's engine programs, and the card's
three first-use counters (graph captures, kernel builds, layout
validations) read through fakes on the CPU.
"""

import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine import graphs
from distributed_lms_raft_llm_tpu_torch.ops import attention, build, quant_matmul
from distributed_lms_raft_llm_tpu_torch.utils import guards
from distributed_lms_raft_llm_tpu_torch.utils.guards import (
    RecompileError,
    compile_count_guard,
)


def _engine():
    return PagedEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=4),
        length_buckets=(4, 16), batch_buckets=(1, 2), device="cpu",
        dtype=torch.float32, param_dtype=torch.float32), slots=2, chunk=2)


@pytest.fixture(scope="module")
def warm():
    eng = _engine()
    eng.warmup()
    return eng


def test_compile_count_guard_passes_when_warm(warm):
    with compile_count_guard(warm.programs["_prefill"],
                             warm.programs["_step"]) as guard:
        warm.submit("k v")
        warm.submit("k w")  # the same bucket and width: warmed keys
        warm.drain()
    assert guard.new_compiles() == 0 and guard.counter_deltas() == {}


def test_compile_count_guard_catches_a_new_key():
    eng = _engine()  # no warmup
    with pytest.raises(RecompileError, match="1 new program key"):
        with compile_count_guard(eng.programs["_prefill"],
                                 what="a new bucket"):
            eng.submit("k v")
            eng.drain()


def test_compile_count_guard_allowance_and_several_programs():
    eng = _engine()
    programs = [eng.programs[n] for n in ("_prefill", "_install", "_step")]
    with compile_count_guard(*programs, allow=3) as guard:
        eng.submit("k v")
        eng.drain()
    assert guard.new_compiles() == 3
    assert set(guard.grown()) == {"PagedEngine._prefill",
                                  "PagedEngine._install", "PagedEngine._step"}


def test_compile_count_guard_rejects_a_non_program():
    with pytest.raises(TypeError, match="not an engine program"):
        with compile_count_guard(lambda x: x):
            pass


@pytest.mark.parametrize("module,attr,counter", [
    (graphs, "captures", "captures"),
    (build, "builds", "builds"),
    (attention, "layouts_validated", "layouts"),
    (quant_matmul, "layouts_validated", "layouts"),
])
def test_each_card_counter_rise_raises(monkeypatch, warm, module, attr,
                                       counter):
    monkeypatch.setattr(module, attr, getattr(module, attr))
    with compile_count_guard(warm.programs["_step"]):
        pass  # no rise: passes
    with pytest.raises(RecompileError, match=rf"{counter} \+1"):
        with compile_count_guard(warm.programs["_step"], allow=5):
            setattr(module, attr, getattr(module, attr) + 1)


def test_layout_count_is_monotonic_through_the_cache_clear(monkeypatch):
    """300 distinct layouts through each wrapper's cache, which clears at
    256 entries: the count rises by 300, the cache stays bounded, and a
    layout validated again after the clear counts again."""
    for module in (attention, quant_matmul):
        monkeypatch.setattr(module, "_layouts", {})
        monkeypatch.setattr(module, "layouts_validated", 0)
        with pytest.raises(RecompileError, match=r"layouts \+301"):
            with compile_count_guard():
                for i in range(300):
                    module._remember_layout(("fake", i), object())
                assert len(module._layouts) <= module._MAX_LAYOUTS
                assert ("fake", 0) not in module._layouts
                module._remember_layout(("fake", 0), object())
        assert module.layouts_validated == 301


def test_a_counter_the_guard_cannot_read_raises(monkeypatch):
    monkeypatch.setitem(guards.CARD_COUNTERS, "builds", (
        ("distributed_lms_raft_llm_tpu_torch.ops.build", "no_such_count"),))
    with pytest.raises(RecompileError, match="cannot read the builds"):
        with compile_count_guard():
            pass
    monkeypatch.setattr(build, "builds", None)
    monkeypatch.setitem(guards.CARD_COUNTERS, "builds", (
        ("distributed_lms_raft_llm_tpu_torch.ops.build", "builds"),))
    with pytest.raises(RecompileError, match="not a count"):
        with compile_count_guard():
            pass
