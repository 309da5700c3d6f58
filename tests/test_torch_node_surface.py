"""The rest of the port's tutoring-node surface: approximate top-k, strict
dispatch and the periodic metrics line, against the JAX package.

- Approximate top-k. The JAX package computes it with
  `jax.lax.approx_max_k`, an approximate algorithm for the TPU. On this
  machine's JAX (0.9, CPU backend) `approx_max_k` returns exactly
  `jax.lax.top_k`'s values, and its indices too, but for one case: k = 1
  over tied maxima, where it names another of the tied maxima (checked
  here on 200 random rows and 50 tied rows, k = 1, 5, 50). So the JAX
  package's CPU reference is the exact top-k up to the order of ties, and
  the port computes the exact top-k for `approx_top_k=True`.
  The port's draws with it are held against the distribution the JAX
  package's approximate path leaves (top-k by `approx_max_k`, then top-p,
  softmax): 40k draws, each frequency within 0.012 (about five standard
  errors). With the same generator the port draws the same tokens with
  and without it.
- Strict dispatch (`utils/guards.py`). Without a card it is a documented
  no-op that warns once, as the JAX package's does on its CPU backend. The
  per-thread verdict is held with the card's part faked (`_cuda` true,
  `torch.cuda.set_sync_debug_mode` recorded, torch's sync warning raised
  as torch raises it, on the syncing thread): inside `strict_dispatch()`
  an unmarked sync raises `HostSyncError`, one inside
  `intended_transfer()` does not, another thread's does not, and the
  mode goes back to `default` when the last scope closes.
- `_report_metrics` logs one `metrics {json}` line a period, the JAX
  node's line for the same snapshot; `serve_async` runs it as
  `server._metrics_task` and `stop()` ends it.
"""

import asyncio
import logging
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import sampling as jax_sampling
from distributed_lms_raft_llm_tpu.serving import tutoring_server as jax_server
from distributed_lms_raft_llm_tpu.utils import guards as jax_guards
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch.engine import sampling
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils import guards
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

V = 64


def test_jax_approx_max_k_is_exact_on_the_cpu():
    rng = np.random.default_rng(0)
    smooth = rng.standard_normal((200, V)).astype(np.float32)
    tied = (rng.integers(0, 6, size=(50, V)) * 0.5).astype(np.float32)
    for x in (smooth, tied):
        for k in (1, 5, 50):
            av, ai = jax.lax.approx_max_k(jnp.asarray(x), k)
            tv, ti = jax.lax.top_k(jnp.asarray(x), k)
            av, ai, tv, ti = map(np.asarray, (av, ai, tv, ti))
            np.testing.assert_array_equal(av, tv)
            if x is smooth or k > 1:
                np.testing.assert_array_equal(ai, ti)
            else:
                # k = 1 among tied maxima: another maximum's index.
                assert (x[np.arange(len(x)), ai[:, 0]] == tv[:, 0]).all()
                assert (ai != ti).any()


@pytest.mark.parametrize("top_k,top_p", [(5, 0.9), (10, 1.0), (50, 0.8)])
def test_approx_topk_draws_follow_the_jax_approx_distribution(top_k, top_p):
    rng = np.random.default_rng(7)
    row = rng.standard_normal(V).astype(np.float32) * 2.0
    temperature, penalty = 0.7, 1.2
    seen = np.zeros((1, V), bool)
    seen[0, :8] = True
    # The JAX package's approximate path, as `sample_step` runs it.
    logits = jax_sampling.apply_repetition_penalty(
        jnp.asarray(row[None]), jnp.asarray(seen), penalty) / temperature
    top_vals, top_idx = jax.lax.approx_max_k(logits, top_k)
    if top_p < 1.0:
        probs = jax.nn.softmax(top_vals, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        top_vals = jnp.where((cum - probs) > top_p, jax_sampling.NEG_INF,
                             top_vals)
    want = np.zeros(V)
    want[np.asarray(top_idx)[0]] = np.asarray(jax.nn.softmax(top_vals))[0]

    params = sampling.SamplingParams(temperature=temperature, top_k=top_k,
                                     top_p=top_p, repetition_penalty=penalty,
                                     approx_top_k=True)
    n = 40_000
    args = (torch.from_numpy(np.repeat(row[None], n, axis=0)),
            torch.from_numpy(np.repeat(seen, n, axis=0)))
    draws = sampling.sample_step(torch.Generator().manual_seed(1), *args,
                                 params).numpy()
    freq = np.bincount(draws, minlength=V) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want > 0))
    np.testing.assert_allclose(freq, want, atol=0.012)
    exact = sampling.sample_step(
        torch.Generator().manual_seed(1), *args,
        sampling.SamplingParams(temperature=temperature, top_k=top_k,
                                top_p=top_p, repetition_penalty=penalty))
    np.testing.assert_array_equal(draws, exact.numpy())


# ------------------------------------------------------- strict dispatch


def test_strict_dispatch_without_a_card_warns_once_and_does_nothing(
        monkeypatch, caplog):
    monkeypatch.setattr(guards, "_warned_cpu_noop", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", calls.append)
    with caplog.at_level(logging.WARNING, logger=guards.__name__):
        with guards.strict_dispatch():
            with guards.intended_transfer():
                pass
        with guards.strict_dispatch():
            pass
        guards.enable_strict_dispatch()
    noop = [r for r in caplog.records if "no-op" in r.getMessage()]
    assert len(noop) == 1 and "no-host-sync-in-dispatch" in noop[0].message
    assert calls == [] and guards._process_strict is False
    assert guards._open_scopes == 0
    # The JAX package's guard warns once on its CPU backend as well.
    monkeypatch.setattr(jax_guards, "_warned_cpu_noop", False)
    with caplog.at_level(logging.WARNING, logger=jax_guards.__name__):
        caplog.clear()
        with jax_guards.strict_dispatch():
            pass
        with jax_guards.strict_dispatch():
            pass
    assert sum("no-op" in r.getMessage() for r in caplog.records) == 1


def _sync():
    """What torch does on a host sync in `warn` mode: a UserWarning on the
    syncing thread."""
    warnings.warn(f"{guards.SYNC_WARNING} (Triggered internally at "
                  f"CUDAFunctions.cpp)", UserWarning)


def test_strict_dispatch_verdict_is_per_thread(monkeypatch):
    modes = []
    monkeypatch.setattr(guards, "_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    _sync()  # no strict scope anywhere: torch's mode is off, nothing raises
    with guards.strict_dispatch():
        assert modes == ["warn"]
        with pytest.raises(guards.HostSyncError, match="intended_transfer"):
            _sync()
        with guards.intended_transfer():
            _sync()  # sanctioned: dropped
            with guards.intended_transfer():
                _sync()
        with pytest.raises(guards.HostSyncError):
            _sync()  # the block ended
        other = {}

        def elsewhere():
            try:
                _sync()
                other["ok"] = True
            except guards.HostSyncError as e:
                other["error"] = e

        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
        assert other == {"ok": True}  # a thread outside every scope
        with guards.strict_dispatch():  # nested scopes on one thread
            with pytest.raises(guards.HostSyncError):
                _sync()
        warnings.warn("an unrelated warning", UserWarning)
    assert modes[-1] == "default" and guards._open_scopes == 0
    _sync()  # no strict scope anywhere again: dropped by the hook
    # What reached the previous hook: the sync before the hook was in
    # place (torch would not warn then: its mode was off) and the
    # unrelated warning.
    assert shown == [f"{guards.SYNC_WARNING} (Triggered internally at "
                     f"CUDAFunctions.cpp)", "an unrelated warning"]


def test_enable_strict_dispatch_holds_every_thread(monkeypatch):
    monkeypatch.setattr(guards, "_cuda", lambda: True)
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(guards, "_process_strict", False)
    guards.enable_strict_dispatch()
    try:
        seen = {}

        def elsewhere():
            try:
                _sync()
            except guards.HostSyncError:
                seen["raised"] = True
            with guards.intended_transfer():
                _sync()
                seen["marked"] = True

        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
        assert seen == {"raised": True, "marked": True}
        assert modes == ["warn"]
    finally:
        guards._process_strict = False
        with guards._lock:
            guards._apply_mode()
    assert modes[-1] == "default"


# ---------------------------------------------------- the metrics line


def _log_lines(module, metrics, periods, monkeypatch, caplog):
    slept = []

    async def sleep(s):
        slept.append(s)
        if len(slept) > periods:
            raise asyncio.CancelledError

    monkeypatch.setattr(module.asyncio, "sleep", sleep)
    with caplog.at_level(logging.INFO):
        caplog.clear()
        with pytest.raises(asyncio.CancelledError):
            asyncio.run(module._report_metrics(metrics, 30.0))
    monkeypatch.undo()
    return slept, [r.getMessage() for r in caplog.records
                   if r.getMessage().startswith("metrics ")]


def test_report_metrics_logs_one_line_a_period_as_jax(monkeypatch, caplog):
    got_m, want_m = Metrics(), JaxMetrics()
    for m in (got_m, want_m):
        m.inc("llm_requests", 3)
        m.set_gauge("serving_queue_depth", 2.0)
    slept, got = _log_lines(tutoring_server, got_m, 3, monkeypatch, caplog)
    assert slept == [30.0] * 4 and len(got) == 3
    _, want = _log_lines(jax_server, want_m, 3, monkeypatch, caplog)
    assert got == want


def test_serve_async_runs_and_stops_the_metrics_task():
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        TutoringEngine,
    )

    engine = TutoringEngine(EngineConfig(
        model="tiny", sampling=sampling.SamplingParams.greedy(
            max_new_tokens=4), dtype=torch.float32,
        param_dtype=torch.float32, device="cpu"))

    async def run():
        server = await tutoring_server.serve_async(
            0, engine, host="127.0.0.1", telemetry=False,
            metrics_period_s=0.01)
        task = server._metrics_task
        await asyncio.sleep(0.05)
        running = not task.done()
        await server.stop(0)
        await server._queue.close()
        return running, task.cancelled()

    assert asyncio.run(run()) == (True, True)
