#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out FILE] [--checkpoint F --vocab F --merges F]
                          [--gate-checkpoint F --gate-vocab F]

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (`nvidia-smi` name and power limit) and the torch build;
2. build every kernel of the port from this checkout's sources;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the tutoring path gives it (batch 1-8 x windows 33, 320, 384,
   GPT-2's full 1024, GQA, rows padded to their last slot, a window of a
   larger cache, q strided as the model passes it), with the launch plan
   (`n_split`), kernel, eager-call, plain-version and library-call times
   beside the least time the card could take;
3b. the paged path's kernels the same way: decode attention with per-row
   lengths over a float and an int8 cache (8 and 16 slots, widths 160 and
   384, lengths spread over [1, width], splits left empty), and the int8
   weight-only matmul (`ops/sweep_int8.py`) at GPT-2 small's five products
   for M = 1, 16, 32 (the fused admission chunk), 256 in bf16 (tensor
   cores) and float32 (CUDA cores), and the four dense products at the
   relevance gate's M = 128 and 1,024 in bf16,
   timed over more than 100 MB of distinct weight copies so the L2 cannot
   serve them, plus the 49 products of one decode model call and the 48 of
   one int8 gate forward at M = 128 and 1,024;
4. the bucketed path: `BatchingQueue` -> `TutoringEngine` (GPT-2 small at
   full width, bf16, seeded random weights unless a checkpoint is given)
   answering 8 concurrent tutoring questions, greedy twice and once with
   the reference sampling defaults; the kernels' launch counters must show
   that the path ran through them; greedy tokens of the kernel path must
   equal the plain path's in float32; one more greedy device batch runs
   under `torch.profiler` (device busy share, kernel time by name);
4b. the production path: `PagedQueue` -> `PagedEngine` (GPT-2 small at full
   width, bf16, int8 weights, int8 KV cache, 16 slots, chunk 16, inflight
   3) answering 24 questions in two waves, the second landing mid-decode
   (admission mid-decode, the cache widening), greedy twice (equal
   answers) and once with the reference sampling defaults; int8-KV
   attention launches = 12 x decode model calls, int8 matmul launches =
   49 x model calls, all on the tensor-core route (48 dense and one
   unembedding a model call); tokens/s, mean TTFT, and a `torch.profiler` window
   (device busy share); then the paged engine in float32 with int8 weights,
   with an int8 and with a dense cache, kernel-path greedy tokens equal to
   the plain attention path's;
4c. the deployment config (configs/cluster.toml's tutoring node, its
   speculative decoding left out there): the production path above plus megastep 4
   (controller ceiling 8) as CUDA-graph replays, fused staged admission at
   32 prompt tokens an iteration and the radix prefix cache at 512 blocks,
   answering two waves: one course prompt (a long shared course context)
   with the 12 bare questions, then, once that prompt's blocks are in the
   radix tree, the other 7 course prompts and 4 exact repeats of wave-1
   questions; tokens/s, mean TTFT, graph replays and host decisions per
   generated token, the final K and dead lanes, stalled tokens (0), prefix
   hits (the shared context spliced into all 7 later course slots),
   launches by route counted through the replays (int8-KV attention = 12 x
   decode model calls, int8 matmul = 49 x model calls, admission chunks
   included, all on the tensor cores; each graph's kernel nodes equal its
   counted launches at capture), and a `torch.profiler` window beside
   phase 4b's, holding no more of the port's kernels than counted; then
   float32 (dense and int8 cache) greedy tokens of the
   deployment config equal to the sequential config's, prefix hits
   included (in bf16 the share that agrees and the first divergences are
   reported, and each prompt's flip logits through the 32-token admission
   chunks are held against the cold prefill's and a float32 reference's),
   and bf16 graph replays at K=4 equal to the eager chunk loop, greedy and
   seeded-sampled;
5. gRPC on 127.0.0.1 (`serve_async`), under a tokenizer that decodes each
   of GPT-2's 50,257 ids to non-empty text (the given --vocab/--merges,
   the trained BPE where data/gpt2-local is present, else a byte-level
   vocabulary of that size built from the seed; the record names it), so
   a dropped or wrong token shows in the answer: one `GetLLMAnswer` on the
   bucketed engine equal to the engine's direct answer in text (non-empty)
   and in generated tokens; then, on the deployment config of phase 4c,
   8 concurrent `StreamLLMAnswer` calls and the same 8 queries over
   `GetLLMAnswer`: each stream gap-free, equal to the unary answer and to
   the engine's direct answer, its digest the sha256 of the stripped
   answer, its token count the direct answer's; resumes at offset 2 and
   at half the answer for two of them (exactly the token suffix, the same
   digest); launches through the replays as in 4c; host dispatches per
   token of the 8 prompts as watched streams at most 1.1x their unwatched
   run's (both through a fresh `PagedQueue` that holds all 8 before it
   starts, so the admissions match; the gRPC runs' ratios are reported);
   then, on the same config at 8 new tokens, a session whose turn 2
   (framed with FOLLOWUP_TEMPLATE over turn 1's transcript) admits with a
   prefix hit of turn 1's whole blocks (`session_active` 1,
   `session_pinned_blocks` > 0), and a drain (POST /admin/drain: both RPCs
   UNAVAILABLE, /healthz draining; undrained, an answer again; /metrics
   with stream_chunks, ttft, session_active); no CUDA graph captured
   while serving;
6. the relevance gate (`RelevanceGate`, configs/cluster.toml [gate]) at
   bert-base-uncased width (12 layers, 768 wide, vocabulary 30,522, 512
   positions, buckets 64-512, threshold 0.6), from seeded random weights
   under the byte tokenizer unless --gate-checkpoint/--gate-vocab are
   given (the record names which), in float32, bf16 and bf16 with int8
   weights: phase 4's 8 questions against an assignment text sized for
   each length bucket, one past the 512 positions and an empty one, all
   through each gate (int8 matmul launches = 48 x forwards, all on the
   tensor cores; none for the others; no attention kernel); bf16
   similarities within 2e-2 of float32's with equal decisions wherever
   float32's is further than that from 0.6, int8's within 0.05; a cache
   hit within 1e-5 of the joint miss in float32 (2e-2 in bf16); the
   float32 gate's embeddings within 1e-4 of their scale of a float64
   forward on the CPU (no TF32; the error under TF32 is reported beside);
   `check` latency p50 over 20 calls per bucket, miss and hit, the first
   check after warmup(), and a `torch.profiler` window of misses at
   buckets 64 and 512 (kernels per forward, device busy share), beside
   phase 5's TTFT over the stream;
7. speculative decoding (configs/cluster.toml [tutoring] with its
   commented-out spec_tokens = 8, prompt lookup): (a) the decode-attention
   kernel's window variant (T = k+1 query rows a row, each with its own
   causal frontier) against its plain version, row by row (each query
   row's error against its own largest output) and with two planted
   frontier faults that must fail that check, at T = 2 and 9, int8 and
   bf16 caches, widths 384 and 640, ragged frontiers one of which reaches
   the width, with its µs, bound and SDPA over a [B, 1, T, S] mask
   beside; (b) the bucketed engine with spec 8 (the kernel against its
   plain version first at this engine's rows and cache width with its
   padding bias, bf16 and float32; window launches = 12 x verify windows;
   float32 tokens equal the plain decoder's) and the float32 deployment
   with spec 8 equal to phase 4c's float32 deployment on its 24 requests,
   24 of 24; (c) the bf16 deployment with spec 8 (the kernel against its
   plain version first at each of its cache widths, 16 slots, T = 9, int8
   cache), through `PagedQueue` on 4c's two waves:
   tokens/s, TTFT, spec_tokens_per_window, spec_accepted_tokens, model
   calls per token, kernels and device ms per verify model call, the
   drain's busy share, answers beside 4c's (first divergences with their
   top-2 margins), window launches = 12 x verify model calls through the
   replays, no other attention variant, no capture while serving; (d) the
   n-gram drafter under the reference sampling (every answer non-empty,
   acceptance); (e) the server built from --spec-tokens 8, and 4 unary
   answers and 4 streams over gRPC equal to the engine's direct answers
   under phase 5's tokenizer.

The last two lines of standard output are the `kernels` JSON record and
the `{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "distributed_lms_raft_llm_tpu_torch"

H100_HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TF32
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}
QUESTIONS = [
    "What is a binary search tree?",
    "How does Raft elect a leader?",
    "Explain the difference between a process and a thread.",
    "Why is quicksort O(n log n) on average?",
    "What does a hash table trade for constant-time lookup?",
    "How do I find a cycle in a linked list?",
    "What is dynamic programming?",
    "When should I use a heap instead of a sorted array?",
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields, sort_keys=True)}", flush=True)


# ------------------------------------------------- decode attention


def attention_case(torch, attention, *, b, h, hkv, s, dh=64, n_layers=12,
                   layer=7, dtype="bfloat16", pad=None, s_alloc=None,
                   strided_q=False, seed=0):
    """Kernel vs plain version (and SDPA as a yardstick) at one shape.

    pad: per-row left padding (ragged mask); s_alloc: the cache holds
    s_alloc slots and the kernel reads a window of the first s; strided_q:
    q is a view of a [B, 1, 3*H*Dh] projection split into heads, as the
    model passes it. Returns the case record; raises if the kernel
    disagrees."""
    import torch.nn.functional as F

    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_alloc = s_alloc or s
    shape = (n_layers, b, hkv, s_alloc, dh)
    if strided_q:
        qkv = torch.randn((b, 1, 3 * h * dh), generator=gen,
                          device=dev).to(dt)
        q = qkv[..., :h * dh].reshape(b, 1, h, dh).transpose(1, 2)
    else:
        q = torch.randn((b, h, 1, dh), generator=gen, device=dev).to(dt)
    k_full = torch.randn(shape, generator=gen, device=dev).to(dt)
    v_full = torch.randn(shape, generator=gen, device=dev).to(dt)
    k_cache, v_cache = k_full[:, :, :, :s], v_full[:, :, :, :s]
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=dev)
    if pad is not None:
        for row, p in enumerate(pad):
            mask[row, ..., :p] = False
    bias = attention.mask_to_bias(mask)

    got = attention.decode_attention(q, k_cache, v_cache, layer, bias)
    want = attention.decode_attention_reference(q, k_cache, v_cache, layer,
                                                bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOLERANCE[dtype],
          f"decode_attention disagrees with its plain version: max abs "
          f"err {err} > {TOLERANCE[dtype]} (b={b} h={h} hkv={hkv} s={s} "
          f"{dtype})")
    es = torch.finfo(dt).bits // 8
    n_bytes = (2 * b * hkv * s * dh * es      # K and V of the layer
               + 2 * b * h * dh * es          # q in, out
               + b * s * 4)                   # bias
    n_ops = 4 * b * h * s * dh                # q.K and p.V multiply-adds
    bound_us = max(n_bytes / H100_HBM_BYTES_PER_S,
                   n_ops / PEAK_OPS_PER_S[dtype]) * 1e6
    plan = attention.launch_plan(b, hkv, s, dh, dt, group=h // hkv)
    rec = dict(b=b, h=h, hkv=hkv, s=s, s_alloc=s_alloc, dh=dh,
               dtype=dtype, layer=layer, ragged=pad is not None,
               padded_rows=sum(1 for p in pad or () if p),
               strided_q=strided_q, n_split=plan.n_split,
               split_keys=plan.split_keys, tile_keys=plan.tile_keys,
               max_abs_err=err, bound_us=bound_us,
               bound_by="bytes" if n_bytes / H100_HBM_BYTES_PER_S
               >= n_ops / PEAK_OPS_PER_S[dtype] else "operations")

    # Consecutive calls walk the layers, so each reads K/V that the last
    # call did not (the decode step streams other weights in between).
    def kernel(i):
        attention.decode_attention(q, k_cache, v_cache, i % n_layers, bias)

    def plain(i):
        attention.decode_attention_reference(q, k_cache, v_cache,
                                             i % n_layers, bias)

    sdpa_mask = bias[:, :, None, :].to(dt)

    def library(i):
        F.scaled_dot_product_attention(q, k_cache[i % n_layers],
                                       v_cache[i % n_layers],
                                       attn_mask=sdpa_mask)

    rec.update(
        kernel_us=time_graph_us(kernel),
        kernel_eager_us=time_eager_us(kernel),
        plain_us=time_graph_us(plain),
        library_us=time_graph_us(library) if h == hkv else None,
    )
    return rec


# ----------------------------------------------- paged-path kernels


def paged_attention_case(torch, attention, *, s, width, int8, s_alloc=384,
                         dtype="bfloat16", h=12, dh=64, n_layers=12,
                         lengths=None, seed=0):
    """The paged decode step's attention: `s` slots, a window of `width`
    slots of an `s_alloc`-slot cache, per-row lengths (spread over [1,
    width] unless given), no bias, q strided, a float or int8 cache.
    Kernel vs plain; SDPA with a boolean mask over the cache (dequantized
    beforehand, untimed, for int8) as the yardstick."""
    import torch.nn.functional as F

    from distributed_lms_raft_llm_tpu_torch.models.common import quantize_kv
    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((s, 1, 3 * h * dh), generator=gen, device=dev).to(dt)
    q = qkv[..., :h * dh].reshape(s, 1, h, dh).transpose(1, 2)
    shape = (n_layers, s, h, s_alloc, dh)
    kf = torch.randn(shape, generator=gen, device=dev)
    vf = torch.randn(shape, generator=gen, device=dev)
    scales = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        scales = dict(k_scale=ks[..., :width], v_scale=vs[..., :width])
        kd = (k.float() * ks[..., None]).to(dt)[:, :, :, :width]
        vd = (v.float() * vs[..., None]).to(dt)[:, :, :, :width]
    else:
        k, v = kf.to(dt), vf.to(dt)
        kd, vd = k[:, :, :, :width], v[:, :, :, :width]
    del kf, vf
    k, v = k[:, :, :, :width], v[:, :, :, :width]
    if lengths is None:
        lengths = torch.randint(1, width + 1, (s,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 1, width
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)

    got = attention.decode_attention(q, k, v, 5, None, lengths=lengths,
                                     **scales)
    want = attention.decode_attention_reference(
        q, k, v, 5, None, lengths, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # Relative to the output's magnitude where dequantized values pass 1.
    tol = TOLERANCE[dtype] * max(1.0, want.float().abs().max().item())
    check(math.isfinite(err) and err <= tol,
          f"paged decode_attention (int8={int8}) disagrees with its plain "
          f"version: max abs err {err} > {tol} (s={s} width={width} "
          f"{dtype})")
    keys = int(lengths.sum().item())  # the keys this data needs
    es = torch.finfo(dt).bits // 8
    kv_bytes = (2 * h * keys * dh) * (1 if int8 else es)
    n_bytes = (kv_bytes + (2 * 4 * h * keys if int8 else 0)
               + 2 * s * h * dh * es + 4 * s)
    n_ops = 4 * h * keys * dh
    t_bytes, t_ops = (n_bytes / H100_HBM_BYTES_PER_S,
                      n_ops / PEAK_OPS_PER_S[dtype])
    plan = attention.launch_plan(s, h, width, dh, k.dtype)
    rec = dict(slots=s, width=width, s_alloc=s_alloc, int8=int8,
               dtype=dtype, lengths_min=int(lengths.min().item()),
               lengths_max=int(lengths.max().item()), keys=keys,
               n_split=plan.n_split, split_keys=plan.split_keys,
               tile_keys=plan.tile_keys, max_abs_err=err, tolerance=tol,
               bound_us=max(t_bytes, t_ops) * 1e6,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    mask = (torch.arange(width, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]

    def kernel(i):
        attention.decode_attention(q, k, v, i % n_layers, None,
                                   lengths=lengths, **scales)

    def plain(i):
        attention.decode_attention_reference(
            q, k, v, i % n_layers, None, lengths, scales.get("k_scale"),
            scales.get("v_scale"))

    def library(i):  # over the dequantized cache (int8): a yardstick
        F.scaled_dot_product_attention(q, kd[i % n_layers], vd[i % n_layers],
                                       attn_mask=mask)

    rec.update(kernel_us=time_graph_us(kernel),
               kernel_eager_us=time_eager_us(kernel),
               plain_us=time_graph_us(plain),
               library_us=time_graph_us(library),
               library_note="SDPA, boolean mask" + (
                   " over the cache dequantized beforehand (untimed)"
                   if int8 else ""))
    return rec


# ------------------------------------------------- production path

# A second wave of questions beside QUESTIONS: 24 requests in all.
MORE_QUESTIONS = [
    "What is the difference between TCP and UDP?",
    "How does garbage collection work?",
    "Explain recursion with an example.",
    "What is a deadlock?",
]


def paged_waves():
    """Wave 1: 12 bare questions (prompt buckets 32 and 64, cache widths
    160 and 192); wave 2: 12 framed prompts (bucket 256, width 384), so
    their admission widens the live cache mid-decode."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    questions = QUESTIONS + MORE_QUESTIONS
    return questions, [PROMPT_TEMPLATE.format(query=q) for q in questions]


# Phase 4c's wave 2: framed questions behind one shared course context
# (with the template's head, over 200 tokens of the byte tokenizer), all
# inside the 256-token prompt bucket.
COURSE_CONTEXT = ("Distributed systems, CS 451 notes, week 6: Raft keeps a "
                  "replicated log; a leader wins a term by a majority of "
                  "votes.\n")
COURSE_QUESTIONS = [
    "What is a term?", "Why a majority of votes?",
    "What makes a log entry committed?", "How do followers reject a leader?",
    "What is a heartbeat?", "When does an election start?",
    "What happens on a split vote?", "Why must terms only grow?",
]


def deployment_waves():
    """Phase 4c's traffic (24 requests): wave 1 is the first course
    question framed behind COURSE_CONTEXT, then phase 4b's 12 bare
    questions; wave 2 is the other 7 course questions, then 4 exact
    repeats of bare wave-1 questions. Wave 2 is sent once the first course
    prompt's blocks are in the radix tree (see `run_paged_waves`), so the
    course context is prefilled once and spliced into 7 staged slots."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    bare, _ = paged_waves()
    course = [COURSE_CONTEXT + PROMPT_TEMPLATE.format(query=q)
              for q in COURSE_QUESTIONS]
    return course[:1] + bare, course[1:] + bare[:4]


def engine_tokens(engine, *batches):
    """Submit each batch of prompts at once and drain it before the next;
    return each request's generated token ids in submit order."""
    out = []
    for prompts in batches:
        reqs = []
        for p in prompts:
            engine.submit(p)
            reqs.append(engine._pending[-1])
        engine.drain()
        out += [list(r.tokens) for r in reqs]
    return out


def first_divergence(a, b):
    """Index of the first differing token of two token lists (None if
    equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def run_paged_waves(engine, paged_queue_cls, metrics_cls, wave1, wave2,
                    ready=None):
    """Wave 1 through one PagedQueue; wave 2 submitted once `ready()` is
    true (default: the engine has dispatched wave 1's first decode step).
    Returns (answers in submit order, wall seconds, the queue's metrics
    snapshot)."""
    metrics = metrics_cls()
    if ready is None:
        steps0 = engine.decode_steps

        def ready():
            return engine.decode_steps != steps0

    async def go():
        queue = paged_queue_cls(engine, metrics=metrics)
        await queue.start()
        try:
            first = [asyncio.ensure_future(queue.submit(p)) for p in wave1]
            while not ready():
                await asyncio.sleep(0.002)
            second = [asyncio.ensure_future(queue.submit(p)) for p in wave2]
            return await asyncio.gather(*first, *second)
        finally:
            await queue.close()

    t0 = time.monotonic()
    answers = asyncio.run(go())
    return answers, time.monotonic() - t0, metrics.snapshot()


def device_events(torch, prof):
    """(name, µs) of every device event of a finished `torch.profiler`
    window, read from the raw trace: building the profiler's Python event
    tree costs minutes at a million kernels (a drain of phase 4c)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda]


def counted_launches() -> dict:
    """The launch counters summed per route (`engine.graphs.ROUTES`)."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts)
    from distributed_lms_raft_llm_tpu_torch.ops import attention, quant_matmul

    return routes_of_counts({**attention.launch_counts,
                             **quant_matmul.launch_counts})


def check_traced_launches(events, before: dict, what: str) -> dict:
    """The port's kernels the profiler saw on the card, counted by name,
    against the launch counters' deltas over the same window. The trace
    holds no more of them than were counted (a launch the counters missed
    fails here); it may hold fewer, since the profiler on the card loses
    kernel records (`ops/probe_trace_loss.py`), so the shortfall is
    reported as the trace's loss. What a replay adds to the counters is
    held exactly against the graph's kernel nodes at capture
    (`engine/graphs.py`)."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_names)

    names: dict = {}
    for name, _ in events:
        names[name] = names.get(name, 0) + 1
    traced = routes_of_names(names)
    after = counted_launches()
    counted = {route: after[route] - before[route] for route in after}
    check(all(traced[r] <= counted[r] for r in counted),
          f"{what}: the profiler trace holds more of the port's kernels "
          f"{traced} than the launch counters counted {counted}")
    return {"traced": traced,
            "lost": {r: counted[r] - traced[r] for r in counted}}


def profile_paged(torch, engine, prompts, steps=2) -> dict:
    """Where a steady paged step's time goes: the slots filled, the
    pipeline full, `steps` step() calls timed without the profiler, then
    `steps` more under `torch.profiler`. Device busy share = summed kernel
    time over the unprofiled wall of the same number of steps."""
    from torch.profiler import ProfilerActivity, profile

    def calls():
        return (engine.decode_steps + engine.prefill_calls
                + engine.admission_chunks)

    for p in prompts:
        engine.submit(p)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    calls0 = calls()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    wall_calls = calls() - calls0
    calls0, replays0 = calls(), engine.graph_replays
    counted0 = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    model_calls, replays = calls() - calls0, engine.graph_replays - replays0
    events = device_events(torch, prof)
    traced = check_traced_launches(events, counted0, "profile window")
    engine.drain()
    by_name: dict = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())

    def of(*parts):
        hits = [v for name, v in by_name.items()
                if any(part in name for part in parts)]
        return sum(us for us, _ in hits), sum(n for _, n in hits)

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "steps": steps, "chunk": engine.chunk, "slots": engine.slots,
        "wall_us": wall_us, "profiled_wall_us": profiled_wall_us,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_launched": sum(n for _, n in by_name.values()),
        "model_calls": model_calls, "model_calls_unprofiled": wall_calls,
        "graph_replays": replays, "traced_launches": traced,
        "launches_per_model_call": (sum(n for _, n in by_name.values())
                                    / max(model_calls, 1)),
        # the tensor-core kernels (int8_mma_*) and the CUDA-core ones
        "int8_matmul_us_launches": of("int8_mma", "int8_matmul"),
        "decode_attention_us_launches": of("decode_attention"),
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def profile_drain(torch, engine, prompts) -> dict:
    """Device busy share over a whole workload: `prompts` submitted at once
    and drained, first without the profiler (the wall), then again under
    `torch.profiler` (the device time). Greedy decoding and the prefix
    tree cleared before each run make the two runs the same work; model
    calls are counted in both to show it."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        if engine.prefix_cache is not None:
            engine.prefix_cache.clear()
        c0 = (engine.decode_steps + engine.prefill_calls
              + engine.admission_chunks, engine.graph_replays,
              engine.host_decisions, engine.total_generated_tokens)
        for p in prompts:
            engine.submit(p)
        engine.drain()
        torch.cuda.synchronize()
        return (engine.decode_steps + engine.prefill_calls
                + engine.admission_chunks - c0[0],
                engine.graph_replays - c0[1], engine.host_decisions - c0[2],
                engine.total_generated_tokens - c0[3])

    t0 = time.monotonic()
    calls, replays, decisions, tokens = run()
    wall_us = (time.monotonic() - t0) * 1e6
    counted0 = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        calls_p, _, _, _ = run()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    events = device_events(torch, prof)
    traced = check_traced_launches(events, counted0, "profiled drain")
    busy_us, launched = 0.0, 0
    for _, us in events:
        busy_us += us
        launched += 1
    return {"requests": len(prompts), "tokens": tokens,
            "wall_us": wall_us, "profiled_wall_us": profiled_wall_us,
            "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "model_calls": calls, "model_calls_profiled": calls_p,
            "model_calls_per_token": calls / max(tokens, 1),
            "graph_replays": replays, "host_decisions": decisions,
            "kernels_launched": launched, "traced_launches": traced,
            "launches_per_model_call": launched / max(calls_p, 1)}


def paged_f32_check(torch, attention, engine_cls, config_cls, sampling_cls,
                    common, prompts, kv_quant) -> dict:
    """float32, int8 weights, an int8 (`kv_quant`) or a dense cache: the
    greedy tokens with attention through the kernel equal those through
    the plain attention path, request by request. The kernel run's
    launches of its variant are counted from zero."""
    import torch as _torch

    tokens = {}
    launches = steps = 0
    for fused in (True, False):
        eng = engine_cls(config_cls(
            dtype=_torch.float32, param_dtype=_torch.float32, quant="int8",
            kv_quant=kv_quant, fused_attention=fused,
            sampling=sampling_cls.greedy(max_new_tokens=32), **common),
            slots=16, chunk=16, inflight=3, cuda_graphs=False)
        finished = []
        decode = eng.tokenizer.decode
        eng.tokenizer.decode = lambda toks, _d=decode: (
            finished.append(list(toks)) or _d(toks))
        attention.reset_launch_counts()
        steps0 = eng.decode_steps
        for p in prompts:
            eng.submit(p)
        eng.drain()
        tokens[fused] = finished
        if fused:
            variant = attention.INT8KV if kv_quant else attention.RAGGED
            launches = attention.launch_counts[variant]
            steps = eng.decode_steps - steps0
            check(steps > 0 and launches == eng.cfg.num_layers * steps,
                  f"f32 paged run (kv_quant={kv_quant}): {variant} "
                  f"launches {launches} != {eng.cfg.num_layers} x {steps}")
        del eng
    check(tokens[True] == tokens[False] and len(tokens[True]) == len(prompts),
          f"float32 paged greedy tokens differ between the kernel and the "
          f"plain attention paths (kv_quant={kv_quant})")
    return {"kv_quant": kv_quant, "equal": True, "requests": len(prompts),
            "tokens": sum(len(t) for t in tokens[True]),
            "launches": launches, "decode_steps": steps}


# ------------------------------------------------------- main path


def run_queue(engine, prompts, batching_queue_cls):
    """8 concurrent submits through one BatchingQueue; returns (answers,
    seconds)."""

    async def go():
        queue = batching_queue_cls(engine, max_batch=len(prompts),
                                   max_wait_ms=100.0)
        await queue.start()
        try:
            return await asyncio.gather(*[queue.submit(p) for p in prompts])
        finally:
            await queue.close()

    t0 = time.monotonic()
    answers = asyncio.run(go())
    return answers, time.monotonic() - t0


def profile_generate(torch, engine, prompts) -> dict:
    """Where one device batch's time goes: `torch.profiler` over one
    `generate_ids` call. Device busy share = summed kernel time (one
    stream, so kernels do not overlap) over the wall time of the same call
    run without the profiler, whose host overhead would inflate the wall;
    kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    ids, mask, _ = engine.encode_prompts(prompts)
    engine.generate_ids(ids, mask)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.generate_ids(ids, mask)
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    steps0 = engine.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_ids(ids, mask)
        torch.cuda.synchronize()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    by_name: dict = {}
    for name, us in device_events(torch, prof):
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())

    def launches_of(part):
        return sum(n for name, (_, n) in by_name.items() if part in name)

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "wall_us": wall_us,
        "profiled_wall_us": profiled_wall_us,
        "decode_steps": engine.decode_steps - steps0,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_launched": sum(n for _, n in by_name.values()),
        "direct_copy_launches": launches_of("direct_copy_kernel"),
        "decode_attention_launches": launches_of("decode_attention"),
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def phase5_tokenizer(args, directory: Path) -> tuple:
    """(vocab path, merges path, record) of phase 5's tokenizer, under
    which a random-weight GPT-2's sampled ids show in the text: the given
    --vocab/--merges, else the deployment's trained BPE where
    data/gpt2-local is present, else a full byte-level vocabulary of
    GPT-2's 50,257 ids built from the seed (the byte fallback would drop
    every id >= 256 and leave empty answers to compare)."""
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        BPETokenizer, full_byte_vocab)

    local = REPO / "data" / "gpt2-local"
    if args.vocab and args.merges:
        vocab, merges, which = args.vocab, args.merges, "--vocab/--merges"
    elif (local / "vocab.json").exists() and (local / "merges.txt").exists():
        vocab, merges = str(local / "vocab.json"), str(local / "merges.txt")
        which = "trained BPE, data/gpt2-local"
    else:
        vocab, merges = str(directory / "vocab.json"), str(
            directory / "merges.txt")
        Path(vocab).write_text(json.dumps(full_byte_vocab(50257, args.seed)))
        Path(merges).write_text("#version: 0.2\n")
        which = (f"full byte-level vocabulary from seed {args.seed} (no "
                 f"merges)")
    tok = BPETokenizer.from_files(vocab, merges)
    nonempty = sum(1 for i in range(50257) if tok.decode([i]))
    return vocab, merges, dict(tokenizer=which, vocab_size=tok.vocab_size,
                               ids_decoding_nonempty=nonempty)


def grpc_round_trip(engine, prompt_template) -> dict:
    """One GetLLMAnswer through the port's server on 127.0.0.1, held to the
    engine's direct answer: the same non-empty text and the same number of
    generated tokens (a dropped or extra token changes either)."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
        serve_async,
    )

    query = QUESTIONS[0]
    tok = engine.tokenizer
    ids, mask, _ = engine.encode_prompts([prompt_template.format(query=query)])
    res = engine.generate_ids(ids, mask)
    n = int(res.lengths[0])
    toks = [t for t in res.tokens[0, :n].tolist() if t != tok.eos_id]
    direct = tok.decode(toks).strip()

    async def go():
        server = await serve_async(0, engine, host="127.0.0.1",
                                   node_id="chip-smoke")
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server._port}") as channel:
                stub = rpc.TutoringStub(channel)
                call = stub.GetLLMAnswer(lms_pb2.QueryRequest(query=query),
                                         timeout=300)
                resp = await call
                trailer = dict(list(await call.trailing_metadata()))
            return resp, trailer
        finally:
            await server.stop(1)
            await server._queue.close()

    tok0 = engine.total_generated_tokens
    resp, trailer = asyncio.run(go())
    served = engine.total_generated_tokens - tok0
    check(resp.success and resp.response != "",
          "gRPC GetLLMAnswer returned no answer text")
    check(resp.response == direct and served == n,
          f"gRPC GetLLMAnswer differs from the engine's direct answer "
          f"({served} tokens served, {n} direct)")
    # The comparison can fail: the direct answer less one token that
    # decodes to text reads differently (under the byte-level vocabulary
    # every id does; a trained vocabulary smaller than the model's leaves
    # some ids empty, which the token count catches).
    k = next((i for i, t in enumerate(toks) if tok.decode([t])), None)
    check(k is not None
          and tok.decode(toks[:k] + toks[k + 1:]) != tok.decode(toks),
          "dropping a token leaves the answer's text unchanged")
    check(trailer.get("x-served-by") == "chip-smoke",
          "x-served-by trailer missing")
    return {"success": resp.success, "chars": len(resp.response),
            "tokens": n}


async def http_json(port: int, method: str, path: str, payload=None):
    """(status, JSON body) of one request to a health plane."""
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


def stream_contract(chunks, start: int = 0) -> str:
    """Offsets monotone and gap-free from `start`, one final chunk, every
    chunk a success; returns the assembled text."""
    check(bool(chunks), "a stream yielded nothing")
    delivered = start
    for ch in chunks:
        check(ch.success and ch.offset == delivered,
              f"stream chunk at offset {ch.offset} after {delivered} "
              f"delivered (success {ch.success})")
        delivered += ch.count
    check([c.final for c in chunks].count(True) == 1 and chunks[-1].final,
          "a stream did not end in exactly one final chunk")
    return "".join(c.text for c in chunks)


def streaming_phase(torch, attention, quant_matmul, engine_cls, config_cls,
                    sampling_cls, prod, vocab, merges) -> dict:
    """Phase 5b: StreamLLMAnswer on the deployment config (phase 4c's) over
    gRPC on 127.0.0.1, under phase 5's tokenizer (see the module
    docstring)."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.engine import PagedQueue, graphs
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        FOLLOWUP_TEMPLATE, PROMPT_TEMPLATE)
    from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
        serve_async)
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    conf = dict(prod, vocab_path=vocab, merges_path=merges)
    eng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=128), **conf),
        **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and cfg.quant_kv
          and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.vocab_size == 50257 and cfg.dtype == torch.bfloat16
          and eng.widths == [160, 192, 256, 384],
          f"streaming: not the deployment configuration: {cfg}")
    warm_s = eng.warmup()
    tok = eng.tokenizer
    queries = list(QUESTIONS)
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in queries]
    # The engine's direct answers (no server), token ids included.
    rids = [eng.submit(p) for p in prompts]
    for rid in rids:
        eng.stream_watch(rid)
    eng.drain()
    finals = eng.pop_final_tokens()
    direct = [finals[r] for r in rids]
    check(all(direct), "streaming: an empty direct answer")
    captures0 = graphs.captures

    async def serve(body, **kw):
        server = await serve_async(0, eng, host="127.0.0.1",
                                   node_id="chip-smoke-stream", **kw)
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server._port}") as channel:
                return await body(rpc.TutoringStub(channel), server)
        finally:
            await server.stop(1)
            await server._queue.close()

    def gauge(server, name):
        return server._queue.metrics.snapshot()["gauges"].get(name)

    async def unary_run(stub, server):
        t0 = time.monotonic()
        resps = await asyncio.gather(*[stub.GetLLMAnswer(
            lms_pb2.QueryRequest(query=q), timeout=300) for q in queries])
        return (resps, time.monotonic() - t0,
                gauge(server, "host_dispatches_per_token"))

    async def one_stream(stub, query, **kw):
        t0 = time.monotonic()
        chunks, first = [], None
        async for ch in stub.StreamLLMAnswer(
                lms_pb2.StreamRequest(query=query, **kw), timeout=300):
            if first is None:
                first = time.monotonic() - t0
            chunks.append(ch)
        return chunks, first

    async def stream_run(stub, server):
        t0 = time.monotonic()
        streams = await asyncio.gather(*[one_stream(stub, q)
                                         for q in queries])
        wall = time.monotonic() - t0
        hdpt = gauge(server, "host_dispatches_per_token")
        snap = server._queue.metrics.snapshot()
        resumed = []
        for i in (0, 3):
            n = len(direct[i])
            for k in (2, n // 2):
                chunks, _ = await one_stream(stub, queries[i],
                                             resume_offset=k)
                resumed.append((i, k, chunks))
        return streams, wall, hdpt, snap, resumed

    async def queue_run(watched):
        """The 8 prompts through a fresh PagedQueue, all in its inbox
        before its runner starts (the same admissions either way), as
        watched streams or as plain submissions: the queue's host
        dispatches per generated token."""
        eng.reset()  # the megastep controller's K back to its start
        eng.pop_dispatch_stats()  # counts left by earlier work
        metrics = Metrics()
        queue = PagedQueue(eng, metrics=metrics)

        async def consume(prompt):
            return [d async for d in queue.submit_stream(prompt)][-1]

        tasks = [asyncio.ensure_future(consume(p) if watched
                                       else queue.submit(p))
                 for p in prompts]
        await asyncio.sleep(0)
        decisions0, tokens0 = eng.host_decisions, eng.total_generated_tokens
        await queue.start()
        try:
            await asyncio.gather(*tasks)
        finally:
            await queue.close()
        return (metrics.snapshot()["gauges"]["host_dispatches_per_token"],
                (eng.host_decisions - decisions0)
                / (eng.total_generated_tokens - tokens0))

    hdpt_unwatched, decisions_unwatched = asyncio.run(queue_run(False))
    hdpt_watched, decisions_watched = asyncio.run(queue_run(True))
    eng.reset()
    eng.pop_dispatch_stats()
    resps, unary_wall, hdpt_unwatched_grpc = asyncio.run(serve(unary_run))
    eng.reset()
    eng.pop_dispatch_stats()
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
    streams, stream_wall, hdpt_watched_grpc, snap, resumed = asyncio.run(
        serve(stream_run))
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    decode_calls = eng.decode_steps - c0[0]
    model_calls = decode_calls + eng.admission_chunks - c0[1] + (
        eng.prefill_calls - c0[2])
    for i, ((chunks, _), resp) in enumerate(zip(streams, resps)):
        text = tok.decode(direct[i])
        full = stream_contract(chunks)
        check(resp.success and resp.response and full.strip()
              == resp.response == text.strip(),
              f"streaming: stream {i} != unary != direct answer")
        check(chunks[-1].offset + chunks[-1].count == len(direct[i]),
              f"streaming: stream {i} counted "
              f"{chunks[-1].offset + chunks[-1].count} tokens, the direct "
              f"answer {len(direct[i])}")
        check(chunks[-1].digest == hashlib.sha256(
            full.strip().encode()).hexdigest(),
            f"streaming: stream {i}'s digest is not the answer's sha256")
    for i, k, chunks in resumed:
        tail = stream_contract(chunks, start=k)
        want = tok.decode(direct[i])
        check(tail == want[len(tok.decode(direct[i][:k])):]
              and chunks[-1].digest == streams[i][0][-1].digest,
              f"streaming: resume of stream {i} at {k} is not the token "
              f"suffix under the same digest")
    check(decode_calls > 0
          and launches[attention.INT8KV] == cfg.num_layers * decode_calls
          and launches[quant_matmul.KERNEL] == 49 * model_calls
          and launches[quant_matmul.MMA_UNEMBED] == model_calls,
          f"streaming: kernel launches {launches} for {decode_calls} decode "
          f"and {model_calls} model calls")
    check(hdpt_watched <= 1.1 * hdpt_unwatched,
          f"streaming: host dispatches per token {hdpt_watched} watched, "
          f"{hdpt_unwatched} unwatched")
    chunk_counts = [len(c) for c, _ in streams]
    ttfts = [f for _, f in streams]
    run = dict(
        tokens=sum(len(d) for d in direct), warmup_s=warm_s,
        unary_wall_s=unary_wall, stream_wall_s=stream_wall,
        stream_ttft_s=ttfts, stream_ttft_mean_s=sum(ttfts) / len(ttfts),
        engine_ttft_mean_s=snap["latency"]["ttft"]["mean_s"],
        chunks_per_answer=chunk_counts,
        chunks_per_answer_mean=sum(chunk_counts) / len(chunk_counts),
        first_chunk_tokens=[c[0].count for c, _ in streams],
        host_dispatches_per_token_watched=hdpt_watched,
        host_dispatches_per_token_unwatched=hdpt_unwatched,
        host_decisions_per_token_watched=decisions_watched,
        host_decisions_per_token_unwatched=decisions_unwatched,
        host_dispatches_per_token_grpc_streams=hdpt_watched_grpc,
        host_dispatches_per_token_grpc_unary=hdpt_unwatched_grpc,
        resumes=[(i, k, len(c)) for i, k, c in resumed],
        decode_model_calls=decode_calls, model_calls=model_calls,
        launches=launches)
    del eng
    torch.cuda.empty_cache()

    # A session on the same config at 8 new tokens: turn 2's prompt holds
    # turn 1's answer as text, which the byte-level vocabulary re-encodes
    # into about six ids a token (random bytes, invalid UTF-8 replaced);
    # a 128-token answer would overflow the 256-id prompt bucket, whose
    # tail is kept, and lose turn 1's head.
    seng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=8), **conf), **deploy_kw)
    seng.warmup()
    captures1 = graphs.captures
    q1, q2 = QUESTIONS[1], "Why does that matter?"

    async def session_and_drain(stub, server):
        hport = server._health.port
        one, _ = await one_stream(stub, q1, session_id="chip-smoke")
        full1 = stream_contract(one)
        hits0 = (await http_json(hport, "GET", "/metrics"))[1][
            "counters"].get("prefix_cache_hit_tokens", 0)
        two, _ = await one_stream(stub, q2, session_id="chip-smoke")
        stream_contract(two)
        metrics = (await http_json(hport, "GET", "/metrics"))[1]
        transcript = server._service._sessions["chip-smoke"][0]
        drained = await http_json(hport, "POST", "/admin/drain",
                                  {"drain": True})
        health = (await http_json(hport, "GET", "/healthz"))[1]
        codes = []
        for call in (lambda: stub.GetLLMAnswer(
                         lms_pb2.QueryRequest(query=q1), timeout=60),
                     lambda: stub.StreamLLMAnswer(
                         lms_pb2.StreamRequest(query=q1), timeout=60).read()):
            try:
                await call()
                codes.append("OK")
            except grpc.aio.AioRpcError as e:
                codes.append(e.code().name)
        await http_json(hport, "POST", "/admin/drain", {"drain": False})
        again = await stub.GetLLMAnswer(lms_pb2.QueryRequest(query=q1),
                                        timeout=300)
        final_metrics = (await http_json(hport, "GET", "/metrics"))[1]
        return (full1, hits0, metrics, transcript, drained, health, codes,
                again, final_metrics)

    (full1, hits0, metrics, transcript, drained, health, codes, again,
     final_metrics) = asyncio.run(serve_session(serve_async, seng,
                                                session_and_drain))
    prompt1 = PROMPT_TEMPLATE.format(query=q1)
    prompt2 = prompt1 + full1 + FOLLOWUP_TEMPLATE.format(query=q2)
    ids1, ids2 = tok.encode(prompt1), tok.encode(prompt2)
    check(len(ids2) <= seng.bucket,
          f"session: turn 2's prompt ({len(ids2)} ids) overflows the "
          f"{seng.bucket}-id bucket")
    blk = seng.prefix_cache.block_tokens
    want_hits = len(os.path.commonprefix([ids1, ids2])) // blk * blk
    hits = metrics["counters"].get("prefix_cache_hit_tokens", 0) - hits0
    gauges = metrics["gauges"]
    check(transcript.startswith(prompt2),
          "session: turn 2 was not framed over turn 1's transcript")
    check(want_hits > 0 and hits >= want_hits,
          f"session: turn 2 admitted with {hits} prefix-hit tokens, turn "
          f"1's whole blocks are {want_hits}")
    check(gauges.get("session_active") == 1.0
          and gauges.get("session_pinned_blocks", 0) > 0,
          f"session: gauges {gauges}")
    check(drained[0] == 200 and drained[1]["draining"] is True
          and health["draining"] is True
          and codes == ["UNAVAILABLE", "UNAVAILABLE"],
          f"drain: {drained}, healthz {health}, RPC codes {codes}")
    check(again.success and again.response != "",
          "drain: no answer after the drain ended")
    check(final_metrics["counters"].get("stream_chunks", 0) > 0
          and "ttft" in final_metrics["latency"]
          and "session_active" in final_metrics["gauges"],
          f"/metrics lacks stream_chunks, ttft or session_active: "
          f"{sorted(final_metrics['counters'])}")
    check(graphs.captures == captures1 and captures1 - captures0
          == len(seng._graphs) * 2,
          f"streaming: CUDA graphs captured while serving "
          f"({graphs.captures} captures)")
    run.update(
        session=dict(turn2_prefix_hit_tokens=hits,
                     turn1_whole_block_tokens=want_hits,
                     turn2_prompt_ids=len(ids2),
                     session_active=gauges.get("session_active"),
                     session_pinned_blocks=gauges.get(
                         "session_pinned_blocks")),
        drain=dict(rpc_codes=codes, healthz_draining=health["draining"],
                   answered_after=again.success),
        graph_captures_while_serving=graphs.captures - captures1)
    del seng
    torch.cuda.empty_cache()
    return run


async def serve_session(serve_async, engine, body):
    """`body(stub, server)` against a server with its health plane."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.proto import rpc

    server = await serve_async(0, engine, host="127.0.0.1", metrics_port=0,
                               node_id="chip-smoke-session")
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{server._port}") as channel:
            return await body(rpc.TutoringStub(channel), server)
    finally:
        await server.stop(1)
        await server._queue.close()


def flip_logits_witness(torch, eng, prompts, factor=2.0) -> dict:
    """The fused admission's flip against the cold prefill, in bf16 on an
    idle engine's weights: each prompt's last-position logits through
    `prefill_chunk`-token admission chunks (`_admission_chunk`'s forward:
    M=32 int8 products on the tensor cores, the cache row chosen by
    `rows`, the pad tail masked out of the cache writes) and through one
    cold prefill of its bucket (`_prefill_program`'s forward), each held
    against the cold prefill in float32 on the same int8 weights (the
    CUDA-core int8 route). Holds: the admission route's largest error is
    at most `factor` x the cold route's (a wrong admission-chunk tile
    would err far above the cold route's own bf16 rounding)."""
    import dataclasses

    from distributed_lms_raft_llm_tpu_torch.engine.generate import pick_bucket

    def to_f32(x):
        if isinstance(x, dict):
            return {k: to_f32(v) for k, v in x.items()}
        return x.float() if torch.is_floating_point(x) else x

    cfg, model, c, dev = eng.cfg, eng.family, eng.prefill_chunk, eng.device
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    params32 = to_f32(eng.params)
    per_prompt = []
    with torch.inference_mode():
        for p in prompts:
            toks = eng.tokenizer.encode(p)[-eng.bucket:]  # as submit() cuts
            tl = len(toks)
            bucket = min(pick_bucket(tl, eng.config.length_buckets),
                         eng.bucket)
            width = eng._required_width(tl)
            row = torch.full((1, width), eng.tokenizer.pad_id,
                             dtype=torch.long, device=dev)
            row[0, :tl] = torch.tensor(toks, device=dev)
            steps = torch.arange(bucket, device=dev)

            def cold(params, cfg_):
                kv = model.init_cache(cfg_, 1, bucket, device=dev)
                logits, _ = model.forward(
                    params, cfg_, row[:, :bucket], cache=kv,
                    positions=torch.clamp(steps, max=tl - 1)[None, :],
                    kv_mask=(steps < tl)[None, :])
                return logits[0, tl - 1].float()

            want, got_cold = cold(params32, cfg32), cold(eng.params, cfg)
            kv = model.init_cache(cfg, 1, width, device=dev)
            first_row = torch.zeros((1,), dtype=torch.long, device=dev)
            for cur in range(0, tl, c):
                q = cur + torch.arange(c, device=dev)
                logits, _ = model.forward(
                    eng.params, cfg,
                    row[:, torch.clamp(q, max=width - 1)],
                    cache=dataclasses.replace(
                        kv, lengths=torch.tensor([cur], dtype=torch.int32,
                                                 device=dev),
                        rows=first_row),
                    positions=torch.clamp(torch.minimum(q, torch.tensor(
                        tl - 1, device=dev)), min=0)[None, :],
                    write_mask=((q < tl) & (q < width))[None, :])
            got_chunk = logits[0, tl - 1 - cur].float()
            top2 = torch.topk(want, 2).values
            per_prompt.append(dict(
                tokens=tl, chunks=-(-tl // c),
                err_cold=(got_cold - want).abs().max().item(),
                err_admission=(got_chunk - want).abs().max().item(),
                admission_vs_cold=(got_chunk - got_cold).abs().max().item(),
                scale=want.abs().max().item(),
                top2_margin=(top2[0] - top2[1]).item(),
                argmax_equal=bool(got_chunk.argmax() == got_cold.argmax())))
    err_cold = max(r["err_cold"] for r in per_prompt)
    err_adm = max(r["err_admission"] for r in per_prompt)
    rec = dict(prompts=len(per_prompt), factor=factor, err_cold=err_cold,
               err_admission=err_adm,
               admission_vs_cold=max(r["admission_vs_cold"]
                                     for r in per_prompt),
               scale=max(r["scale"] for r in per_prompt),
               argmax_equal=sum(r["argmax_equal"] for r in per_prompt),
               per_prompt=per_prompt)
    check(math.isfinite(err_adm) and err_adm <= factor * err_cold,
          f"bf16 flip logits through the admission chunks err {err_adm} "
          f"against float32, above {factor} x the cold prefill's {err_cold}")
    return rec


def deployment_phase(torch, attention, quant_matmul, engine_cls, queue_cls,
                     metrics_cls, config_cls, sampling_cls, prod,
                     profile_4b, drain_4b) -> tuple:
    """Phase 4c: the deployment config through `PagedQueue`, its kernel
    routes counted through the graph replays, its profile window beside
    phase 4b's, and its exactness checks (see the module docstring).
    Returns (its record, what phase 7 holds speculation against: the
    answers, the greedy tokens of the same 24 requests in bf16 at 128
    tokens and in float32 at 32, the readings and a decode model call's
    device ms)."""
    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    eng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=128), **prod),
        **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and eng.prefill_chunk == 32
          and eng.prefix_cache is not None
          and eng.prefix_cache.max_blocks == 512
          and eng.prefix_cache.block_tokens == 16
          and eng.megastep_ks == [1, 2, 4, 8] and eng.megastep_k == 4
          and cfg.quant_kv and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.dtype == torch.bfloat16
          and eng.widths == [160, 192, 256, 384],
          f"not the deployment configuration: {cfg}, widths {eng.widths}")
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts, routes_of_names)

    warm_s = eng.warmup()
    # Each graph's counted launches beside its kernel nodes by route (the
    # capture raises where the two differ; recorded to show them).
    captured = {w: {kind: {"counted": routes_of_counts(
                               g.captured_launches()),
                           "graph_kernel_nodes": routes_of_names(g.kernels),
                           "all_kernel_nodes": sum(g.kernels.values())}
                    for kind, g in zip(("decode", "admission"), pair)}
                for w, pair in eng._graphs.items()}
    wave1, wave2 = deployment_waves()
    course = [eng.tokenizer.encode(p)
              for p in wave1[:1] + wave2[:len(COURSE_QUESTIONS) - 1]]
    shared = len(os.path.commonprefix(course))
    lens = [len(t) for t in course]
    check(max(lens) <= eng.bucket,
          f"a course prompt exceeds the prompt bucket: {lens}")
    blk = eng.prefix_cache.block_tokens
    # A staged course slot splices the context's whole blocks (the last
    # prompt token is always prefilled): 7 slots after the first.
    want_hits = (len(course) - 1) * (min(shared, min(lens) - 1) // blk) * blk
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.graph_replays, eng.host_decisions, eng.total_generated_tokens)
    blocks0 = eng.prefix_cache.blocks_used
    # Wave 2 goes once the first course prompt (staged first, so served
    # and flipped first) has published its blocks.
    answers, wall, snap = run_paged_waves(
        eng, queue_cls, metrics_cls, wave1, wave2,
        ready=lambda: eng.prefix_cache.blocks_used - blocks0 >= lens[0] // blk)
    decode_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    model_calls = decode_calls + adm_calls + eng.prefill_calls - c0[2]
    replays = eng.graph_replays - c0[3]
    decisions = eng.host_decisions - c0[4]
    tokens = eng.total_generated_tokens - c0[5]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    lat, counters, gauges = snap["latency"], snap["counters"], snap["gauges"]
    check(len(answers) == 24 and all(isinstance(a, str) for a in answers),
          "deployment: expected 24 string answers")
    check(counters.get("decode_stalled_tokens", 0) == 0
          and counters.get("prefill_stall_ms", 0) == 0,
          f"deployment: fused admission stalled decode: {counters}")
    check(counters.get("prefix_cache_hit_tokens", 0) >= want_hits,
          f"deployment: prefix-cache hit tokens below the {want_hits} of "
          f"the shared course context in 7 slots: {counters}")
    check(eng.prefill_calls == c0[2] and adm_calls > 0,
          "deployment: admission did not run inside the megasteps")
    check(decode_calls > 0
          and launches[attention.INT8KV] == cfg.num_layers * decode_calls,
          f"deployment: decode_attention_int8kv launches "
          f"{launches[attention.INT8KV]} != {cfg.num_layers} x "
          f"{decode_calls} decode model calls (counted through replays)")
    check(launches[quant_matmul.KERNEL] == 49 * model_calls
          and launches[quant_matmul.MMA] == 48 * model_calls
          and launches[quant_matmul.MMA_UNEMBED] == model_calls
          and launches[quant_matmul.FMA] == 0,
          f"deployment: int8 matmul launches {launches} != 49 x "
          f"{model_calls} model calls on the tensor cores")
    check(launches[attention.KERNEL] == 0 and launches[attention.RAGGED] == 0,
          "deployment: a float-cache attention variant ran")
    run = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_max_s=lat["ttft"]["max_s"], decode_model_calls=decode_calls,
        admission_chunks=adm_calls, model_calls=model_calls,
        graph_replays=replays, host_decisions=decisions,
        replays_per_token=replays / tokens,
        host_decisions_per_token=decisions / tokens,
        megastep_k_final=gauges.get("megastep_k"),
        dead_lane_tokens=counters.get("megastep_dead_lane_tokens", 0),
        decode_stalled_tokens=counters.get("decode_stalled_tokens", 0),
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        prefix_hit_rate=gauges.get("prefix_cache_hit_rate"),
        prefix_blocks_used=gauges.get("prefix_cache_blocks_used"),
        shared_context_tokens=shared, course_prompt_tokens=lens,
        prefix_hit_tokens_wanted=want_hits,
        host_dispatches_per_token=gauges.get("host_dispatches_per_token"),
        launches=launches, warmup_s=warm_s, captured=captured)
    emit("deployment_path", **run)
    prof = profile_paged(torch, eng, wave1[1:] + wave2[:4])
    emit("profile_deployment_step", **prof)
    drain = profile_drain(torch, eng, wave1 + wave2)
    emit("profile_deployment_drain", **drain)
    # Two step() calls are phase 4b's steady window; a megastep of up to 8
    # x 16 tokens can cover a whole answer, so the two windows may hold
    # different work: the drains (the same 24 requests) compare alike.
    emit("profile_busy_share", phase_4b=profile_4b["device_busy_share"],
         phase_4c=prof["device_busy_share"],
         phase_4c_same_window=prof["device_busy_us"]
         / prof["profiled_wall_us"],
         drain_4b=drain_4b["device_busy_share"],
         drain_4c=drain["device_busy_share"],
         launches_per_model_call_4b=profile_4b["launches_per_model_call"],
         launches_per_model_call_4c=prof["launches_per_model_call"])
    run["profile"] = prof
    run["drain"] = drain
    batches = (wave1[:1], wave1[1:] + wave2)
    refs = dict(answers=answers, bf16_tokens=engine_tokens(eng, *batches),
                decode_call_ms=graph_call_ms(torch, eng, eng.widths[-1]),
                tokens_per_s=run["tokens_per_s"],
                ttft_mean_s=run["ttft_mean_s"], ttft_p50_s=run["ttft_p50_s"],
                model_calls_per_token=model_calls / tokens)
    run["decode_call_ms_idle"] = refs["decode_call_ms"]
    del eng
    torch.cuda.empty_cache()

    # float32: the deployment config's greedy tokens equal the sequential
    # config's (megastep 1, no prefix cache, no fused admission),
    # with an int8 and with a dense cache. The first course prompt is
    # drained before the rest are sent, so the deployment config splices
    # the course context into the other 7. In bf16 the two sum prefill
    # products in other orders (a 32-row admission chunk against a whole
    # prompt), so there the share that agrees and where the others
    # diverge are reported, not held; the flip logits witness below holds
    # the admission route to the cold prefill's accuracy instead.
    f32_checks = []
    for dtype, kv_quant in ((torch.float32, True), (torch.float32, False),
                            (torch.bfloat16, True)):
        toks = {}
        for name, kw in (("deployment", deploy_kw),
                         ("sequential", dict(slots=16, chunk=16, inflight=3,
                                             cuda_graphs=False))):
            e = engine_cls(config_cls(
                sampling=sampling_cls.greedy(max_new_tokens=32),
                **dict(prod, dtype=dtype, param_dtype=dtype,
                       kv_quant=kv_quant)), **kw)
            if e.cuda_graphs:
                e.warmup()
            toks[name] = engine_tokens(e, *batches)
            if name == "deployment":
                hits = e.pop_prefix_stats()
                if dtype == torch.bfloat16:
                    witness = flip_logits_witness(torch, e, wave1 + wave2)
            del e
        firsts = [first_divergence(a, b) for a, b in
                  zip(toks["deployment"], toks["sequential"])]
        diverged = [i for i, f in enumerate(firsts) if f is not None]
        rec = dict(dtype=str(dtype).split(".")[-1], kv_quant=kv_quant,
                   requests=len(firsts), equal=len(firsts) - len(diverged),
                   tokens=sum(len(t) for t in toks["sequential"]),
                   diverged=diverged,
                   first_divergence=[firsts[i] for i in diverged],
                   prefix_stats=hits)
        check(hits is not None and hits[0] >= want_hits,
              f"{rec['dtype']} deployment run (kv_quant={kv_quant}): prefix "
              f"hit tokens below {want_hits}: {hits}")
        if dtype == torch.bfloat16:
            rec["flip_logits"] = witness
            emit("bf16_deployment_vs_sequential", **rec)
            run["bf16_deployment_vs_sequential"] = rec
            continue
        emit("f32_deployment_vs_sequential", **rec)
        f32_checks.append(rec)
        if kv_quant:
            refs["f32_tokens"] = toks["deployment"]
        check(not diverged,
              f"float32 deployment greedy tokens differ from the "
              f"sequential config's (kv_quant={kv_quant}) at requests "
              f"{diverged}")
    run["f32_checks"] = f32_checks
    torch.cuda.empty_cache()

    # bf16: graph replays at K=4 equal the eager chunk loop (megastep 1,
    # same shapes, no prefix cache, no fused admission), greedy and with
    # the reference sampling from the same seed. 16 requests fill the 16
    # slots at once, so both admit at the same boundary.
    prompts16 = wave1[1:] + wave2[:4]
    bf16_checks = []
    for name, sampling in (
            ("greedy", sampling_cls.greedy(max_new_tokens=128)),
            ("sampled", sampling_cls.reference_defaults(
                max_new_tokens=128))):
        toks = {}
        for mode, kw in (("graphs_k4", dict(megastep=4, megastep_max=4)),
                         ("eager_chunk_loop", dict(cuda_graphs=False))):
            e = engine_cls(config_cls(sampling=sampling, **prod), slots=16,
                           chunk=16, inflight=3, **kw)
            e.warmup()
            toks[mode] = engine_tokens(e, prompts16)
            if mode == "graphs_k4":
                check(e.graph_replays > 0 and e.megastep_k == 4,
                      "bf16 K=4 engine did not replay graphs at K=4")
            del e
        firsts = [first_divergence(a, b) for a, b in
                  zip(toks["graphs_k4"], toks["eager_chunk_loop"])]
        rec = dict(run=name, requests=len(prompts16),
                   equal=sum(f is None for f in firsts),
                   first_divergence=[f for f in firsts if f is not None],
                   tokens=sum(len(t) for t in toks["graphs_k4"]))
        emit("bf16_graphs_vs_eager_chunk_loop", **rec)
        bf16_checks.append(rec)
        check(rec["equal"] == len(prompts16),
              f"bf16 K=4 graph replays differ from the eager chunk loop "
              f"({name}): first divergences {rec['first_divergence']}")
    run["bf16_checks"] = bf16_checks
    torch.cuda.empty_cache()
    return run, refs


# ------------------------------------------- phase 6: the relevance gate

GATE_THRESHOLD = 0.6                   # configs/cluster.toml [gate]
GATE_BF16_TOL = TOLERANCE["bfloat16"]  # bf16 similarity vs float32's
GATE_INT8_TOL = 0.05                   # tests/test_quant.py's bound
GATE_CACHE_TOL = 1e-5                  # a float32 hit vs the joint miss
# float32 on the card against float64 on the CPU, of the largest
# magnitude: summation order only. TF32 products keep ~3 decimal digits.
GATE_F64_OF_SCALE = 1e-4
GATE_TIMED_CALLS = 20
GATE_NOTES = ("Distributed systems, CS 451 notes, week 6: Raft keeps a "
              "replicated log consistent across servers. A leader is elected "
              "for a term by a majority of votes, appends client commands to "
              "its log and replicates them to the followers; an entry "
              "commits once a majority stores it. ")


def gate_contexts(tokenizer, buckets) -> dict:
    """Assignment texts by the bucket a miss lands in: words of the course
    notes, as many as fill 7/8 of each length bucket (with [CLS] and
    [SEP]) under the gate's tokenizer; one of 700 tokens, cut at the 512
    positions; and the empty text the LMS passes for an assignment with no
    text."""
    words = (GATE_NOTES * 40).split()

    def sized(target):
        lo, hi = 1, len(words)
        while lo < hi:  # fewest words that reach `target` tokens
            mid = (lo + hi) // 2
            n = len(tokenizer.encode(" ".join(words[:mid]),
                                     add_special_tokens=True))
            lo, hi = (mid + 1, hi) if n < target else (lo, mid)
        return " ".join(words[:lo])

    contexts = {str(b): sized(b - b // 8) for b in buckets}
    contexts["over_512"] = sized(700)
    contexts["empty"] = ""
    return contexts


def to_cpu_f64(torch, tree):
    """A parameter tree of dense tensors, in float64 on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu_f64(torch, v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float64)


def gate_latency(torch, gate, query, contexts) -> dict:
    """`check` latency on the host clock (a check ends in a device-to-host
    copy), p50 and mean over GATE_TIMED_CALLS calls: a miss (the context's
    cache entry dropped before each call, outside the timing) and a hit,
    at each bucket."""
    out = {}
    for label, ctx in contexts.items():
        times = {"miss": [], "hit": []}
        for _ in range(GATE_TIMED_CALLS):
            gate._ctx_cache.pop(ctx, None)
            t0 = time.monotonic()
            gate.check(query, ctx)
            times["miss"].append(time.monotonic() - t0)
        for _ in range(GATE_TIMED_CALLS):
            t0 = time.monotonic()
            gate.check(query, ctx)
            times["hit"].append(time.monotonic() - t0)
        bucket = gate._encode([query, ctx])[0].shape[1]
        out[label] = {"bucket": bucket, **{
            f"{kind}_{stat}_ms": fn(ts) * 1e3 for kind, ts in times.items()
            for stat, fn in (("p50", statistics.median),
                             ("mean", statistics.mean))}}
    return out


def profile_gate(torch, gate, query, ctx, calls=10) -> dict:
    """Where a miss's time goes: `calls` misses timed without the profiler,
    then under `torch.profiler`. Kernels per forward from the trace (a
    lower bound: the profiler on the card loses records), the device busy
    share = summed kernel time over the unprofiled wall, kernel time by
    name; the trace holds no more of the port's kernels than counted."""
    from torch.profiler import ProfilerActivity, profile

    def misses():
        for _ in range(calls):
            gate._ctx_cache.pop(ctx, None)
            gate.check(query, ctx)
        torch.cuda.synchronize()

    misses()
    t0 = time.monotonic()
    misses()
    wall_us = (time.monotonic() - t0) * 1e6
    before = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        misses()
    events = device_events(torch, prof)
    traced = check_traced_launches(events, before, "phase 6 profile")
    by_name: dict = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for _, us in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "bucket": gate._encode([query, ctx])[0].shape[1], "calls": calls,
        "wall_us": wall_us, "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_forward": len(events) / calls,
        "device_us_per_forward": busy_us / calls,
        "traced_port_kernels": traced,
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def gate_phase(torch, attention, quant_matmul, args, streaming) -> dict:
    """Phase 6: the relevance gate at bert-base-uncased width (see the
    module docstring); `streaming` is phase 5's record, for the gate's
    share of a student's wait."""
    import dataclasses

    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig,
        RelevanceGate,
    )
    from distributed_lms_raft_llm_tpu_torch.models import bert

    common = dict(model="bert-base-uncased", checkpoint=args.gate_checkpoint,
                  vocab_path=args.gate_vocab, seed=args.seed,
                  threshold=GATE_THRESHOLD, device="cuda")
    run = {"weights": args.gate_checkpoint or f"seeded random (seed "
           f"{args.seed}), no checkpoint",
           "tokenizer": args.gate_vocab or "byte fallback (no vocab)"}
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls may run on TF32")
    gates = {}
    for name, dtype, quant in (("float32", torch.float32, None),
                               ("bfloat16", torch.bfloat16, None),
                               ("int8", torch.bfloat16, "int8")):
        t0 = time.monotonic()
        gate = RelevanceGate(GateConfig(dtype=dtype, quant=quant, **common))
        cfg = gate.cfg
        check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim,
               cfg.vocab_size, cfg.max_position_embeddings)
              == (12, 768, 12, 3072, 30522, 512) and cfg.dtype == dtype
              and gate.config.length_buckets == (64, 128, 256, 512),
              f"gate {name}: not bert-base-uncased at full width: {cfg}")
        wi = gate.params["blocks"]["mlp"]["wi"]
        check((isinstance(wi, dict) and wi["q"].dtype == torch.int8)
              if quant else wi.dtype == dtype,
              f"gate {name}: products not in {quant or dtype}")
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        gate.warmup()
        warm_s = time.monotonic() - t0
        gates[name] = gate
        run[name] = {"load_s": load_s, "warmup_s": warm_s}
    contexts = gate_contexts(gates["float32"].tokenizer, (64, 128, 256, 512))
    query = QUESTIONS[1]
    for name, gate in gates.items():  # the first check after warmup()
        t0 = time.monotonic()
        gate.check(query, contexts["64"])
        run[name]["first_check_ms"] = (time.monotonic() - t0) * 1e3
        gate._ctx_cache.clear()

    # The pairs through each gate, launches counted from zero.
    pairs = [(q, c) for q in QUESTIONS for c in contexts.values()]
    buckets = sorted({gates["float32"]._encode([q, c])[0].shape[1]
                      for q, c in pairs})
    check(buckets == [64, 128, 256, 512],
          f"phase 6 pairs land in buckets {buckets}")
    results = {}
    for name, gate in gates.items():
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        forwards0 = gate.forwards
        results[name] = [gate.check(q, c) for q, c in pairs]
        forwards = gate.forwards - forwards0
        mm = {k: quant_matmul.launch_counts[k] for k in (
            quant_matmul.KERNEL, quant_matmul.MMA, quant_matmul.MMA_UNEMBED,
            quant_matmul.FMA)}
        attn = sum(attention.launch_counts.values())
        want = 48 * forwards if name == "int8" else 0
        check(forwards == len(pairs) and mm[quant_matmul.KERNEL] == want
              and mm[quant_matmul.MMA] == want and attn == 0
              and mm[quant_matmul.MMA_UNEMBED] == mm[quant_matmul.FMA] == 0,
              f"gate {name}: int8_matmul launches {mm}, attention {attn}, "
              f"for {forwards} forwards (want {want} on the tensor cores)")
        run[name].update(forwards=forwards, int8_matmul_launches=mm)
    sims = {name: [s for _, s in res] for name, res in results.items()}
    check(all(math.isfinite(s) and -1.0 - 1e-6 <= s <= 1.0 + 1e-6
              for res in sims.values() for s in res),
          "gate similarities are not finite cosines")
    f32 = sims["float32"]
    bf16_err = max(abs(a - b) for a, b in zip(sims["bfloat16"], f32))
    int8_err = max(abs(a - b) for a, b in zip(sims["int8"], f32))
    clear = [i for i, s in enumerate(f32)
             if abs(s - GATE_THRESHOLD) > GATE_BF16_TOL]
    decisions_equal = all(results["bfloat16"][i][0] == results["float32"][i][0]
                          for i in clear)
    check(bf16_err <= GATE_BF16_TOL,
          f"bf16 gate similarities err {bf16_err} > {GATE_BF16_TOL} "
          "against float32's")
    check(decisions_equal, "bf16 gate decisions differ from float32's away "
          "from the threshold")
    check(int8_err < GATE_INT8_TOL,
          f"int8 gate similarities err {int8_err} >= {GATE_INT8_TOL}")
    run["pairs"] = dict(
        count=len(pairs), buckets=buckets,
        context_tokens={k: len(gates["float32"].tokenizer.encode(
            c, add_special_tokens=True)) for k, c in contexts.items()},
        bf16_max_abs_err=bf16_err, int8_max_abs_err=int8_err,
        bf16_tol=GATE_BF16_TOL, int8_tol=GATE_INT8_TOL,
        decisions_compared=len(clear), decisions_equal=decisions_equal,
        passes={name: sum(p for p, _ in res) for name, res in results.items()},
        sim_range_float32=[min(f32), max(f32)])

    # A cache hit against the joint miss (short query, the widest context).
    cache = {}
    for name, gate in gates.items():
        ctx = contexts["512"]
        emb = gate.embed_texts([query, ctx])
        check(emb.shape == (2, 768) and bool(np.isfinite(emb).all()),
              f"gate {name}: embeddings {emb.shape} not finite")
        joint = float(np.dot(emb[0], emb[1]) / max(float(
            np.linalg.norm(emb[0]) * np.linalg.norm(emb[1])), 1e-12))
        gate._ctx_cache.pop(ctx, None)
        miss = gate.check(query, ctx)[1]
        hit = gate.check(query, ctx)[1]
        tol = GATE_CACHE_TOL if name == "float32" else GATE_BF16_TOL
        check(abs(miss - joint) <= tol and abs(hit - joint) <= tol,
              f"gate {name}: cache hit {hit} / miss {miss} against the "
              f"joint {joint} (tol {tol})")
        cache[name] = dict(joint=joint, miss_err=abs(miss - joint),
                           hit_err=abs(hit - joint), tol=tol)
    run["cache_hit_vs_joint"] = cache

    # float32 on the card against float64 on the CPU: no TF32.
    gate = gates["float32"]
    texts = [query, contexts["128"]]
    ids, mask = gate._encode(texts)
    with torch.inference_mode():
        ref = bert.embed(to_cpu_f64(torch, gate.params),
                         dataclasses.replace(gate.cfg, dtype=torch.float64),
                         torch.as_tensor(ids),
                         attention_mask=torch.as_tensor(mask)).numpy()
    scale = float(np.abs(ref).max())
    f32_err = float(np.abs(gate.embed_texts(texts) - ref).max()) / scale
    torch.backends.cuda.matmul.allow_tf32 = True  # the witness's control
    try:
        tf32_err = float(np.abs(gate.embed_texts(texts) - ref).max()) / scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(f32_err <= GATE_F64_OF_SCALE,
          f"float32 gate errs {f32_err} of scale against float64 (TF32?)")
    run["float32_vs_float64"] = dict(err_of_scale=f32_err,
                                     tf32_err_of_scale=tf32_err,
                                     bound=GATE_F64_OF_SCALE)

    # Latency per bucket, a miss and a hit; the trace of a miss.
    for name, gate in gates.items():
        run[name]["latency"] = gate_latency(torch, gate, query, contexts)
        gate._ctx_cache.clear()
    quant_matmul.reset_launch_counts()
    run["profile"] = {
        f"{name}_{label}": profile_gate(torch, gates[name], query,
                                        contexts[label])
        for name in ("bfloat16", "int8") for label in ("64", "512")}

    # What the gate adds to a student's wait (phase 5's TTFT, same run).
    lat = run["bfloat16"]["latency"]
    ttft = streaming["stream_ttft_mean_s"] * 1e3
    run["beside_phase5"] = dict(
        stream_ttft_mean_ms=ttft,
        engine_ttft_mean_ms=streaming["engine_ttft_mean_s"] * 1e3,
        gate_bf16_miss_p50_ms={k: v["miss_p50_ms"] for k, v in lat.items()},
        gate_bf16_hit_p50_ms=lat["64"]["hit_p50_ms"],
        miss_share_of_stream_ttft={k: v["miss_p50_ms"] / ttft
                                   for k, v in lat.items()},
        hit_share_of_stream_ttft=lat["64"]["hit_p50_ms"] / ttft)
    del gates
    torch.cuda.empty_cache()
    return run


# ------------------------------------ phase 7: speculative decoding

SPEC_TOKENS = 8  # configs/cluster.toml [tutoring] spec_tokens (commented out)


def graph_call_ms(torch, eng, width, reps=4) -> float:
    """Device ms of one model call of `eng`'s captured decode (or verify)
    chunk at `width`, by CUDA-event timing of `reps` replays on an idle
    state (every slot inactive at length 0: the products and the whole
    program run, attention reads a key or a window a slot)."""
    graph, _ = eng._graphs[width]
    eng.state = eng._init_state(width)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    eng.reset()
    return start.elapsed_time(end) / (reps * eng.chunk)


def divergence_margin(torch, eng, prompt, toks, i) -> float:
    """top-1 minus top-2 logit where a greedy answer `toks` takes token i:
    one full-sequence forward of the prompt and toks[:i] on `eng`'s
    weights."""
    ids = eng.tokenizer.encode(prompt)[-eng.bucket:] + list(toks[:i])
    with torch.inference_mode():
        logits, _ = eng.family.forward(
            eng.params, eng.cfg, torch.tensor([ids], device=eng.device))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return (top2[0] - top2[1]).item()


def spec_phase(torch, attention, quant_matmul, prod, common, refs, args,
               kernel_cases) -> dict:
    """Phase 7: speculative decoding on the deployment config (see the
    module docstring). `refs` holds phase 4c's answers, its float32 and
    bf16 tokens and its decode call's device ms; `kernel_cases` collects
    the window cases for the kernels line."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        PagedQueue,
        SamplingParams,
        TutoringEngine,
        graphs,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.spec import verify_width
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    k = SPEC_TOKENS
    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    run = {}

    # (a) The window kernel against its plain version, row by row, each
    # case with its planted faults caught: T = 2 and k + 1 at widths 384
    # and 640; the main paths' own shapes follow in (b) and (c).
    cases = []

    def window_case(**kw):
        case = sweep_attention.window_attention_case(**kw)
        emit("window_attention_case", **case)
        cases.append(case)
        return case

    for int8 in (True, False):
        for t in (2, k + 1):
            for width in (384, 640):
                window_case(s=16, width=width, t=t, int8=int8,
                            seed=width + t + int8)
    run["window_cases"] = cases

    # (b) Exactness. The bucketed engine: spec 8 through the window kernel
    # with the padding bias, bf16 (its launches) and float32 (its tokens
    # equal the plain decoder's). The kernel first, against its plain
    # version at this engine's own rows and cache width, with the bias.
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    bucketed = {}
    for dtype in (torch.bfloat16, torch.float32):
        conf = dict(common, dtype=dtype, param_dtype=dtype,
                    sampling=SamplingParams.greedy(max_new_tokens=32))
        spec_eng = TutoringEngine(EngineConfig(spec_tokens=k, **conf))
        check(spec_eng.cfg.fused_decode_attention,
              "bucketed spec engine without the kernel")
        ids, mask, bucket = spec_eng.encode_prompts(prompts)
        width = verify_width(ids.shape[1], conf["sampling"].max_new_tokens,
                             k)
        name = str(dtype).split(".")[-1]
        case = window_case(s=ids.shape[0], width=width, t=k + 1, int8=False,
                           with_bias=True, dtype=name, seed=11)
        if dtype == torch.bfloat16:
            kernel_cases["bucketed"] = case
        spec_eng.generate_ids(ids[:1], mask[:1])  # first calls, builds
        attention.reset_launch_counts()
        w0 = spec_eng.decode_steps
        got = spec_eng.generate_ids(ids, mask)
        windows = spec_eng.decode_steps - w0
        launched = dict(attention.launch_counts)
        check(windows > 0
              and launched[attention.WINDOW] == 12 * windows
              and launched[attention.KERNEL] == 0,
              f"bucketed spec: window launches {launched} != 12 x "
              f"{windows} verify windows")
        plain = TutoringEngine(EngineConfig(**conf))
        want = plain.generate_ids(ids, mask)
        equal = [bool((got.tokens[i, :got.lengths[i]]
                       == want.tokens[i, :want.lengths[i]]).all()
                      and got.lengths[i] == want.lengths[i])
                 for i in range(len(prompts))]
        bucketed[name] = dict(
            bucket=bucket, rows=ids.shape[0], cache_width=width,
            windows=windows,
            plain_decode_steps=plain.decode_steps,
            window_launches=launched[attention.WINDOW], equal=sum(equal),
            requests=len(prompts),
            tokens_per_window=spec_eng.last_spec_tokens_per_window)
        if dtype == torch.float32:
            check(all(equal), f"float32 bucketed spec tokens differ from "
                  f"the plain decoder's: {equal}")
        del spec_eng, plain
    emit("spec_bucketed", **bucketed)
    run["bucketed"] = bucketed
    main_window_launches = bucketed["bfloat16"]["window_launches"]

    # The float32 deployment with spec 8 against phase 4c's float32
    # deployment (int8 cache) on its 24 requests.
    wave1, wave2 = deployment_waves()
    batches = (wave1[:1], wave1[1:] + wave2)
    e = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=32), spec_tokens=k,
        **dict(prod, dtype=torch.float32, param_dtype=torch.float32)),
        **deploy_kw)
    e.warmup()
    toks32 = engine_tokens(e, *batches)
    firsts = [first_divergence(a, b)
              for a, b in zip(toks32, refs["f32_tokens"])]
    f32 = dict(requests=len(firsts), equal=sum(f is None for f in firsts),
               diverged=[i for i, f in enumerate(firsts) if f is not None],
               tokens=sum(len(t) for t in toks32), spec=e.pop_spec_stats())
    emit("spec_f32_vs_deployment", **f32)
    check(f32["equal"] == len(firsts) == 24,
          f"float32 spec deployment differs from the float32 deployment "
          f"without spec at requests {f32['diverged']}")
    run["f32_exactness"] = f32
    del e
    torch.cuda.empty_cache()

    # (c) The bf16 deployment with spec 8 through PagedQueue, as phase 4c.
    eng = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=128), spec_tokens=k,
        **prod), **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and eng.spec == k
          and eng.widths == [167, 199, 263, 391] and cfg.quant_kv
          and cfg.dtype == torch.bfloat16 and cfg.num_layers == 12,
          f"not the deployment configuration with spec {k}: {cfg}, "
          f"widths {eng.widths}")
    # The window kernel against its plain version at every cache width of
    # this engine, its slots and window (int8 cache, bf16 q); the widest
    # is the kernels line's.
    for width in eng.widths:
        kernel_cases["int8"] = window_case(s=eng.slots, width=width, t=k + 1,
                                           int8=True, seed=width)
    warm_s = eng.warmup()
    captured = {w: {"counted": routes_of_counts(g.captured_launches()),
                    "graph_kernel_nodes": routes_of_names(g.kernels),
                    "all_kernel_nodes": sum(g.kernels.values())}
                for w, (g, _) in eng._graphs.items()}
    kernels_per_call = {w: c["all_kernel_nodes"] / eng.chunk
                        for w, c in captured.items()}
    course = [eng.tokenizer.encode(p)
              for p in wave1[:1] + wave2[:len(COURSE_QUESTIONS) - 1]]
    lens = [len(c) for c in course]
    blk = eng.prefix_cache.block_tokens
    captures0 = graphs.captures
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.graph_replays, eng.host_decisions, eng.total_generated_tokens)
    blocks0 = eng.prefix_cache.blocks_used
    answers, wall, snap = run_paged_waves(
        eng, PagedQueue, Metrics, wave1, wave2,
        ready=lambda: eng.prefix_cache.blocks_used - blocks0 >= lens[0] // blk)
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    verify_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    model_calls = verify_calls + adm_calls + eng.prefill_calls - c0[2]
    tokens = eng.total_generated_tokens - c0[5]
    lat, counters, gauges = snap["latency"], snap["counters"], snap["gauges"]
    check(len(answers) == 24 and all(isinstance(a, str) for a in answers),
          "spec deployment: expected 24 string answers")
    check(verify_calls > 0
          and launches[attention.WINDOW_INT8KV] == 12 * verify_calls,
          f"spec deployment: decode_attention_window_int8kv launches "
          f"{launches[attention.WINDOW_INT8KV]} != 12 x {verify_calls} "
          f"verify model calls (counted through replays)")
    check(all(launches[n] == 0 for n in (attention.KERNEL, attention.RAGGED,
                                         attention.INT8KV, attention.WINDOW)),
          f"spec deployment: another attention variant ran: {launches}")
    check(launches[quant_matmul.KERNEL] == 49 * model_calls
          and launches[quant_matmul.MMA] == 48 * model_calls
          and launches[quant_matmul.FMA] == 0,
          f"spec deployment: int8 matmul launches {launches} != 49 x "
          f"{model_calls} model calls on the tensor cores")
    check(graphs.captures == captures0,
          "spec deployment: a CUDA graph was captured while serving")
    check(counters.get("decode_stalled_tokens", 0) == 0,
          f"spec deployment: admission stalled decode: {counters}")
    tpw = gauges.get("spec_tokens_per_window")
    check(tpw is not None and 1.0 <= tpw <= k + 1,
          f"spec deployment: spec_tokens_per_window {tpw}")
    same = sum(a == b for a, b in zip(answers, refs["answers"]))
    spec_run = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        tokens_per_s_4c=refs["tokens_per_s"],
        ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_mean_s_4c=refs["ttft_mean_s"], ttft_p50_s_4c=refs["ttft_p50_s"],
        spec_tokens_per_window=tpw,
        spec_accepted_tokens=counters.get("spec_accepted_tokens", 0),
        verify_model_calls=verify_calls, admission_chunks=adm_calls,
        model_calls=model_calls, model_calls_per_token=model_calls / tokens,
        model_calls_per_token_4c=refs["model_calls_per_token"],
        host_decisions_per_token=(eng.host_decisions - c0[4]) / tokens,
        graph_replays=eng.graph_replays - c0[3],
        megastep_k_final=gauges.get("megastep_k"),
        dead_lane_tokens=counters.get("megastep_dead_lane_tokens", 0),
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        answers_equal_4c=same, launches=launches,
        captures_while_serving=graphs.captures - captures0, warmup_s=warm_s,
        kernels_per_verify_call=kernels_per_call)
    emit("spec_deployment_path", **spec_run)
    drain = profile_drain(torch, eng, wave1 + wave2)
    spec_run["drain"] = drain
    spec_run["device_ms_per_model_call"] = (drain["device_busy_us"] / 1e3
                                            / drain["model_calls_profiled"])
    emit("profile_spec_drain", **drain)
    # Greedy tokens beside phase 4c's (the same 24 requests, 128 tokens):
    # the first divergence of each differing answer, with the top-2 margin
    # of the logits there (a near-tie flips between two orders of sums).
    toks = engine_tokens(eng, *batches)
    windows, emitted = eng.pop_spec_stats()
    diverged = []
    for i, (a, b) in enumerate(zip(toks, refs["bf16_tokens"])):
        j = first_divergence(a, b)
        if j is not None:
            prompt = (batches[0] + batches[1])[i]
            diverged.append(dict(
                request=i, token=j,
                top2_margin=divergence_margin(torch, eng, prompt, b, j)))
    spec_run.update(
        tokens_equal_4c=len(toks) - len(diverged), diverged=diverged,
        verify_call_ms_idle=graph_call_ms(torch, eng, eng.widths[-1]),
        decode_call_ms_idle_4c=refs["decode_call_ms"],
        drain_tokens_per_window=emitted / max(windows, 1))
    emit("spec_vs_deployment", tokens_equal=spec_run["tokens_equal_4c"],
         diverged=diverged, answers_equal=same,
         verify_call_ms_idle=spec_run["verify_call_ms_idle"],
         decode_call_ms_idle_4c=refs["decode_call_ms"],
         device_ms_per_model_call=spec_run["device_ms_per_model_call"],
         busy_share=drain["device_busy_share"])
    run["deployment"] = spec_run
    del eng
    torch.cuda.empty_cache()

    # (d) The n-gram drafter under the reference sampling.
    e = PagedEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=128),
        spec_tokens=k, draft_source="ngram", **prod), **deploy_kw)
    e.warmup()
    attention.reset_launch_counts()
    steps0 = e.decode_steps
    toks = engine_tokens(e, *batches)
    windows, emitted = e.pop_spec_stats()
    ngram = dict(requests=len(toks), nonempty=sum(bool(t) for t in toks),
                 tokens=sum(len(t) for t in toks), windows=windows,
                 tokens_per_window=emitted / max(windows, 1),
                 window_launches=attention.launch_counts[
                     attention.WINDOW_INT8KV],
                 verify_calls=e.decode_steps - steps0)
    emit("spec_ngram_sampled", **ngram)
    check(ngram["nonempty"] == 24 and ngram["window_launches"]
          == 12 * ngram["verify_calls"],
          f"ngram drafter, reference sampling: {ngram}")
    run["ngram_sampled"] = ngram
    del e
    torch.cuda.empty_cache()

    # (e) gRPC: the server's flags build the spec engine; served greedy
    # under phase 5's tokenizer, 4 unary answers and 4 streams equal the
    # engine's direct answers.
    with tempfile.TemporaryDirectory() as tmp:
        vocab, merges, _ = phase5_tokenizer(args, Path(tmp))
        flags = tutoring_server.build_parser().parse_args([
            "--model", "gpt2", "--paged", "--quant", "int8", "--kv-quant",
            "--slots", "16", "--chunk", "16", "--inflight", "3",
            "--megastep", "4", "--megastep-max", "8", "--prefix-cache",
            "--prefix-cache-blocks", "512", "--prefill-chunk-tokens", "32",
            "--spec-tokens", str(k), "--draft-source", "prompt_lookup",
            "--vocab", vocab, "--merges", merges])
        built = tutoring_server.engine_from_args(flags)
        check(built.spec == k and built.fused and built.cuda_graphs
              and built.config.draft_source == "prompt_lookup",
              "--spec-tokens did not build the spec engine")
        del built
        eng = PagedEngine(EngineConfig(
            sampling=SamplingParams.greedy(max_new_tokens=128),
            spec_tokens=k, **dict(prod, vocab_path=vocab,
                                  merges_path=merges)), **deploy_kw)
        eng.warmup()
        queries = QUESTIONS[:4]
        rids = [eng.submit(PROMPT_TEMPLATE.format(query=q)) for q in queries]
        for rid in rids:
            eng.stream_watch(rid)
        eng.drain()
        finals = eng.pop_final_tokens()
        direct = [eng.tokenizer.decode(finals[r]).strip() for r in rids]
        check(all(direct), "spec gRPC: an empty direct answer")
        captures0 = graphs.captures

        async def go():
            server = await tutoring_server.serve_async(
                0, eng, host="127.0.0.1", metrics_port=0,
                node_id="chip-smoke-spec")
            try:
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{server._port}") as channel:
                    stub = rpc.TutoringStub(channel)

                    async def stream(q):
                        return [c async for c in stub.StreamLLMAnswer(
                            lms_pb2.StreamRequest(query=q), timeout=300)]

                    unary = await asyncio.gather(*[stub.GetLLMAnswer(
                        lms_pb2.QueryRequest(query=q), timeout=300)
                        for q in queries])
                    streams = await asyncio.gather(*[stream(q)
                                                     for q in queries])
                _, health = await http_json(server._health.port, "GET",
                                            "/healthz")
                return unary, streams, health
            finally:
                await server.stop(1)
                await server._queue.close()

        unary, streams, health = asyncio.run(go())
        for i, (resp, chunks) in enumerate(zip(unary, streams)):
            full = stream_contract(chunks)
            check(resp.success and resp.response == direct[i]
                  and full.strip() == direct[i],
                  f"spec gRPC: request {i}: unary, stream and direct "
                  f"answers differ")
        check(health.get("spec_tokens") == k
              and health.get("draft_source") == "prompt_lookup",
              f"spec gRPC: /healthz {health}")
        check(graphs.captures == captures0,
              "spec gRPC: a CUDA graph was captured while serving")
        grpc_rec = dict(requests=len(queries), unary_equal=len(queries),
                        streams_equal=len(queries),
                        chunks=[len(c) for c in streams],
                        healthz_spec_tokens=health.get("spec_tokens"))
        emit("spec_grpc", **grpc_rec)
        run["grpc"] = grpc_rec
        del eng
    torch.cuda.empty_cache()
    run["main_window_launches"] = main_window_launches
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--merges", default=None)
    parser.add_argument("--gate-checkpoint", default=None,
                        help="phase 6: the gate's BERT .safetensors (HF "
                        "layout); default seeded random weights")
    parser.add_argument("--gate-vocab", default=None,
                        help="phase 6: the gate's WordPiece vocab.txt; "
                        "default the byte fallback")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write every record as JSON to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 2
    if not (REPO / PACKAGE / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    records = {}

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("torch", version=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    records["card"] = smi

    # 2. Build every kernel (one nvcc per source, started together).
    from distributed_lms_raft_llm_tpu_torch.ops import (
        attention,
        build,
        quant_matmul,
        sweep_int8,
    )

    t0 = time.monotonic()
    build.build_all()
    build_s = time.monotonic() - t0
    for name, (secs, log) in build.build_logs.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln]
        emit("build", kernel=name, nvcc_s=secs, ptxas=ptxas)
    emit("build_total", seconds=build_s)
    records["build_s"] = build_s

    # 3. Kernel vs plain at GPT-2-small shapes.
    shapes = [dict(b=b, s=s, dtype=dtype) for dtype in ("bfloat16", "float32")
              for b in (1, 8) for s in (64, 384)]
    # The main path's grid: batch x (bucket 32 + 1, bucket 256 + 64, 384).
    shapes += [dict(b=b, s=s) for b in (1, 2, 4, 8) for s in (33, 320, 384)
               if (b, s) not in ((1, 384), (8, 384))]
    shapes += [
        dict(b=8, s=1024), dict(b=1, s=1024),  # GPT-2's full window
        dict(b=8, s=384, hkv=4),               # GQA
        # ragged: the last row pads 383 of 384, so every split of it but
        # the last is fully masked; then every row padded that far
        dict(b=8, s=384, pad=[0, 5, 17, 60, 100, 150, 200, 383]),
        dict(b=8, s=384, pad=[383] * 8),
        dict(b=8, s=300, s_alloc=384),         # a window of the cache
        dict(b=8, s=300, s_alloc=384, strided_q=True),
    ]
    cases = []
    for shape in shapes:
        cases.append(attention_case(torch, attention,
                                    **{"h": 12, "hkv": 12, **shape}))
        emit("attention_case", **cases[-1])
    records["attention_cases"] = cases

    # 3b. The paged path's kernels at its shapes.
    paged_cases = []
    for int8 in (False, True):
        for slots in (8, 16):
            for width in (160, 384):
                paged_cases.append(paged_attention_case(
                    torch, attention, s=slots, width=width, int8=int8,
                    seed=slots + width))
        # two rows split four ways: the short row's later splits are empty
        paged_cases.append(paged_attention_case(
            torch, attention, s=2, width=384, int8=int8, lengths=[1, 150]))
        paged_cases.append(paged_attention_case(
            torch, attention, s=16, width=384, int8=int8, dtype="float32",
            seed=3))
    for case in paged_cases:
        emit("paged_attention_case", **case)
    records["paged_attention_cases"] = paged_cases
    mm_cases = []
    for dtype in ("bfloat16", "float32"):
        for name in sweep_int8.INT8_PRODUCTS:
            # decode, the fused admission chunk, the cold prefill
            for m in (1, 16, 32, 256):
                mm_cases.append(sweep_int8.int8_matmul_case(
                    name=name, m=m, dtype=dtype))
                emit("int8_matmul_case", **mm_cases[-1])
    # The relevance gate's rows (phase 6): texts x length bucket.
    for name in sweep_int8.GATE_PRODUCTS:
        for m in sweep_int8.GATE_ROWS:
            mm_cases.append(sweep_int8.int8_matmul_case(
                name=name, m=m, dtype="bfloat16"))
            emit("int8_matmul_case", **mm_cases[-1])
    records["int8_matmul_cases"] = mm_cases
    model_call = sweep_int8.int8_model_call()
    emit("int8_matmul_model_call", **model_call)
    records["int8_matmul_model_call"] = model_call
    records["int8_matmul_gate_forward"] = []
    for m in sweep_int8.GATE_ROWS:  # one int8 gate forward's 48 products
        records["int8_matmul_gate_forward"].append(
            sweep_int8.int8_model_call(m=m, unembed=False))
        emit("int8_matmul_gate_forward",
             **records["int8_matmul_gate_forward"][-1])

    # 4. The bucketed path.
    from distributed_lms_raft_llm_tpu_torch.engine import (
        BatchingQueue,
        EngineConfig,
        SamplingParams,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    common = dict(model="gpt2", checkpoint=args.checkpoint,
                  vocab_path=args.vocab, merges_path=args.merges,
                  seed=args.seed, device="cuda")
    greedy_eng = TutoringEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=32), **common))
    sampled_eng = TutoringEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=64),
        **common))
    cfg = greedy_eng.cfg
    check(cfg.fused_decode_attention and cfg.num_layers == 12
          and cfg.hidden_size == 768 and cfg.num_heads == 12
          and cfg.vocab_size == 50257 and cfg.max_position_embeddings == 1024
          and cfg.dtype == torch.bfloat16,
          f"not GPT-2 small at full width in bf16 with the kernel: {cfg}")
    warm_s = greedy_eng.warmup(batch=8) + sampled_eng.warmup(batch=8)
    bucket = greedy_eng.encode_prompts(prompts)[2]

    attention.reset_launch_counts()
    steps0 = greedy_eng.decode_steps + sampled_eng.decode_steps
    runs = {}
    for name, eng in (("greedy_1", greedy_eng), ("greedy_2", greedy_eng),
                      ("sampled", sampled_eng)):
        tok0, eng_steps0 = eng.total_generated_tokens, eng.decode_steps
        answers, wall = run_queue(eng, prompts, BatchingQueue)
        check(len(answers) == 8 and all(isinstance(a, str) for a in answers),
              f"{name}: expected 8 string answers")
        ttfts = eng.last_batch_ttfts
        tokens = eng.total_generated_tokens - tok0
        ttft = sum(ttfts) / len(ttfts)
        runs[name] = dict(answers=answers, wall_s=wall, tokens=tokens,
                          decode_steps=eng.decode_steps - eng_steps0,
                          ttft_s=ttft, tokens_per_s=tokens / wall,
                          decode_tokens_per_s=(tokens - len(prompts))
                          / max(wall - ttft, 1e-9))
    launches = attention.launch_counts[attention.KERNEL]
    steps = greedy_eng.decode_steps + sampled_eng.decode_steps - steps0
    check(steps > 0 and launches == cfg.num_layers * steps,
          f"decode_attention launches {launches} != {cfg.num_layers} layers "
          f"x {steps} decode steps: the main path bypassed the kernel")
    check(runs["greedy_1"]["answers"] == runs["greedy_2"]["answers"],
          "greedy answers changed between two runs")
    for name, run in runs.items():
        emit("main_path", run=name, bucket=bucket,
             **{k: v for k, v in run.items() if k != "answers"})
    emit("main_path_kernel", launches=launches, decode_steps=steps,
         layers=cfg.num_layers, warmup_s=warm_s)
    print("answer_sample " + json.dumps(runs["greedy_1"]["answers"][0][:80]),
          flush=True)
    records["main_path"] = {k: {kk: vv for kk, vv in v.items()
                                if kk != "answers"} for k, v in runs.items()}
    records["main_path_launches"] = launches
    records["main_path_decode_steps"] = steps

    records["profile"] = profile_generate(torch, greedy_eng, prompts)
    emit("profile_greedy_batch", **records["profile"])

    # The kernel at the widest window this run's decode gave it, with q
    # strided as the model passes it.
    main_case = attention_case(torch, attention, b=8, h=12, hkv=12,
                               s=bucket + 64, strided_q=True, seed=1)
    emit("attention_main_shape", **main_case)

    # Kernel path vs plain path, greedy tokens in float32.
    f32 = dict(common, dtype=torch.float32, param_dtype=torch.float32,
               sampling=SamplingParams.greedy(max_new_tokens=32))
    fused_eng = TutoringEngine(EngineConfig(fused_attention=True, **f32))
    plain_eng = TutoringEngine(EngineConfig(fused_attention=False, **f32))
    ids, mask, _ = fused_eng.encode_prompts(prompts)
    fused_res = fused_eng.generate_ids(ids, mask)
    plain_res = plain_eng.generate_ids(ids, mask)
    same = bool((fused_res.tokens == plain_res.tokens).all())
    check(same and (fused_res.lengths == plain_res.lengths).all(),
          "float32 greedy tokens differ between kernel and plain paths")
    with torch.inference_mode():
        logits, _ = fused_eng.family.forward(
            fused_eng.params, fused_eng.cfg,
            torch.as_tensor(ids[:2, -8:], device="cuda").long())
    check(tuple(logits.shape) == (2, 8, 50257)
          and bool(torch.isfinite(logits).all()),
          "full-width forward logits are not finite [2, 8, 50257]")
    emit("f32_greedy_kernel_vs_plain", equal=same,
         tokens=int(fused_res.lengths.sum()))
    del fused_eng, plain_eng

    # 4b. The production path: PagedQueue -> PagedEngine, int8 weights and
    # an int8 KV cache (configs/cluster.toml's tutoring node, without the
    # megastep, the prefix cache and fused admission).
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        PagedQueue,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    prod = dict(common, quant="int8", kv_quant=True)
    # The sequential config, run eagerly (the baseline that phase 4c's
    # graphs are read against).
    paged_kw = dict(slots=16, chunk=16, inflight=3, cuda_graphs=False)
    greedy_paged = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=128), **prod),
        **paged_kw)
    sampled_paged = PagedEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=128),
        **prod), **paged_kw)
    pcfg = greedy_paged.cfg
    check(pcfg.fused_decode_attention and pcfg.quant_kv
          and pcfg.num_layers == 12 and pcfg.hidden_size == 768
          and pcfg.vocab_size == 50257 and pcfg.dtype == torch.bfloat16
          and isinstance(greedy_paged.params["wte"], dict)
          and greedy_paged.state.cache.k.dtype == torch.int8
          and greedy_paged.widths == [160, 192, 256, 384],
          f"not the production configuration: {pcfg}, widths "
          f"{greedy_paged.widths}")
    paged_warm_s = greedy_paged.warmup() + sampled_paged.warmup()
    wave1, wave2 = paged_waves()
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    engines = (greedy_paged, sampled_paged)
    calls0 = [(e.decode_steps, e.prefill_calls) for e in engines]
    paged_runs = {}
    for name, eng in (("greedy_1", greedy_paged), ("greedy_2", greedy_paged),
                      ("sampled", sampled_paged)):
        tok0, steps0 = eng.total_generated_tokens, eng.decode_steps
        answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics,
                                              wave1, wave2)
        check(len(answers) == 24 and all(isinstance(a, str)
                                         for a in answers),
              f"{name}: expected 24 string answers")
        tokens = eng.total_generated_tokens - tok0
        lat, counters = snap["latency"], snap["counters"]
        grows = lat.get("engine_prog_grow", {}).get("count", 0)
        check(grows >= 1 and counters.get("decode_stalled_tokens", 0) > 0,
              f"{name}: the second wave did not join mid-decode and widen "
              f"the cache (grows {grows}, counters {counters})")
        paged_runs[name] = dict(
            answers=answers, wall_s=wall, tokens=tokens,
            tokens_per_s=tokens / wall,
            decode_steps=eng.decode_steps - steps0,
            ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
            ttft_max_s=lat["ttft"]["max_s"], grows=grows,
            decode_stalled_tokens=counters["decode_stalled_tokens"],
            host_dispatches_per_token=snap["gauges"][
                "host_dispatches_per_token"])
    decode_calls = sum(e.decode_steps - d0
                       for e, (d0, _) in zip(engines, calls0))
    model_calls = decode_calls + sum(e.prefill_calls - p0
                                     for e, (_, p0) in zip(engines, calls0))
    int8kv_launches = attention.launch_counts[attention.INT8KV]
    mm_launches = quant_matmul.launch_counts[quant_matmul.KERNEL]
    mm_routes = {name: quant_matmul.launch_counts[name] for name in (
        quant_matmul.MMA, quant_matmul.MMA_UNEMBED, quant_matmul.FMA)}
    check(decode_calls > 0
          and int8kv_launches == pcfg.num_layers * decode_calls,
          f"decode_attention_int8kv launches {int8kv_launches} != "
          f"{pcfg.num_layers} layers x {decode_calls} decode model calls")
    check(mm_launches == (4 * pcfg.num_layers + 1) * model_calls,
          f"int8_matmul launches {mm_launches} != 49 x {model_calls} model "
          f"calls (prefill included)")
    check(mm_routes == {quant_matmul.MMA: 4 * pcfg.num_layers * model_calls,
                        quant_matmul.MMA_UNEMBED: model_calls,
                        quant_matmul.FMA: 0},
          f"bf16 int8 products did not all take the tensor-core kernels: "
          f"{mm_routes} for {model_calls} model calls")
    check(attention.launch_counts[attention.KERNEL] == 0
          and attention.launch_counts[attention.RAGGED] == 0,
          "the int8-KV paged path launched a float-cache attention variant")
    check(paged_runs["greedy_1"]["answers"] == paged_runs["greedy_2"]["answers"],
          "paged greedy answers changed between two runs")
    for name, run in paged_runs.items():
        emit("production_path", run=name,
             **{k: v for k, v in run.items() if k != "answers"})
    emit("production_path_kernels", int8kv_launches=int8kv_launches,
         int8_matmul_launches=mm_launches, int8_matmul_routes=mm_routes,
         decode_model_calls=decode_calls, model_calls=model_calls,
         warmup_s=paged_warm_s)
    records["production_path"] = {
        k: {kk: vv for kk, vv in v.items() if kk != "answers"}
        for k, v in paged_runs.items()}
    records["production_path_launches"] = dict(
        int8kv=int8kv_launches, int8_matmul=mm_launches,
        int8_matmul_routes=mm_routes, decode_model_calls=decode_calls,
        model_calls=model_calls)
    records["production_profile"] = profile_paged(torch, greedy_paged,
                                                  wave1 + wave2[:4])
    emit("profile_production_step", **records["production_profile"])
    deploy_wave1, deploy_wave2 = deployment_waves()
    records["production_drain"] = profile_drain(
        torch, greedy_paged, deploy_wave1 + deploy_wave2)
    emit("profile_production_drain", **records["production_drain"])
    del greedy_paged, sampled_paged

    # The paged engine in float32, int8 weights: kernel vs plain attention
    # over an int8 and over a dense cache (the latter is the run that
    # launches decode_attention_ragged).
    f32_checks = [paged_f32_check(torch, attention, PagedEngine,
                                  EngineConfig, SamplingParams, common,
                                  wave1 + wave2, kv_quant)
                  for kv_quant in (True, False)]
    for rec in f32_checks:
        emit("f32_paged_kernel_vs_plain", **rec)
    records["f32_paged_checks"] = f32_checks
    ragged_launches = f32_checks[1]["launches"]

    # 4c. The deployment config: megastep as CUDA-graph replays, fused
    # staged admission and the radix prefix cache on top of phase 4b.
    records["deployment"], deploy_refs = deployment_phase(
        torch, attention, quant_matmul, PagedEngine, PagedQueue, Metrics,
        EngineConfig, SamplingParams, prod, records["production_profile"],
        records["production_drain"])
    deploy_launches = records["deployment"]["launches"]

    # 5. gRPC: the repaired unary round trip, then streaming, sessions and
    # drain on the deployment config, under a tokenizer that decodes every
    # sampled id.
    del greedy_eng, sampled_eng
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        vocab, merges, tok_record = phase5_tokenizer(args, Path(tmp))
        emit("phase5_tokenizer", **tok_record)
        unary_eng = TutoringEngine(EngineConfig(
            sampling=SamplingParams.greedy(max_new_tokens=32),
            **dict(common, vocab_path=vocab, merges_path=merges)))
        unary_eng.warmup(batch=1)
        records["grpc"] = dict(grpc_round_trip(unary_eng, PROMPT_TEMPLATE),
                               **tok_record)
        emit("grpc", **records["grpc"])
        del unary_eng
        records["streaming"] = streaming_phase(
            torch, attention, quant_matmul, PagedEngine, EngineConfig,
            SamplingParams, prod, vocab, merges)
    emit("streaming", **records["streaming"])

    # 6. The relevance gate at bert-base width, beside phase 5's TTFT.
    records["gate"] = gate_phase(torch, attention, quant_matmul, args,
                                 records["streaming"])
    emit("gate", **records["gate"])

    # 7. Speculative decoding on the deployment config, beside phase 4c.
    window_cases = {}
    records["spec"] = spec_phase(torch, attention, quant_matmul, prod,
                                 common, deploy_refs, args, window_cases)
    spec_launches = records["spec"]["deployment"]["launches"]

    records["seconds"] = time.monotonic() - t_start
    def paged_case(int8):  # the production step's shape: 16 slots, width 384
        return next(c for c in paged_cases if c["int8"] == int8
                    and c["slots"] == 16 and c["width"] == 384
                    and c["dtype"] == "bfloat16")

    def entry(name, replaces, launches, case, **extra):
        source = ("int8_matmul" if name.startswith("int8_matmul")
                  else "decode_attention")
        return dict({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/ops/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"],
            "ms": case["kernel_us"] / 1e3, "plain_ms": case["plain_us"] / 1e3,
            "bound_ms": case["bound_us"] / 1e3,
            "bound_by": case.get("bound_by", "bytes"),
            "library_ms": (None if case["library_us"] is None
                           else case["library_us"] / 1e3),
            "eager_ms": case["kernel_eager_us"] / 1e3,
        }, **extra)

    window_note = ("SDPA, [B, 1, T, S] boolean mask (the int8 cache "
                   "dequantized beforehand)")
    bucketed_case, int8_case = window_cases["bucketed"], window_cases["int8"]
    unembed_case = next(c for c in mm_cases if c["name"] == "wte.unembed"
                        and c["m"] == 16 and c["dtype"] == "bfloat16")
    pallas = "distributed_lms_raft_llm_tpu/ops/attention.py:88"
    kernels = [
        entry("decode_attention", pallas, launches, main_case,
              n_split=main_case["n_split"]),
        entry(attention.RAGGED, pallas + " (extended: per-row lengths, the "
              "paged path's models/common.py:163 attend)", ragged_launches,
              paged_case(False), library_note=paged_case(False)[
                  "library_note"]),
        entry(attention.INT8KV, pallas + " (extended: int8 cache, the "
              "paged path's models/common.py:133 attend_quant)",
              deploy_launches[attention.INT8KV], paged_case(True),
              library_note=paged_case(True)["library_note"],
              launches_by_path={"4b": int8kv_launches,
                                "4c": deploy_launches[attention.INT8KV]}),
        entry("int8_matmul", "no Pallas kernel: distributed_lms_raft_llm_tpu/"
              "models/common.py:58 and models/quant.py:139 (XLA-fused int8 "
              "einsums)", deploy_launches[quant_matmul.KERNEL],
              dict(model_call, max_abs_err=max(c["max_abs_err"]
                                               for c in mm_cases)),
              shape="the 49 products of one decode model call, M=16, bf16",
              library_note="cuBLAS torch.matmul against weights "
              "dequantized to bf16 beforehand (the bf16 config's "
              "products)",
              launches_by_path={
                  "4b": mm_launches,
                  "4c": deploy_launches[quant_matmul.KERNEL],
                  "6": records["gate"]["int8"]["int8_matmul_launches"][
                      quant_matmul.KERNEL]}),
        entry(quant_matmul.MMA_UNEMBED, "no Pallas kernel: "
              "distributed_lms_raft_llm_tpu/models/quant.py:139 (the "
              "XLA-fused int8 unembedding einsum)",
              deploy_launches[quant_matmul.MMA_UNEMBED], unembed_case,
              launches_by_path={
                  "4b": mm_routes[quant_matmul.MMA_UNEMBED],
                  "4c": deploy_launches[quant_matmul.MMA_UNEMBED]},
              shape="the tied unembedding 50257 x 768, M=16, bf16 x, "
              "float32 logits",
              walked_bytes=unembed_case["walked_bytes"],
              library_note=unembed_case["library_note"]),
        entry(attention.WINDOW, pallas + " (extended: T = k+1 query rows "
              "a row, the speculative verify window of "
              "distributed_lms_raft_llm_tpu/models/gpt2.py:367-400)",
              records["spec"]["main_window_launches"], bucketed_case,
              library_note=window_note,
              max_row_rel_err=bucketed_case["max_row_rel_err"],
              shape=f"{bucketed_case['slots']} rows x T="
              f"{bucketed_case['t']}, width {bucketed_case['width']}, bf16 "
              "cache, padding bias (the bucketed engine, spec 8)",
              launches_path="7b, bucketed bf16 spec 8"),
        entry(attention.WINDOW_INT8KV, pallas + " (extended: T = k+1 "
              "query rows a row over the int8 cache, the paged verify "
              "window of distributed_lms_raft_llm_tpu/engine/paged.py:"
              "515-606)", spec_launches[attention.WINDOW_INT8KV],
              int8_case, library_note=window_note,
              max_row_rel_err=int8_case["max_row_rel_err"],
              shape=f"{int8_case['slots']} slots x T={int8_case['t']}, "
              f"width {int8_case['width']}, int8 cache, bf16 q",
              launches_path="7c, the deployment with spec 8"),
    ]
    records["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
