#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out FILE] [--checkpoint F --vocab F --merges F]

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (`nvidia-smi` name and power limit) and the torch build;
2. build every kernel of the port from this checkout's sources;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the tutoring path gives it (batch 1-8 x windows 33, 320, 384,
   GPT-2's full 1024, GQA, rows padded to their last slot, a window of a
   larger cache, q strided as the model passes it), with the launch plan
   (`n_split`), kernel, eager-call, plain-version and library-call times
   beside the least time the card could take;
4. the main path: `BatchingQueue` -> `TutoringEngine` (GPT-2 small at full
   width, bf16, seeded random weights unless a checkpoint is given)
   answering 8 concurrent tutoring questions, greedy twice and once with
   the reference sampling defaults; the kernels' launch counters must show
   that the path ran through them; greedy tokens of the kernel path must
   equal the plain path's in float32; one more greedy device batch runs
   under `torch.profiler` (device busy share, kernel time by name);
5. when `grpc` imports: one `GetLLMAnswer` round trip through the port's
   tutoring server on 127.0.0.1.

The last two lines of standard output are the `kernels` JSON record and
the `{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import math
import subprocess
import sys
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
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
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


def grpc_round_trip(engine, prompt_template) -> dict:
    """One GetLLMAnswer through the port's server on 127.0.0.1."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
        serve_async,
    )

    query = QUESTIONS[0]

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

    resp, trailer = asyncio.run(go())
    direct = engine.answer_batch([prompt_template.format(query=query)])[0]
    check(resp.success and resp.response == direct.strip(),
          "gRPC GetLLMAnswer differs from the engine's direct answer")
    check(trailer.get("x-served-by") == "chip-smoke",
          "x-served-by trailer missing")
    return {"success": resp.success, "chars": len(resp.response)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--merges", default=None)
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
    from distributed_lms_raft_llm_tpu_torch.ops import attention, build

    t0 = time.monotonic()
    build.build_all([attention.KERNEL])
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

    # 4. The main path.
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

    # 5. gRPC round trip, when grpc is installed.
    have_grpc = all(importlib.util.find_spec(m) is not None
                    for m in ("grpc", "google.protobuf"))
    print(f"grpc_phase: {'ran' if have_grpc else 'skipped (grpc not importable)'}",
          flush=True)
    if have_grpc:
        records["grpc"] = grpc_round_trip(greedy_eng, PROMPT_TEMPLATE)
        emit("grpc", **records["grpc"])

    records["seconds"] = time.monotonic() - t_start
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": f"{PACKAGE}/ops/csrc/decode_attention.cu",
        "replaces": "distributed_lms_raft_llm_tpu/ops/attention.py:88",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_us"] / 1e3,
        "plain_ms": main_case["plain_us"] / 1e3,
        "bound_ms": main_case["bound_us"] / 1e3,
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_us"] / 1e3,
        "n_split": main_case["n_split"],
        "eager_ms": main_case["kernel_eager_us"] / 1e3,
    }]
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
