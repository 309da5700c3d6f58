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
3b. the paged path's kernels the same way: decode attention with per-row
   lengths over a float and an int8 cache (8 and 16 slots, widths 160 and
   384, lengths spread over [1, width], splits left empty), and the int8
   weight-only matmul at GPT-2 small's five products for M = 1, 16, 256 in
   bf16 and float32, plus the 49 products of one decode model call;
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
   49 x model calls; tokens/s, mean TTFT, and a `torch.profiler` window
   (device busy share); then the paged engine in float32 with int8 weights,
   with an int8 and with a dense cache, kernel-path greedy tokens equal to
   the plain attention path's;
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


# GPT-2 small's int8 products: name -> (K, N, transposed).
INT8_PRODUCTS = {
    "attn.wqkv": (768, 2304, False),
    "mlp.wi": (768, 3072, False),
    "attn.wo": (768, 768, False),
    "mlp.wo": (3072, 768, False),
    "wte.unembed": (768, 50257, True),
}
# Tolerances of the int8 matmul against its plain version, relative to
# each element (rtol) and to the output's largest magnitude (atol). float32
# (and the float32 unembedding): the summation order over K. bf16: the
# plain version rounds to bf16 after the product, the scale and the bias,
# the kernel once.
INT8_MATMUL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1e-2)}


def int8_weights(torch, quant, name, n_layers, seed):
    """Seeded int8 weights of one product, stacked over the layers as the
    model holds them (the unembedding table once): (q, s, b, K, N,
    transposed)."""
    k, n, transposed = INT8_PRODUCTS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if transposed:
        w = quant.quantize_embedding(
            torch.randn((n, k), generator=gen, device="cuda") * 0.02)
        return w["q"][None], w["s"][None], None, k, n, True
    w = quant.quantize_array(
        torch.randn((n_layers, k, n), generator=gen, device="cuda") * 0.02)
    b = torch.randn((n_layers, n), generator=gen, device="cuda") * 0.02
    return w["q"], w["s"], b, k, n, False


def int8_matmul_case(torch, quant, quant_matmul, *, name, m, dtype,
                     n_layers=12, seed=0):
    """The int8 kernel against its plain version at one product and M, its
    layers walked by consecutive timed calls; cuBLAS against the weight
    dequantized to x's dtype beforehand as the yardstick."""
    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    q, s, b, k, n, transposed = int8_weights(torch, quant, name, n_layers,
                                             seed)
    layers = q.shape[0]
    x = torch.randn((m, k), generator=torch.Generator(device="cuda")
                    .manual_seed(seed + 1), device="cuda").to(dt)
    bias = [None if b is None else b[i].to(dt) for i in range(layers)]
    got = quant_matmul.int8_matmul(x, q[0], s[0], bias[0],
                                   transposed=transposed)
    want = quant_matmul.int8_matmul_reference(x, q[0], s[0], bias[0],
                                              transposed)
    torch.cuda.synchronize()
    rtol, atol = INT8_MATMUL_TOL["float32" if transposed else dtype]
    atol *= want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    check(bool((diff <= atol + rtol * want.float().abs()).all()),
          f"int8_matmul disagrees with its plain version at {name} m={m} "
          f"{dtype}: max abs err {err} (rtol {rtol}, atol {atol})")
    es = torch.finfo(dt).bits // 8
    out_es = 4 if transposed else es
    n_bytes = (m * k * es + k * n + 4 * n + (0 if transposed else n * es)
               + m * n * out_es)
    n_ops = 2 * m * k * n
    t_bytes, t_ops = (n_bytes / H100_HBM_BYTES_PER_S,
                      n_ops / PEAK_OPS_PER_S[dtype])
    deq = [(q[i].to(dt) * s[i].to(dt)[:, None]).t() if transposed
           else q[i].to(dt) * s[i].to(dt)[None, :] for i in range(layers)]

    def kernel(i):
        quant_matmul.int8_matmul(x, q[i % layers], s[i % layers],
                                 bias[i % layers], transposed=transposed)

    def plain(i):
        quant_matmul.int8_matmul_reference(x, q[i % layers], s[i % layers],
                                           bias[i % layers], transposed)

    def library(i):
        torch.matmul(x, deq[i % layers])

    return dict(name=name, m=m, k=k, n=n, transposed=transposed,
                dtype=dtype, layers_walked=layers, max_abs_err=err,
                rtol=rtol, atol=atol, bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                kernel_us=time_graph_us(kernel),
                kernel_eager_us=time_eager_us(kernel),
                plain_us=time_graph_us(plain),
                library_us=time_graph_us(library),
                library_note="cuBLAS torch.matmul against the weight "
                "dequantized to x's dtype beforehand (the bf16 config's "
                "product)")


def int8_model_call(torch, quant, quant_matmul, *, m=16, dtype="bfloat16",
                    n_layers=12):
    """The 49 int8 products of one decode model call (4 a layer x 12, then
    the unembedding), in the model's order, timed as one unit: kernel,
    plain, cuBLAS against pre-dequantized weights, and the summed bound."""
    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    weights = {}
    for seed, name in enumerate(INT8_PRODUCTS):
        q, s, b, k, n, tr = int8_weights(torch, quant, name, n_layers, seed)
        weights[name] = (q, s, None if b is None else b.to(dt), k, n, tr)
    xs = {768: torch.randn((m, 768), device="cuda").to(dt),
          3072: torch.randn((m, 3072), device="cuda").to(dt)}
    order = [(name, i) for i in range(n_layers)
             for name in ("attn.wqkv", "attn.wo", "mlp.wi", "mlp.wo")]
    order.append(("wte.unembed", 0))
    bound_us = 0.0
    es = torch.finfo(dt).bits // 8
    for name, _ in order:
        _, _, _, k, n, tr = weights[name]
        n_bytes = (m * k * es + k * n + 4 * n + (0 if tr else n * es)
                   + m * n * (4 if tr else es))
        bound_us += max(n_bytes / H100_HBM_BYTES_PER_S,
                        2 * m * k * n / PEAK_OPS_PER_S[dtype]) * 1e6
    deq = {}
    for name, (q, s, b, k, n, tr) in weights.items():
        deq[name] = [(q[i].to(dt) * s[i].to(dt)[:, None]).t() if tr
                     else (q[i].to(dt) * s[i].to(dt)[None, :])
                     for i in range(q.shape[0])]

    def run(fn):
        def call(_):
            for name, i in order:
                q, s, b, k, _, tr = weights[name]
                fn(xs[k], q[i], s[i], None if b is None else b[i], tr,
                   deq[name][i])
        return call

    kernel = run(lambda x, q, s, b, tr, d: quant_matmul.int8_matmul(
        x, q, s, b, transposed=tr))
    plain = run(lambda x, q, s, b, tr, d:
                quant_matmul.int8_matmul_reference(x, q, s, b, tr))
    library = run(lambda x, q, s, b, tr, d: torch.matmul(x, d))
    return dict(m=m, dtype=dtype, products=len(order), bound_us=bound_us,
                kernel_us=time_graph_us(kernel, iters=5),
                kernel_eager_us=time_eager_us(kernel, iters=5),
                plain_us=time_graph_us(plain, iters=5),
                library_us=time_graph_us(library, iters=5))


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


def run_paged_waves(engine, paged_queue_cls, metrics_cls, wave1, wave2):
    """Wave 1 through one PagedQueue; wave 2 submitted once the engine has
    dispatched wave 1's first decode step. Returns (answers in submit
    order, wall seconds, the queue's metrics snapshot)."""
    metrics = metrics_cls()

    async def go():
        queue = paged_queue_cls(engine, metrics=metrics)
        await queue.start()
        try:
            first = [asyncio.ensure_future(queue.submit(p)) for p in wave1]
            steps0 = engine.decode_steps
            while engine.decode_steps == steps0:
                await asyncio.sleep(0.002)
            second = [asyncio.ensure_future(queue.submit(p)) for p in wave2]
            return await asyncio.gather(*first, *second)
        finally:
            await queue.close()

    t0 = time.monotonic()
    answers = asyncio.run(go())
    return answers, time.monotonic() - t0, metrics.snapshot()


def profile_paged(torch, engine, prompts, steps=2) -> dict:
    """Where a steady paged step's time goes: the slots filled, the
    pipeline full, `steps` step() calls timed without the profiler, then
    `steps` more under `torch.profiler`. Device busy share = summed kernel
    time over the unprofiled wall of the same number of steps."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.submit(p)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    engine.drain()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())

    def of(part):
        return (sum(us for name, (us, _) in by_name.items() if part in name),
                sum(n for name, (_, n) in by_name.items() if part in name))

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "steps": steps, "chunk": engine.chunk, "slots": engine.slots,
        "wall_us": wall_us, "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_launched": sum(n for _, n in by_name.values()),
        "int8_matmul_us_launches": of("int8_matmul"),
        "decode_attention_us_launches": of("decode_attention"),
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


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
            slots=16, chunk=16, inflight=3)
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
    from distributed_lms_raft_llm_tpu_torch.models import quant
    from distributed_lms_raft_llm_tpu_torch.ops import (
        attention,
        build,
        quant_matmul,
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
        for name in INT8_PRODUCTS:
            for m in (1, 16, 256):
                mm_cases.append(int8_matmul_case(
                    torch, quant, quant_matmul, name=name, m=m, dtype=dtype))
                emit("int8_matmul_case", **mm_cases[-1])
    records["int8_matmul_cases"] = mm_cases
    model_call = int8_model_call(torch, quant, quant_matmul)
    emit("int8_matmul_model_call", **model_call)
    records["int8_matmul_model_call"] = model_call

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
    paged_kw = dict(slots=16, chunk=16, inflight=3)
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
    check(decode_calls > 0
          and int8kv_launches == pcfg.num_layers * decode_calls,
          f"decode_attention_int8kv launches {int8kv_launches} != "
          f"{pcfg.num_layers} layers x {decode_calls} decode model calls")
    check(mm_launches == (4 * pcfg.num_layers + 1) * model_calls,
          f"int8_matmul launches {mm_launches} != 49 x {model_calls} model "
          f"calls (prefill included)")
    check(attention.launch_counts[attention.KERNEL] == 0
          and attention.launch_counts[attention.RAGGED] == 0,
          "the int8-KV paged path launched a float-cache attention variant")
    check(paged_runs["greedy_1"]["answers"] == paged_runs["greedy_2"]["answers"],
          "paged greedy answers changed between two runs")
    for name, run in paged_runs.items():
        emit("production_path", run=name,
             **{k: v for k, v in run.items() if k != "answers"})
    emit("production_path_kernels", int8kv_launches=int8kv_launches,
         int8_matmul_launches=mm_launches, decode_model_calls=decode_calls,
         model_calls=model_calls, warmup_s=paged_warm_s)
    records["production_path"] = {
        k: {kk: vv for kk, vv in v.items() if kk != "answers"}
        for k, v in paged_runs.items()}
    records["production_path_launches"] = dict(
        int8kv=int8kv_launches, int8_matmul=mm_launches,
        decode_model_calls=decode_calls, model_calls=model_calls)
    records["production_profile"] = profile_paged(torch, greedy_paged,
                                                  wave1 + wave2[:4])
    emit("profile_production_step", **records["production_profile"])
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

    # 5. gRPC round trip, when grpc is installed.
    have_grpc = all(importlib.util.find_spec(m) is not None
                    for m in ("grpc", "google.protobuf"))
    print(f"grpc_phase: {'ran' if have_grpc else 'skipped (grpc not importable)'}",
          flush=True)
    if have_grpc:
        records["grpc"] = grpc_round_trip(greedy_eng, PROMPT_TEMPLATE)
        emit("grpc", **records["grpc"])

    records["seconds"] = time.monotonic() - t_start
    def paged_case(int8):  # the production step's shape: 16 slots, width 384
        return next(c for c in paged_cases if c["int8"] == int8
                    and c["slots"] == 16 and c["width"] == 384
                    and c["dtype"] == "bfloat16")

    def entry(name, replaces, launches, case, **extra):
        return dict({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/ops/csrc/"
                      f"{'int8_matmul' if name == 'int8_matmul' else 'decode_attention'}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"],
            "ms": case["kernel_us"] / 1e3, "plain_ms": case["plain_us"] / 1e3,
            "bound_ms": case["bound_us"] / 1e3,
            "bound_by": case.get("bound_by", "bytes"),
            "library_ms": (None if case["library_us"] is None
                           else case["library_us"] / 1e3),
            "eager_ms": case["kernel_eager_us"] / 1e3,
        }, **extra)

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
              int8kv_launches, paged_case(True), library_note=paged_case(
                  True)["library_note"]),
        entry("int8_matmul", "no Pallas kernel: distributed_lms_raft_llm_tpu/"
              "models/common.py:58 and models/quant.py:139 (XLA-fused int8 "
              "einsums)", mm_launches,
              dict(model_call, max_abs_err=max(c["max_abs_err"]
                                               for c in mm_cases)),
              shape="the 49 products of one decode model call, M=16, bf16",
              library_note="cuBLAS torch.matmul against weights "
              "dequantized to bf16 beforehand (the bf16 config's "
              "products)"),
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
