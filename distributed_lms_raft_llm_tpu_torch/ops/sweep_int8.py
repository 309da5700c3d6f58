"""Time the int8 weight-only matmul at GPT-2 small's, Llama-3-8B's and
gpt2-moe's products on the card.

    python -m distributed_lms_raft_llm_tpu_torch.ops.sweep_int8 \\
        [--dtype bfloat16] [--m 1,16,256] [--splits] [--plans] [--llama]
        [--moe] [--out FILE]

For each product (attn.wqkv, mlp.wi, attn.wo, mlp.wo, the tied
unembedding) and each M: the kernel against its plain version, then the
kernel's device time (CUDA-graph replay), its eager time (the Python
wrapper included), the plain version's, and cuBLAS (`torch.matmul`)
against the weight dequantized to x's dtype beforehand, beside the least
time the card could take. Where bf16 x takes the wgmma route (from
`quant_matmul.WGMMA_MIN_ROWS` rows), the route it replaced there
(`int8_matmul_replaced`, the mma.sync tiles) is checked against the
plain version too and timed beside it (`replaced_us`). Consecutive timed
calls walk distinct copies of the weight, more than 100 MB of them, so
the 50 MB L2 cannot hold what the next call reads; the dequantized copies
are walked the same way. Then the 49 products of one decode model call
(12 layers of distinct weights, 124 MB). The relevance gate's products
too: BERT-base's four products have GPT-2 small's dense shapes, at the
gate's rows (texts x length bucket, GATE_ROWS), then one int8 gate
forward's 48 products at each of those M. The scoring tenant's rows
(SCORE_ROWS) through all five. With `--llama`: Llama-3-8B's seven
products and its untied 128,256 x 4,096 unembedding (LLAMA_PRODUCTS) at
LLAMA_ROWS instead, the deep ones through the x-staged plans. With
`--moe`: gpt2-moe's two expert products (8 experts,
`int8_matmul_experts`, one launch for all) at MOE_CAPACITIES rows an
expert instead, `torch.bmm` over the dequantized experts as the
yardstick. With `--splits`: the dense products at M=16 at each forced K
split instead. With `--plans`: the wgmma route at PLAN_CASES under each
plan `quant_matmul.wgmma_plans` offers instead. One JSON line a case,
then the card's `nvidia-smi` name and power limit.

Uses only `quant_matmul`'s wrappers, routes and plans, the quantizers and
`ops/timing.py`, so the file can be copied beside another checkout's
package that has them to time that checkout's kernels in the same call.
`chip_smoke.py` runs the same cases. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

from ..models import quant
from . import quant_matmul
from .timing import time_eager_us, time_graph_us

H100_HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TF32
WALK_BYTES = 100e6                   # weights walked by consecutive calls

# GPT-2 small's int8 products: name -> (K, N, transposed).
INT8_PRODUCTS = {
    "attn.wqkv": (768, 2304, False),
    "mlp.wi": (768, 3072, False),
    "attn.wo": (768, 768, False),
    "mlp.wo": (3072, 768, False),
    "wte.unembed": (768, 50257, True),
}
# Llama-3-8B's int8 products (meta-llama/Meta-Llama-3-8B config.json: width
# 4,096, 8 KV heads of 128, intermediate 14,336, vocabulary 128,256, untied
# lm_head): name -> (K, N, transposed).
LLAMA_PRODUCTS = {
    "llama.wq": (4096, 4096, False),
    "llama.wk": (4096, 1024, False),
    "llama.wv": (4096, 1024, False),
    "llama.wo": (4096, 4096, False),
    "llama.wg": (4096, 14336, False),
    "llama.wu": (4096, 14336, False),
    "llama.wd": (14336, 4096, False),
    "llama.lm_head": (4096, 128256, True),
}
# Its rows: decode (16 slots), the fused admission chunk (32), the scoring
# quanta at buckets 64 and 256 (512, 2,048).
LLAMA_ROWS = (16, 32, 512, 2048)
# The same products on one of two tensor-parallel ranks
# (parallel/partition.py LLAMA_RULES): column-parallel halves of N (wq, wk,
# wv, wg, wu, and lm_head's vocabulary rows) and row-parallel halves of K
# (wo, wd), which chip_smoke.py's phase 14 times: name -> (K, N,
# transposed).
LLAMA_TP2_PRODUCTS = {
    "llama.tp2.wq": (4096, 2048, False),
    "llama.tp2.wk": (4096, 512, False),
    "llama.tp2.wv": (4096, 512, False),
    "llama.tp2.wo": (2048, 4096, False),
    "llama.tp2.wg": (4096, 7168, False),
    "llama.tp2.wu": (4096, 7168, False),
    "llama.tp2.wd": (7168, 4096, False),
    "llama.tp2.lm_head": (4096, 64128, True),
}
# GPT-2 medium's int8 products (width 1,024, 16 heads; the published
# GPT-2 family's config): name -> (K, N, transposed).
MEDIUM_PRODUCTS = {
    "medium.attn.wqkv": (1024, 3072, False),
    "medium.mlp.wi": (1024, 4096, False),
    "medium.attn.wo": (1024, 1024, False),
    "medium.mlp.wo": (4096, 1024, False),
    "medium.wte.unembed": (1024, 50257, True),
}
# BERT-base's four products on one of two tensor-parallel ranks of the
# relevance gate (parallel/partition.py BERT_RULES): the column-parallel
# halves of N (wqkv, mlp.wi) and the row-parallel halves of K (attn.wo,
# mlp.wo), which chip_smoke.py's phase 15 times at GATE_ROWS: name ->
# (K, N, transposed).
BERT_TP2_PRODUCTS = {
    "bert.tp2.attn.wqkv": (768, 1152, False),
    "bert.tp2.mlp.wi": (768, 1536, False),
    "bert.tp2.attn.wo": (384, 768, False),
    "bert.tp2.mlp.wo": (1536, 768, False),
}
PRODUCTS = {**INT8_PRODUCTS, **LLAMA_PRODUCTS, **LLAMA_TP2_PRODUCTS,
            **MEDIUM_PRODUCTS, **BERT_TP2_PRODUCTS}
# gpt2-moe's expert products (GPT-2 small's trunk, 8 experts of GPT-2
# small's MLP, top-2, capacity factor 1.25): name -> (K, N), each of
# MOE_EXPERTS experts, through `int8_matmul_experts`.
EXPERT_PRODUCTS = {"moe.wi": (768, 3072), "moe.wo": (3072, 768)}
MOE_EXPERTS = 8
# Their rows an expert, C = ceil(1.25 x 2 S / 8): decode at 16 slots (S =
# 16), a 32-token admission chunk, a 256-token prefill and a scoring
# quantum of 8 x 256 (S = 2,048).
MOE_CAPACITIES = (5, 10, 80, 640)
# The experts one of two expert-parallel ranks holds (E / ep, phase 15).
MOE_EP2_EXPERTS = MOE_EXPERTS // 2
# The relevance gate's rows M = texts x length bucket: a check's forward
# holds 1 or 2 texts in a bucket of 64 to 512 tokens, so M runs from 64 to
# 1,024; the two ends of the product sweep beside decode's and prefill's.
GATE_ROWS = (128, 1024)
GATE_PRODUCTS = tuple(name for name, (_, _, transposed)
                      in INT8_PRODUCTS.items() if not transposed)
# The scoring tenant's rows: a quantum of 8 texts at length buckets 64 (the
# bulk corpus's 48-token texts) and 256 (the widest), M = 512 and 2,048,
# through all five products.
SCORE_ROWS = (512, 2048)

# Tolerances of the int8 matmul against its plain version, relative to
# each element (rtol) and to the output's largest magnitude (atol). float32
# and the float32 logits: the summation order over K (bf16 x int8 products
# are exact in float32). bf16 dense: the plain version rounds to bf16 after
# the product, the scale and the bias, the kernel once.
INT8_MATMUL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1e-2)}


class Mismatch(AssertionError):
    pass


def int8_weights(name, n_layers, seed):
    """Seeded int8 weights of one product, stacked over the layers as the
    model holds them (the unembedding table once): (q, s, b, K, N,
    transposed)."""
    k, n, transposed = PRODUCTS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if transposed:
        w = quant.quantize_embedding(
            torch.randn((n, k), generator=gen, device="cuda") * 0.02)
        return w["q"][None], w["s"][None], None, k, n, True
    w = quant.quantize_array(
        torch.randn((n_layers, k, n), generator=gen, device="cuda") * 0.02)
    b = torch.randn((n_layers, n), generator=gen, device="cuda") * 0.02
    return w["q"], w["s"], b, k, n, False


def product_bytes_ops(m, k, n, transposed, dtype):
    """What one product must move and compute: x read, the int8 weight,
    its scales and a dense bias read once, y written once; 2 M K N
    operations."""
    es = torch.finfo(getattr(torch, dtype)).bits // 8
    n_bytes = (m * k * es + k * n + 4 * n + (0 if transposed else n * es)
               + m * n * (4 if transposed else es))
    return n_bytes, 2 * m * k * n


def bound(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_matmul_case(*, name, m, dtype, n_layers=12, seed=0):
    """The kernel against its plain version at one product and M, then
    timed over distinct weight copies (more than WALK_BYTES); cuBLAS
    against the weight dequantized to x's dtype beforehand as the
    yardstick. Raises Mismatch if the kernel disagrees. Draws no more
    layers than the walk needs (Llama's products are 4-59 MB each)."""
    dt = getattr(torch, dtype)
    k, n, _ = PRODUCTS[name]
    copies = math.floor(WALK_BYTES / (k * n)) + 1
    q1, s1, b1, k, n, transposed = int8_weights(name, min(n_layers, copies),
                                                seed)
    reps = -(-copies // q1.shape[0])
    q = q1.repeat(reps, 1, 1)[:copies].contiguous()  # distinct memory
    s = s1.repeat(reps, 1)[:copies].contiguous()
    del q1, s1
    x = torch.randn((m, k), generator=torch.Generator(device="cuda")
                    .manual_seed(seed + 1), device="cuda").to(dt)
    bias = [None if b1 is None else b1[i % b1.shape[0]].to(dt)
            for i in range(copies)]
    route = _route(m, dtype, transposed)
    before = quant_matmul.launch_counts[route]
    got = quant_matmul.int8_matmul(x, q[0], s[0], bias[0],
                                   transposed=transposed)
    launched = quant_matmul.launch_counts[route] - before
    want = quant_matmul.int8_matmul_reference(x, q[0], s[0], bias[0],
                                              transposed)
    torch.cuda.synchronize()
    rtol, atol = INT8_MATMUL_TOL["float32" if transposed else dtype]
    atol *= want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if launched != 1 or not bool(
            (diff <= atol + rtol * want.float().abs()).all()):
        raise Mismatch(f"int8_matmul disagrees with its plain version at "
                       f"{name} m={m} {dtype}: max abs err {err} (rtol "
                       f"{rtol}, atol {atol}), {launched} launches on "
                       f"{route}")
    replaced = route in (quant_matmul.WGMMA, quant_matmul.WGMMA_UNEMBED)
    old_err = None
    if replaced:
        old = quant_matmul.int8_matmul_replaced(x, q[0], s[0], bias[0],
                                                transposed=transposed)
        again = quant_matmul.int8_matmul(x, q[0], s[0], bias[0],
                                         transposed=transposed)
        torch.cuda.synchronize()
        old_diff = (old.float() - want.float()).abs()
        old_err = old_diff.max().item()
        if not bool((old_diff <= atol + rtol * want.float().abs()).all()):
            raise Mismatch(f"the replaced route disagrees with the plain "
                           f"version at {name} m={m}: max abs err {old_err}")
        if not torch.equal(got, again):
            raise Mismatch(f"two wgmma calls differ at {name} m={m}")
    n_bytes, n_ops = product_bytes_ops(m, k, n, transposed, dtype)
    bound_us, bound_by = bound(n_bytes, n_ops, dtype)
    deq = [(q[i].to(dt) * s[i].to(dt)[:, None]).t() if transposed
           else q[i].to(dt) * s[i].to(dt)[None, :] for i in range(copies)]
    iters = max(50, copies)

    def kernel(i):
        quant_matmul.int8_matmul(x, q[i % copies], s[i % copies],
                                 bias[i % copies], transposed=transposed)

    def plain(i):
        quant_matmul.int8_matmul_reference(x, q[i % copies], s[i % copies],
                                           bias[i % copies], transposed)

    def library(i):
        torch.matmul(x, deq[i % copies])

    def old_route(i):
        quant_matmul.int8_matmul_replaced(x, q[i % copies], s[i % copies],
                                          bias[i % copies],
                                          transposed=transposed)

    rec = dict(name=name, m=m, k=k, n=n, transposed=transposed, dtype=dtype,
               route=route, plan=_plan(m, k, n, transposed, dtype),
               copies_walked=copies, walked_bytes=copies * k * n,
               library_walked_bytes=copies * k * n * deq[0].element_size(),
               max_abs_err=err, rtol=rtol, atol=atol, bound_us=bound_us,
               bound_by=bound_by,
               kernel_us=time_graph_us(kernel, iters=iters),
               kernel_eager_us=time_eager_us(kernel, iters=iters),
               plain_us=time_graph_us(plain, iters=iters),
               library_us=time_graph_us(library, iters=iters),
               library_note="cuBLAS torch.matmul against the weight "
               "dequantized to x's dtype beforehand (the bf16 config's "
               "product)")
    rec["replaced_us"] = (time_graph_us(old_route, iters=iters) if replaced
                          else None)
    rec["replaced_max_abs_err"] = old_err
    rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
    return rec


def _route(rows, dtype, transposed, experts=False):
    """The launch counter a call of `rows` rows (of each expert) moves."""
    if dtype != "bfloat16":
        return (quant_matmul.FMA_EXPERTS if experts else quant_matmul.FMA)
    if quant_matmul.uses_wgmma(rows):
        return (quant_matmul.WGMMA_EXPERTS if experts else
                quant_matmul.WGMMA_UNEMBED if transposed else
                quant_matmul.WGMMA)
    return (quant_matmul.MMA_EXPERTS if experts else
            quant_matmul.MMA_UNEMBED if transposed else quant_matmul.MMA)


def _plan(rows, k, n, transposed, dtype, experts=1):
    """The bf16 route's launch plan, as a record (None for float32)."""
    if dtype != "bfloat16":
        return None
    if quant_matmul.uses_wgmma(rows):
        p = quant_matmul.wgmma_plan(rows, k, n, transposed, experts=experts)
        return dict(route="wgmma", bn=p.bn, splits=p.splits, grid=p.grid,
                    stages=p.stages, k_stages=p.k_stages, tiles=p.tiles)
    p = quant_matmul.launch_plan(rows, k, n, transposed, experts=experts)
    return dict(route="mma", mt=p.mt, grid=list(p.grid), splits=p.splits,
                stages=p.stages, x_staged=p.x_staged)


def expert_bytes_ops(e, c, k, n, dtype):
    """What one expert product must move and compute: x, every expert's
    int8 weight, scales and bias read once, y written once (every expert
    is computed, routed rows or not); 2 E C K N operations."""
    es = torch.finfo(getattr(torch, dtype)).bits // 8
    return (e * c * k * es + e * k * n + 4 * e * n + e * n * es
            + e * c * n * es), 2 * e * c * k * n


def int8_experts_case(*, name, c, dtype, experts=MOE_EXPERTS, seed=0):
    """`int8_matmul_experts` against its plain version at one expert
    product and C rows an expert (one launch, on the expert route of the
    dtype), then timed over distinct copies of all E experts' weights
    (more than WALK_BYTES); the yardstick is `torch.bmm` against the
    experts dequantized to x's dtype beforehand. The tolerances of
    `int8_matmul_case`. Raises Mismatch if the kernel disagrees."""
    dt = getattr(torch, dtype)
    k, n = EXPERT_PRODUCTS[name]
    copies = math.floor(WALK_BYTES / (experts * k * n)) + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = quant.quantize_array(torch.randn((copies, experts, k, n),
                                         generator=gen, device="cuda") * 0.02)
    q, s = w["q"], w["s"]
    b = (torch.randn((copies, experts, n), generator=gen, device="cuda")
         * 0.02).to(dt)
    x = torch.randn((experts, c, k), generator=gen, device="cuda").to(dt)
    route = _route(c, dtype, False, experts=True)
    before = quant_matmul.launch_counts[route]
    got = quant_matmul.int8_matmul_experts(x, q[0], s[0], b[0])
    launched = quant_matmul.launch_counts[route] - before
    want = quant_matmul.int8_matmul_experts_reference(x, q[0], s[0], b[0])
    torch.cuda.synchronize()
    rtol, atol = INT8_MATMUL_TOL[dtype]
    atol *= want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if launched != 1 or not bool(
            (diff <= atol + rtol * want.float().abs()).all()):
        raise Mismatch(f"int8_matmul_experts disagrees with its plain "
                       f"version at {name} C={c} {dtype}: max abs err {err} "
                       f"(rtol {rtol}, atol {atol}), {launched} launches")
    replaced = route == quant_matmul.WGMMA_EXPERTS
    old_err = None
    if replaced:
        old = quant_matmul.int8_matmul_replaced(x, q[0], s[0], b[0],
                                                experts=True)
        again = quant_matmul.int8_matmul_experts(x, q[0], s[0], b[0])
        torch.cuda.synchronize()
        old_diff = (old.float() - want.float()).abs()
        old_err = old_diff.max().item()
        if not bool((old_diff <= atol + rtol * want.float().abs()).all()):
            raise Mismatch(f"the replaced expert route disagrees with the "
                           f"plain version at {name} C={c}: max abs err "
                           f"{old_err}")
        if not torch.equal(got, again):
            raise Mismatch(f"two wgmma expert calls differ at {name} C={c}")
    n_bytes, n_ops = expert_bytes_ops(experts, c, k, n, dtype)
    bound_us, bound_by = bound(n_bytes, n_ops, dtype)
    deq = [q[i].to(dt) * s[i].to(dt)[:, None, :] for i in range(copies)]
    iters = max(50, copies)

    def kernel(i):
        quant_matmul.int8_matmul_experts(x, q[i % copies], s[i % copies],
                                         b[i % copies])

    def plain(i):
        quant_matmul.int8_matmul_experts_reference(
            x, q[i % copies], s[i % copies], b[i % copies])

    def library(i):
        torch.bmm(x, deq[i % copies])

    def old_route(i):
        quant_matmul.int8_matmul_replaced(x, q[i % copies], s[i % copies],
                                          b[i % copies], experts=True)

    rec = dict(name=name, experts=experts, c=c, m=experts * c, k=k, n=n,
               dtype=dtype, route=route, copies_walked=copies,
               walked_bytes=copies * experts * k * n,
               max_abs_err=err, rtol=rtol, atol=atol, bound_us=bound_us,
               bound_by=bound_by,
               plan=_plan(c, k, n, False, dtype, experts=experts),
               kernel_us=time_graph_us(kernel, iters=iters),
               kernel_eager_us=time_eager_us(kernel, iters=iters),
               plain_us=time_graph_us(plain, iters=iters),
               library_us=time_graph_us(library, iters=iters),
               library_note="torch.bmm against all experts dequantized to "
               "x's dtype beforehand")
    rec["replaced_us"] = (time_graph_us(old_route, iters=iters) if replaced
                          else None)
    rec["replaced_max_abs_err"] = old_err
    rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
    return rec


def int8_model_call(*, m=16, dtype="bfloat16", n_layers=12, unembed=True):
    """The 49 int8 products of one decode model call (4 a layer x 12, then
    the unembedding; without `unembed` the 48 of a BERT-base forward), in
    the model's order, timed as one unit: kernel, plain, cuBLAS against
    pre-dequantized weights, the replaced route where the wgmma one runs,
    and the summed bound."""
    dt = getattr(torch, dtype)
    weights = {}
    for seed, name in enumerate(INT8_PRODUCTS):
        q, s, b, k, n, tr = int8_weights(name, n_layers, seed)
        weights[name] = (q, s, None if b is None else b.to(dt), k, n, tr)
    xs = {768: torch.randn((m, 768), device="cuda").to(dt),
          3072: torch.randn((m, 3072), device="cuda").to(dt)}
    order = [(name, i) for i in range(n_layers)
             for name in ("attn.wqkv", "attn.wo", "mlp.wi", "mlp.wo")]
    if unembed:
        order.append(("wte.unembed", 0))
    bound_us = 0.0
    for name, _ in order:
        _, _, _, k, n, tr = weights[name]
        bound_us += bound(*product_bytes_ops(m, k, n, tr, dtype), dtype)[0]
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
    old_route = run(lambda x, q, s, b, tr, d:
                    quant_matmul.int8_matmul_replaced(x, q, s, b,
                                                      transposed=tr))
    replaced = dtype == "bfloat16" and quant_matmul.uses_wgmma(m)
    rec = dict(m=m, dtype=dtype, products=len(order), bound_us=bound_us,
               kernel_us=time_graph_us(kernel, iters=5),
               kernel_eager_us=time_eager_us(kernel, iters=5),
               plain_us=time_graph_us(plain, iters=5),
               library_us=time_graph_us(library, iters=5),
               replaced_us=(time_graph_us(old_route, iters=5) if replaced
                            else None))
    rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
    return rec


def split_sweep(*, m=16, dtype="bfloat16"):
    """The dense products' kernel time at each forced K split (1, 2, 4, 8
    blocks a cluster), the launch plan swapped in for the sweep: the trade
    behind `quant_matmul.launch_plan`'s split rule. One record a product
    and split."""
    import functools

    orig = quant_matmul.launch_plan
    records = []
    try:
        for name, (k, n, transposed) in INT8_PRODUCTS.items():
            if transposed:
                continue
            for splits in (1, 2, 4, 8):
                quant_matmul.launch_plan = functools.partial(orig,
                                                             splits=splits)
                quant_matmul._layouts.clear()
                rec = int8_matmul_case(name=name, m=m, dtype=dtype)
                records.append(dict(
                    name=name, m=m, splits=splits,
                    blocks=-(-n // quant_matmul.DENSE_COLS) * splits,
                    kernel_us=rec["kernel_us"], library_us=rec["library_us"],
                    max_abs_err=rec["max_abs_err"]))
    finally:
        quant_matmul.launch_plan = orig
        quant_matmul._layouts.clear()
    return records


# The wgmma route's plan sweep: products and rows where the plan's choice
# between tile heights and K splits is closest.
PLAN_CASES = [(name, m) for name in INT8_PRODUCTS for m in (32, 128, 512,
                                                            2048)]
PLAN_CASES += [("llama.wq", 32), ("llama.wd", 512), ("llama.wg", 2048)]


def plan_sweep(cases=PLAN_CASES, dtype="bfloat16"):
    """The wgmma route's kernel time under each plan `wgmma_plans` offers
    (the plan swapped in for the sweep; each checked against the plain
    version first, at the tolerances of `int8_matmul_case`), beside the
    plan's model cost and its pick: the trade behind
    `quant_matmul.wgmma_plan`. One record a product, M and plan."""
    orig = quant_matmul.wgmma_plan
    dt = getattr(torch, dtype)
    records = [dict(cluster_slots={
        splits: quant_matmul.wgmma_cluster_slots(
            splits, quant_matmul.wgmma_smem_bytes(32, 8, splits))
        for splits in range(1, quant_matmul.MAX_SPLIT + 1)})]
    print(json.dumps(records[0]), flush=True)
    try:
        for name, m in cases:
            k, n, transposed = PRODUCTS[name]
            copies = math.floor(WALK_BYTES / (k * n)) + 1
            q1, s1, b1, k, n, transposed = int8_weights(name, 1, m)
            q = q1.repeat(copies, 1, 1).contiguous()
            s = s1.repeat(copies, 1).contiguous()
            b = None if b1 is None else b1[0].to(dt)
            x = torch.randn((m, k), device="cuda").to(dt)
            want = quant_matmul.int8_matmul_reference(x, q[0], s[0], b,
                                                      transposed)
            rtol, atol = INT8_MATMUL_TOL["float32" if transposed else dtype]
            atol *= want.float().abs().max().item()
            plans = quant_matmul.wgmma_plans(m, k, n, transposed)
            pick = orig(m, k, n, transposed)
            for plan, cost in plans.items():
                quant_matmul.wgmma_plan = (
                    lambda *a, _p=plan, **kw: _p)
                quant_matmul._layouts.clear()
                got = quant_matmul.int8_matmul(x, q[0], s[0], b,
                                               transposed=transposed)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                if not bool((diff <= atol + rtol * want.float().abs()).all()):
                    raise Mismatch(f"plan {plan} disagrees at {name} m={m}")

                def kernel(i):
                    quant_matmul.int8_matmul(x, q[i % copies], s[i % copies],
                                             b, transposed=transposed)

                records.append(dict(
                    name=name, m=m, bn=plan.bn, splits=plan.splits,
                    stages=plan.stages, grid=plan.grid, cost=cost,
                    picked=plan == pick, max_abs_err=diff.max().item(),
                    kernel_us=time_graph_us(kernel,
                                            iters=max(50, copies))))
                print(json.dumps(records[-1]), flush=True)
    finally:
        quant_matmul.wgmma_plan = orig
        quant_matmul._layouts.clear()
    return records


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--m", default="1,16,256",
                        help="comma-separated row counts")
    parser.add_argument("--llama", action="store_true",
                        help="Llama-3-8B's products at LLAMA_ROWS instead")
    parser.add_argument("--moe", action="store_true",
                        help="gpt2-moe's expert products at MOE_CAPACITIES "
                        "instead")
    parser.add_argument("--splits", action="store_true",
                        help="time the dense products at M=16 at each "
                        "forced K split instead")
    parser.add_argument("--plans", action="store_true",
                        help="time the wgmma route under each plan it "
                        "offers at PLAN_CASES instead")
    parser.add_argument("--out", default=None,
                        help="also append every record to this JSONL file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_int8: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    records = []
    cases, calls = [], []
    if args.splits:
        for rec in split_sweep(dtype=args.dtype):
            records.append(rec)
            print(json.dumps(rec), flush=True)
    elif args.plans:
        records = plan_sweep(dtype=args.dtype)
    elif args.moe:
        for name in EXPERT_PRODUCTS:
            for c in MOE_CAPACITIES:
                records.append(int8_experts_case(name=name, c=c,
                                                 dtype=args.dtype))
                print(json.dumps(records[-1]), flush=True)
    elif args.llama:
        cases = [(name, m) for name in LLAMA_PRODUCTS for m in LLAMA_ROWS]
    else:
        cases = [(name, int(m)) for name in INT8_PRODUCTS
                 for m in args.m.split(",")]
        cases += [(name, m) for name in GATE_PRODUCTS for m in GATE_ROWS
                  if (name, m) not in cases]
        cases += [(name, m) for name in INT8_PRODUCTS for m in SCORE_ROWS
                  if (name, m) not in cases]
        calls = [{}] + [dict(m=m, unembed=False) for m in GATE_ROWS]
    for name, m in cases:
        records.append(int8_matmul_case(name=name, m=m, dtype=args.dtype))
        print(json.dumps(records[-1]), flush=True)
    for kw in calls:
        records.append(dict(model_call=True,
                            **int8_model_call(dtype=args.dtype, **kw)))
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(dict(rec, card=smi)) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
