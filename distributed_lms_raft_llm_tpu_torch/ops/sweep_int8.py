"""Time the int8 weight-only matmul at GPT-2 small's products on the card.

    python -m distributed_lms_raft_llm_tpu_torch.ops.sweep_int8 \\
        [--dtype bfloat16] [--m 1,16,256] [--splits] [--out FILE]

For each product (attn.wqkv, mlp.wi, attn.wo, mlp.wo, the tied
unembedding) and each M: the kernel against its plain version, then the
kernel's device time (CUDA-graph replay), its eager time (the Python
wrapper included), the plain version's, and cuBLAS (`torch.matmul`)
against the weight dequantized to x's dtype beforehand, beside the least
time the card could take. Consecutive timed calls walk distinct copies of
the weight, more than 100 MB of them, so the 50 MB L2 cannot hold what
the next call reads; the dequantized copies are walked the same way. Then
the 49 products of one decode model call (12 layers of distinct weights,
124 MB). With `--splits`: the dense products at M=16 at each forced K
split instead. One JSON line a case, then the card's `nvidia-smi` name and
power limit.

Uses only `quant_matmul.int8_matmul`/`int8_matmul_reference`, the
quantizers and `ops/timing.py`, so the file can be copied beside another
checkout's package to time that checkout's kernel in the same call.
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
    yardstick. Raises Mismatch if the kernel disagrees."""
    dt = getattr(torch, dtype)
    q1, s1, b1, k, n, transposed = int8_weights(name, n_layers, seed)
    copies = math.floor(WALK_BYTES / (k * n)) + 1
    reps = -(-copies // q1.shape[0])
    q = q1.repeat(reps, 1, 1)[:copies].contiguous()  # distinct memory
    s = s1.repeat(reps, 1)[:copies].contiguous()
    del q1, s1
    x = torch.randn((m, k), generator=torch.Generator(device="cuda")
                    .manual_seed(seed + 1), device="cuda").to(dt)
    bias = [None if b1 is None else b1[i % b1.shape[0]].to(dt)
            for i in range(copies)]
    got = quant_matmul.int8_matmul(x, q[0], s[0], bias[0],
                                   transposed=transposed)
    want = quant_matmul.int8_matmul_reference(x, q[0], s[0], bias[0],
                                              transposed)
    torch.cuda.synchronize()
    rtol, atol = INT8_MATMUL_TOL["float32" if transposed else dtype]
    atol *= want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise Mismatch(f"int8_matmul disagrees with its plain version at "
                       f"{name} m={m} {dtype}: max abs err {err} (rtol "
                       f"{rtol}, atol {atol})")
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

    rec = dict(name=name, m=m, k=k, n=n, transposed=transposed, dtype=dtype,
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
    rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
    return rec


def int8_model_call(*, m=16, dtype="bfloat16", n_layers=12):
    """The 49 int8 products of one decode model call (4 a layer x 12, then
    the unembedding), in the model's order, timed as one unit: kernel,
    plain, cuBLAS against pre-dequantized weights, and the summed bound."""
    dt = getattr(torch, dtype)
    weights = {}
    for seed, name in enumerate(INT8_PRODUCTS):
        q, s, b, k, n, tr = int8_weights(name, n_layers, seed)
        weights[name] = (q, s, None if b is None else b.to(dt), k, n, tr)
    xs = {768: torch.randn((m, 768), device="cuda").to(dt),
          3072: torch.randn((m, 3072), device="cuda").to(dt)}
    order = [(name, i) for i in range(n_layers)
             for name in ("attn.wqkv", "attn.wo", "mlp.wi", "mlp.wo")]
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
    rec = dict(m=m, dtype=dtype, products=len(order), bound_us=bound_us,
               kernel_us=time_graph_us(kernel, iters=5),
               kernel_eager_us=time_eager_us(kernel, iters=5),
               plain_us=time_graph_us(plain, iters=5),
               library_us=time_graph_us(library, iters=5))
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
    parser.add_argument("--splits", action="store_true",
                        help="time the dense products at M=16 at each "
                        "forced K split instead")
    parser.add_argument("--out", default=None,
                        help="also append every record to this JSONL file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_int8: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    records = []
    if args.splits:
        for rec in split_sweep(dtype=args.dtype):
            records.append(rec)
            print(json.dumps(rec), flush=True)
    for name in ([] if args.splits else INT8_PRODUCTS):
        for m in (int(v) for v in args.m.split(",")):
            records.append(int8_matmul_case(name=name, m=m, dtype=args.dtype))
            print(json.dumps(records[-1]), flush=True)
    if not args.splits:
        records.append(dict(model_call=True,
                            **int8_model_call(dtype=args.dtype)))
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(dict(rec, card=smi)) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
