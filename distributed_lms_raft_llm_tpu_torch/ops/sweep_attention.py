"""Time the decode-attention kernel at each split count, on the card.

    python -m distributed_lms_raft_llm_tpu_torch.ops.sweep_attention [--out F]

For GPT-2-small shapes (H = Hkv = 12, Dh = 64, 12 layers, bf16, q strided
as the model passes it) prints one JSON line a shape: the kernel's device
time with the keys split 1, 2, 4 and 8 ways (tile and ring as
`launch_plan` picks them for that split), with the plan's own choice, and
`scaled_dot_product_attention` on the same inputs as the yardstick. Every
split is checked against the plain version first. This is the measurement
behind `launch_plan`'s rule (PERF.md). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from . import attention
from .timing import time_graph_us

SHAPES = [(1, 384), (2, 320), (4, 320), (8, 33), (8, 64), (8, 320), (8, 384),
          (1, 1024), (8, 1024)]


def sweep_shape(b: int, s: int, n_layers: int = 12) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + s)
    qkv = torch.randn((b, 1, 3 * 768), generator=gen, device=dev).bfloat16()
    q = qkv[..., :768].reshape(b, 1, 12, 64).transpose(1, 2)
    k = torch.randn((n_layers, b, 12, s, 64), generator=gen,
                    device=dev).bfloat16()
    v = torch.randn((n_layers, b, 12, s, 64), generator=gen,
                    device=dev).bfloat16()
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=dev)
    mask[-1, ..., :s - 1] = False  # a fully padded row
    bias = attention.mask_to_bias(mask)
    want = attention.decode_attention_reference(q, k, v, 3, bias)

    def kernel(i):
        attention.decode_attention(q, k, v, i % n_layers, bias)

    chosen = attention.launch_plan(b, 12, s, 64, torch.bfloat16)
    rec = {"b": b, "s": s, "plan_n_split": chosen.n_split}
    plan_fn = attention.launch_plan
    try:
        for n in (1, 2, 4, 8):
            # Forced split: the wrapper plans each new layout through
            # `launch_plan`, so swap it and drop the validated layouts.
            attention.launch_plan = functools.partial(plan_fn, n_split=n)
            attention._layouts.clear()
            got = attention.decode_attention(q, k, v, 3, bias)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 2e-2:
                raise RuntimeError(f"n_split={n}: max abs err {err}")
            rec[f"n{n}_us"] = time_graph_us(kernel)
    finally:
        attention.launch_plan = plan_fn
        attention._layouts.clear()
    rec["plan_us"] = time_graph_us(kernel)
    sdpa_mask = bias[:, :, None, :].to(q.dtype)
    rec["sdpa_us"] = time_graph_us(
        lambda i: F.scaled_dot_product_attention(
            q, k[i % n_layers], v[i % n_layers], attn_mask=sdpa_mask))
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_attention: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    records = []
    for b, s in SHAPES:
        records.append(sweep_shape(b, s))
        print("sweep " + json.dumps(records[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
