"""Time the decode-attention kernel at each split count, on the card.

    python -m distributed_lms_raft_llm_tpu_torch.ops.sweep_attention \
        [--window] [--out F]

For GPT-2-small shapes (H = Hkv = 12, Dh = 64, 12 layers, bf16, q strided
as the model passes it) prints one JSON line a shape: the kernel's device
time with the keys split 1, 2, 4 and 8 ways (tile and ring as
`launch_plan` picks them for that split), with the plan's own choice, and
`scaled_dot_product_attention` on the same inputs as the yardstick. Every
split is checked against the plain version first. This is the measurement
behind `launch_plan`'s rule (PERF.md). Needs a CUDA device.

With `--window`: the kernel's verify-window variant instead, at 16 slots
(the paged engine's), widths 384 and 640, T = 2, 5, 9 and 16 query rows a
slot, int8 and bf16 caches, two rounds, each case checked row by row
against the plain version (`window_error`) and against two planted faults.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.common import quantize_kv
from . import attention
from .sweep_int8 import H100_HBM_BYTES_PER_S, PEAK_OPS_PER_S
from .timing import time_eager_us, time_graph_us

# Largest error against the plain version: bf16 rounds the plain version's
# probabilities, the kernel keeps float32; float32 differs by sum order.
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

# A window's error, row by row: each query row (b, h, t) against the plain
# version relative to that row's own largest output. A row over a few
# hundred keys averages down to outputs near 0.1 while a one-key row's is a
# raw v row near 4, so a limit scaled by the call's largest output would
# pass a frontier one key off on the long rows. bf16: the outputs' rounding
# (an ulp is 2^-8 to 2^-7 of a value) and the plain version's bf16
# probabilities; float32: the order of the sums.
WINDOW_ROW_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

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


def window_error(got, want, dtype: str) -> dict:
    """`got` against `want` ([B, H, T, Dh]) row by row: the largest error
    of a query row over its own largest |want|, and whether every row is
    within WINDOW_ROW_TOLERANCE[dtype] of it."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    rel = (diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max()
    worst = rel.item()
    return dict(max_abs_err=diff.max().item(), max_row_rel_err=worst,
                ok=math.isfinite(worst)
                and worst <= WINDOW_ROW_TOLERANCE[dtype])


def window_faults(lengths, width: int, t: int) -> dict:
    """Planted faults that `window_error` must catch, as per-row lengths:
    every frontier one key late, and only the long rows' (more than half
    the width), whose outputs average down near 0.1. Rows whose last query
    already reaches the width keep theirs (no key past the width)."""
    inside = (lengths + t <= width).to(lengths.dtype)
    long = inside * (lengths > width // 2).to(lengths.dtype)
    return {"all_rows_plus_1": lengths + inside,
            "long_rows_plus_1": lengths + long}


def window_attention_case(*, s, width, t, int8,
                          with_bias=False, dtype="bfloat16", h=12, dh=64,
                          n_layers=12, seed=0):
    """The verify window's attention: `s` rows of `t` queries (row b's
    query j sees the keys before lengths[b] + j; one row's last query
    reaches the width, one row starts at one key), q strided as the model
    passes it, a window of a larger cache, a float or int8 cache, and with
    `with_bias` the bucketed engine's left padding as a shared bias.
    Kernel vs plain, row by row (`window_error`), and the same check run
    on the kernel with each of `window_faults` planted, which must fail it
    (`caught_by_call_max_check` says whether a limit scaled by the call's
    largest output would have too); SDPA with a [B, 1, T, S] boolean mask
    over the cache (dequantized beforehand, untimed, for int8) as the
    yardstick; the bound counts the keys this data's frontiers need."""
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_alloc = width + 64
    qkv = torch.randn((s, t, 3 * h * dh), generator=gen, device=dev).to(dt)
    q = qkv[..., :h * dh].reshape(s, t, h, dh).transpose(1, 2)
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
    lengths = torch.randint(1, width - t + 2, (s,), generator=gen,
                            device=dev)
    lengths[0], lengths[-1] = 1, width - t + 1
    lengths[1] = width // 2 + 1  # a long row inside the width
    lengths = lengths.to(torch.int32)
    keys = torch.arange(width, device=dev)
    frontier = lengths[:, None] + torch.arange(t, device=dev)[None, :]
    mask = (keys[None, None, :] < frontier[:, :, None])[:, None]  # B1TS
    bias = None
    if with_bias:
        pad = (torch.rand((s,), generator=gen, device=dev)
               * lengths.float()).long()
        valid = keys[None, :] >= pad[:, None]
        mask = mask & valid[:, None, None, :]
        bias = attention.mask_to_bias(valid[:, None, None, :])

    got = attention.decode_attention(q, k, v, 5, bias, lengths=lengths,
                                     **scales)
    want = attention.decode_attention_reference(
        q, k, v, 5, bias, lengths, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    what = (f"window decode_attention (t={t}, int8={int8}, bias={with_bias},"
            f" s={s} width={width} {dtype})")
    check = window_error(got, want, dtype)
    if not check["ok"]:
        raise RuntimeError(
            f"{what} disagrees with its plain version: a row's error is "
            f"{check['max_row_rel_err']} of its largest output > "
            f"{WINDOW_ROW_TOLERANCE[dtype]}")
    call_max = TOLERANCE[dtype] * max(1.0, want.float().abs().max().item())
    faults = {}
    for name, bad in window_faults(lengths, width, t).items():
        wrong = window_error(attention.decode_attention(
            q, k, v, 5, bias, lengths=bad, **scales), want, dtype)
        if wrong["ok"]:
            raise RuntimeError(f"{what}: the planted fault {name} passed "
                               f"the check")
        faults[name] = dict(
            max_row_rel_err=wrong["max_row_rel_err"],
            caught_by_call_max_check=wrong["max_abs_err"] > call_max)
    # K/V through each row's widest frontier, read once for its t queries.
    key_reads = int((lengths + t - 1).sum().item())
    pair_keys = int(frontier.sum().item())  # (query, key) pairs scored
    es = torch.finfo(dt).bits // 8
    n_bytes = (2 * h * key_reads * dh * (1 if int8 else es)
               + (2 * 4 * h * key_reads if int8 else 0)
               + 2 * s * h * t * dh * es + 4 * s
               + (4 * s * width if with_bias else 0))
    n_ops = 4 * h * pair_keys * dh
    t_bytes, t_ops = (n_bytes / H100_HBM_BYTES_PER_S,
                      n_ops / PEAK_OPS_PER_S[dtype])
    rows, chunks = attention.window_rows(1, t)
    plan = attention.launch_plan(s, h, width, dh, k.dtype, group=rows,
                                 chunks=chunks)
    rec = dict(slots=s, t=t, width=width, s_alloc=s_alloc, int8=int8,
               bias=with_bias, dtype=dtype,
               lengths_min=int(lengths.min().item()),
               lengths_max=int(lengths.max().item()), key_reads=key_reads,
               rows_per_block=rows, chunks=chunks, n_split=plan.n_split,
               tile_keys=plan.tile_keys, blocks=plan.blocks,
               max_abs_err=check["max_abs_err"],
               max_row_rel_err=check["max_row_rel_err"],
               row_tolerance=WINDOW_ROW_TOLERANCE[dtype], faults=faults,
               bound_us=max(t_bytes, t_ops) * 1e6,
               bound_by="bytes" if t_bytes >= t_ops else "operations")

    def kernel(i):
        attention.decode_attention(q, k, v, i % n_layers, bias,
                                   lengths=lengths, **scales)

    def plain(i):
        attention.decode_attention_reference(
            q, k, v, i % n_layers, bias, lengths, scales.get("k_scale"),
            scales.get("v_scale"))

    def library(i):
        F.scaled_dot_product_attention(q, kd[i % n_layers], vd[i % n_layers],
                                       attn_mask=mask)

    rec.update(kernel_us=time_graph_us(kernel),
               kernel_eager_us=time_eager_us(kernel),
               plain_us=time_graph_us(plain),
               library_us=time_graph_us(library),
               library_note="SDPA, [B, 1, T, S] boolean mask" + (
                   " over the cache dequantized beforehand (untimed)"
                   if int8 else ""))
    return rec


def sweep_window(rounds: int = 2) -> list:
    """The window variant at each T, cache and width
    (`window_attention_case`)."""
    records = []
    for rnd in range(rounds):
        for t in (2, 5, 9, 16):
            for int8 in (True, False):
                for width in (384, 640):
                    rec = window_attention_case(
                        s=16, width=width, t=t, int8=int8,
                        seed=width + t + int8)
                    rec.update(round=rnd)
                    records.append(rec)
                    print("window " + json.dumps({k: rec[k] for k in (
                        "round", "t", "int8", "width", "rows_per_block",
                        "chunks", "n_split", "kernel_us", "library_us",
                        "bound_us", "max_row_rel_err")}), flush=True)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--window", action="store_true",
                        help="time the verify-window variant instead")
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
    if args.window:
        records = sweep_window()
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "window": records}, f, indent=1)
        return 0
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
