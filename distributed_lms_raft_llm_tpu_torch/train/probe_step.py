"""Where a training step's time goes on the card.

GPT-2 small (the trainer CLI's `gpt2`: bf16 compute over float32 params)
takes training steps of `--batch` x `--seq` tokens drawn from a seeded
generator, as `train.train.make_train_step` runs them:

- the step's wall, free-running and with the loss read every step (as
  `fit` reads it where it logs), with `remat` on (the CLI's default) and
  off;
- one step in pieces: the forward and the loss, the backward, the
  optimizer, each by CUDA events on the device and by the host's clock
  (a piece whose host time matches its device time keeps the device
  waiting on the host);
- a `torch.profiler` window of steps: kernels a step, device ms a step,
  the device's busy share, the kernels and host ops that take the most.

    python -m distributed_lms_raft_llm_tpu_torch.train.probe_step \\
        [--steps 10] [--out FILE]

Prints one JSON line a reading, the card's `nvidia-smi` name and power
limit in each. Needs the card. Launches none of the port's kernels
(training runs the plain forward), so it builds nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models import gpt2, registry
from .checkpoint import flatten_with_paths
from .train import (
    TrainConfig,
    init_train_state,
    lm_loss,
    make_optimizer,
    make_train_step,
)


def _batches(n: int, batch: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ids = rng.integers(0, 257, (batch, seq)).astype(np.int32)
        yield {"input_ids": ids, "loss_mask": np.ones_like(ids, bool)}


def step_wall(cfg, remat: bool, args) -> tuple:
    """ms a step after 3 warm steps, free-running and with the loss read
    each step; returns (the reading, the state, the step, the
    optimizer)."""
    opt = make_optimizer(TrainConfig(warmup_steps=1, decay_steps=1000))
    state = init_train_state(args.seed, cfg, opt, "cuda")
    step = make_train_step(cfg, opt, remat=remat)
    for b in _batches(3, args.batch, args.seq, args.seed):
        state, m = step(state, b)
    batches = list(_batches(args.steps, args.batch, args.seq, args.seed + 1))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for b in batches:
        state, m = step(state, b)
    torch.cuda.synchronize()
    free = 1e3 * (time.monotonic() - t0) / len(batches)
    t0 = time.monotonic()
    for b in batches:
        state, m = step(state, b)
        float(m["loss"])
    synced = 1e3 * (time.monotonic() - t0) / len(batches)
    row = {"remat": remat, "step_ms": free, "step_ms_loss_read": synced,
           "tokens_per_s": args.batch * args.seq / (free / 1e3)}
    return row, state, step, opt


def pieces(cfg, state, opt, args) -> dict:
    """One remat step in its three pieces, device and host ms each."""
    leaves = [v for _, v in flatten_with_paths(state["params"])]
    b = next(_batches(1, args.batch, args.seq, args.seed + 2))
    ids = torch.as_tensor(b["input_ids"], device="cuda").long()
    mask = torch.as_tensor(b["loss_mask"], device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = []
    torch.cuda.synchronize()
    host.append(time.monotonic())
    ev[0].record()
    logits, _ = gpt2.forward(state["params"], cfg, ids, remat=True)
    loss = lm_loss(logits[:, :-1], ids[:, 1:], mask[:, 1:])
    ev[1].record()
    host.append(time.monotonic())
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    host.append(time.monotonic())
    with torch.no_grad():
        opt.apply(leaves, list(grads), state["opt_state"])
    ev[3].record()
    host.append(time.monotonic())
    torch.cuda.synchronize()
    names = ("forward_loss", "backward", "optimizer")
    return {f"{n}_device_ms": ev[i].elapsed_time(ev[i + 1])
            for i, n in enumerate(names)} | {
        f"{n}_host_ms": 1e3 * (host[i + 1] - host[i])
        for i, n in enumerate(names)}


def profile_window(state, step, args, n: int = 3) -> dict:
    from torch.profiler import ProfilerActivity, profile

    batches = list(_batches(n, args.batch, args.seq, args.seed + 3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:12]
    return {"steps": n, "wall_ms_per_step": 1e3 * wall / n,
            "kernels_per_step": len(kernels) / n,
            "device_ms_per_step": device_ms / n,
            "busy_share": device_ms / (1e3 * wall),
            "top_kernels_ms_per_step": [(k[:120], v / n) for k, v in top],
            "top_host_ops_ms_per_step": [(k, v / n, c // n)
                                         for k, v, c in host]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _, cfg = registry.resolve("gpt2", torch.bfloat16, torch.float32)
    rows, state = [], None
    for remat in (False, True):
        state = None  # the first run's state off the card before the peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row, state, step, opt = step_wall(cfg, remat, args)
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rows.append(dict(row, card=card))
        print(json.dumps(rows[-1]), flush=True)
    rows.append(dict(pieces(cfg, state, opt, args), card=card))
    print(json.dumps(rows[-1]), flush=True)
    rows.append(dict(profile_window(state, step, args), card=card))
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
