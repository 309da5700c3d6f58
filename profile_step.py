#!/usr/bin/env python3
"""Profile one greedy GPT-2 decode batch of the port beside this script.

    python3 profile_step.py [--runs N]

GPT-2 small at full width, bf16, seeded random weights, the 8 questions of
`chip_smoke.py` (prompt bucket 256), 32 greedy tokens. Prints one JSON
line: `chip_smoke.profile_generate`'s record (device busy share, kernel
launches by kind, kernel time by name) and the wall times of N more
unprofiled batches. To compare two commits on one card, place this file
and `chip_smoke.py` beside the other checkout's package too, and run both
in one call. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False

    from chip_smoke import QUESTIONS, profile_generate
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    engine = TutoringEngine(EngineConfig(
        model="gpt2", seed=0, device="cuda",
        sampling=SamplingParams.greedy(max_new_tokens=32)))
    engine.warmup(batch=len(prompts))
    record = profile_generate(torch, engine, prompts)
    ids, mask, bucket = engine.encode_prompts(prompts)
    walls = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.generate_ids(ids, mask)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    record.update(device=torch.cuda.get_device_name(0), bucket=bucket,
                  batch_wall_s=walls)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
