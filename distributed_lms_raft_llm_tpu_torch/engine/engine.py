"""TutoringEngine: the inference runtime behind `Tutoring.GetLLMAnswer`.

Port of the bucketed engine of `distributed_lms_raft_llm_tpu/engine/
engine.py`, on one CUDA device (or the CPU when the caller asks for it):

- prompts are tokenized and left-padded into length and batch buckets, as
  in the JAX package, so both engines see the same shapes;
- generation is `generate.prefill` then `generate.decode`; the engine
  waits for the first token to measure TTFT;
- with `fused_attention` the decode step's attention runs through the
  hand-written CUDA kernel (`ops/attention.py`). None (the default) turns it
  on for a CUDA device and off for the CPU;
- `quant="int8"` quantizes the weights (`models/quant.py`; the products go
  through `ops/quant_matmul.py`) and `kv_quant` makes the KV cache int8
  with per-slot scales. Unlike the JAX engine, `kv_quant` combines with
  `fused_attention`: the port's kernel reads the int8 cache itself.

Options of the JAX engine that the port does not carry yet (tensor/expert/
sequence parallelism, speculative decoding, the scoring tenant) raise
`NotImplementedError` at construction.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import convert, quant, registry
from ..utils import tokenizer as tok_lib
from .generate import GenerateResult, decode, pick_bucket, prefill
from .sampling import SamplingParams

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineConfig:
    model: str = "gpt2"  # models/registry.py preset: gpt2 | tiny
    checkpoint: Optional[str] = None   # .safetensors path (HF layout)
    vocab_path: Optional[str] = None   # GPT-2 vocab.json
    merges_path: Optional[str] = None  # GPT-2 merges.txt
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams.reference_defaults
    )
    length_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    tp: int = 1
    ep: int = 1
    sp: int = 1
    # Decode attention through the CUDA kernel. None = on for a CUDA
    # device, off (plain PyTorch) for the CPU.
    fused_attention: Optional[bool] = None
    quant: Optional[str] = None
    kv_quant: bool = False
    # Decode segments (generate.decode): None = 4 small / 8 large batches.
    decode_segments: Optional[int] = None
    spec_tokens: int = 0
    scoring: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    seed: int = 0
    device: str = "cuda"


def refuse_unported(config: EngineConfig) -> None:
    """Raise for the EngineConfig options the port does not carry yet (both
    engines)."""
    unported = {
        "tp": config.tp > 1, "ep": config.ep > 1, "sp": config.sp > 1,
        "spec_tokens": config.spec_tokens > 0, "scoring": config.scoring,
    }
    named = [k for k, on in unported.items() if on]
    if named:
        raise NotImplementedError(
            f"EngineConfig options not ported to PyTorch yet: {named}"
        )
    if config.quant not in (None, "int8"):
        raise ValueError(f"unsupported quant mode {config.quant!r}")


class TutoringEngine:
    def __init__(self, config: EngineConfig):
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(config.device)
        self.family, self.cfg = registry.resolve(
            config.model, config.dtype, config.param_dtype
        )
        fused = config.fused_attention
        if fused is None:
            fused = self.device.type == "cuda"
        self.cfg = dataclasses.replace(self.cfg, fused_decode_attention=fused,
                                       quant_kv=config.kv_quant)
        self.tokenizer = tok_lib.load_gpt2_tokenizer(
            config.vocab_path, config.merges_path
        )
        if self.tokenizer.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {self.cfg.vocab_size}"
            )
        if config.sampling.max_new_tokens >= self.cfg.max_position_embeddings:
            raise ValueError(
                f"max_new_tokens {config.sampling.max_new_tokens} must be < "
                f"max_position_embeddings {self.cfg.max_position_embeddings} "
                f"for model {config.model!r}"
            )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        t0 = time.monotonic()
        if config.checkpoint:
            sd = convert.load_safetensors(config.checkpoint)
            self.params = self.family.params_from_hf(sd, self.cfg, self.device)
        else:
            log.warning("no checkpoint configured — randomly initialized %s",
                        config.model)
            self.params = self.family.init_params(self.cfg, config.seed,
                                                  self.device)
        if config.quant:
            self.params = quant.quantize_params(self.params, self.family.name)
        log.info("params ready in %.1fs on %s", time.monotonic() - t0,
                 self.device)

        self.last_ttft_s: Optional[float] = None
        self.last_batch_ttfts: List[float] = []
        self.total_generated_tokens = 0
        # Decode steps (model calls after prefill) run by generate_ids.
        self.decode_steps = 0
        # (program, wall-clock start, seconds) per answer_batch device batch.
        self._prog_times: List[Tuple[str, float, float]] = []

    _PROG_TIMES_MAX = 1024

    def pop_program_times(self) -> List[Tuple[str, float, float]]:
        """Drain (program, start_unix, wall_s) recorded since last call."""
        out, self._prog_times = self._prog_times, []
        return out

    def _max_prompt_len(self) -> int:
        return min(
            max(self.config.length_buckets),
            self.cfg.max_position_embeddings
            - self.config.sampling.max_new_tokens,
        )

    def encode_prompts(self, prompts: Sequence[str],
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Tokenize + left-pad into (ids, mask, bucket)."""
        if len(prompts) > max(self.config.batch_buckets):
            raise ValueError(
                f"{len(prompts)} prompts exceed the largest batch bucket "
                f"{max(self.config.batch_buckets)}"
            )
        limit = self._max_prompt_len()
        token_lists = []
        for p in prompts:
            toks = self.tokenizer.encode(p)[-limit:]  # keep the prompt tail
            token_lists.append(toks if toks else [self.tokenizer.pad_id])
        longest = max(len(t) for t in token_lists)
        bucket = min(pick_bucket(longest, self.config.length_buckets), limit)
        nbatch = pick_bucket(len(prompts), self.config.batch_buckets)
        ids = np.full((nbatch, bucket), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((nbatch, bucket), bool)
        for i, toks in enumerate(token_lists):
            ids[i, bucket - len(toks):] = toks
            mask[i, bucket - len(toks):] = True
        # Filler rows (batch bucketing) keep one valid token to stay
        # well-formed: every attention row needs one visible key.
        for i in range(len(prompts), nbatch):
            mask[i, -1] = True
        return ids, mask, bucket

    def warmup(self, batch: int = 8, bucket: Optional[int] = None) -> float:
        """Run one batch through both phases (first CUDA/cuBLAS calls and
        the kernel build happen here, not on a request); returns seconds."""
        bucket = min(bucket or self.config.length_buckets[0],
                     self._max_prompt_len())
        t0 = time.monotonic()
        ids = np.zeros((batch, bucket), np.int32)
        mask = np.ones((batch, bucket), bool)
        self.generate_ids(ids, mask)
        return time.monotonic() - t0

    @torch.inference_mode()
    def generate_ids(self, ids: np.ndarray, mask: np.ndarray,
                     ) -> GenerateResult:
        """Generate for a pre-bucketed id batch; records measured TTFT.

        `last_ttft_s` is wall-clock from dispatch to the first sampled
        token being on the host. Results come back as numpy arrays.
        """
        t0 = time.monotonic()
        input_ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        prompt_mask = torch.as_tensor(mask, dtype=torch.bool).to(self.device)
        statics = dict(sampling=self.config.sampling,
                       eos_id=self.tokenizer.eos_id,
                       pad_id=self.tokenizer.pad_id, model=self.family)
        state = prefill(self.params, self.cfg, input_ids, prompt_mask,
                        self.generator, **statics)
        state.out[:, 0].cpu()  # waits until the first token exists
        self.last_ttft_s = time.monotonic() - t0
        result, final = decode(self.params, state, self.cfg,
                               segments=self.config.decode_segments,
                               **statics)
        self.decode_steps += final.step - 1
        return GenerateResult(
            tokens=result.tokens.to(torch.int32).cpu().numpy(),
            lengths=result.lengths.to(torch.int32).cpu().numpy(),
        )

    def answer_batch(self, prompts: Sequence[str]) -> List[str]:
        """The serving entry: prompts in, decoded answers out. Groups larger
        than the biggest batch bucket run as several device batches."""
        if not prompts:
            return []
        cap = max(self.config.batch_buckets)
        answers: List[str] = []
        ttfts: List[float] = []
        t_submit = time.monotonic()
        for start in range(0, len(prompts), cap):
            chunk = prompts[start:start + cap]
            ids, mask, _ = self.encode_prompts(chunk)
            queued_s = time.monotonic() - t_submit
            t_gen, t_gen_unix = time.monotonic(), time.time()
            result = self.generate_ids(ids, mask)
            self._prog_times.append(
                ("generate", t_gen_unix, time.monotonic() - t_gen)
            )
            if len(self._prog_times) > self._PROG_TIMES_MAX:
                del self._prog_times[: -self._PROG_TIMES_MAX]
            # Per-request TTFT counts from batch submission: requests in a
            # later device chunk also waited for every earlier chunk.
            ttfts.extend([queued_s + (self.last_ttft_s or 0.0)] * len(chunk))
            for i in range(len(chunk)):
                n = int(result.lengths[i])
                self.total_generated_tokens += n
                toks = [t for t in result.tokens[i, :n].tolist()
                        if t != self.tokenizer.eos_id]
                answers.append(self.tokenizer.decode(toks))
        self.last_batch_ttfts = ttfts
        return answers
