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
  `fused_attention`: the port's kernel reads the int8 cache itself;
- `spec_tokens` k > 0 swaps `generate.decode` for `spec.decode_spec`
  (speculative decoding with prompt-lookup drafts, exact). Unlike the JAX
  engine it combines with `fused_attention`: the JAX package refuses the
  pair because its Pallas kernel takes one query row, while the port's
  kernel has a window variant for the k+1 verify rows, the prompt's left
  padding going in as the bias the rows share. The kernel takes windows
  of up to `ops.attention.MAX_WINDOW` rows, so with fused attention
  `spec_tokens` above MAX_WINDOW - 1 raises at construction;
- `score()` is the scoring tenant's log-likelihood entry
  (`engine/scoring.py`): a full-sequence forward over right-padded
  (batch bucket, length bucket) shapes. With `scoring` on, warmup runs
  every such shape once (`score_shapes`).

- `tp` > 1 shards the model over a tp axis of ranks, `ep` > 1 an MoE
  model's experts over an ep axis, and `sp` > 1 the scoring forward's
  sequence over an sp axis (`parallel/`); dp takes the ranks those leave
  over, as the JAX engine's ``"dp": -1`` takes the spare devices. The
  caller starts the processes, which join one process group (gloo or
  nccl, `parallel.mesh.init_process_group` or torchrun's environment),
  and builds the same engine in each: its world is the whole group, dp x
  tp x ep x sp ranks (or the `mesh` it is given, such as
  `parallel.make_hybrid_mesh`'s); rank 0 takes the calls and the other
  ranks follow it (`follow()`, `parallel/spmd.py`). Every rank holds its
  slice of the parameters (its heads, its experts) and its heads of the
  cache, and its kernels run at the shard's shapes. Unlike the JAX engine,
  fused attention runs under tp: the JAX package's Pallas kernel is not
  partition-aware, while each rank here hands its own local tensors to the
  kernel. Generation replicates over dp (each dp line of tp x ep x sp
  ranks computes the whole batch, as JAX's jit does with uncommitted host
  inputs) and over sp (the cached decode shards no sequence); scoring at
  sp > 1 runs the ring forward (`parallel/ring.py`), each rank summing its
  own positions' log probabilities, each dp line its own rows of the
  batch, and buckets texts as the JAX engine does (`engine/scoring.py`).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import convert, quant, registry
from ..ops import attention as attention_ops
from ..parallel import mesh as mesh_lib
from ..parallel import partition
from ..parallel.spmd import Replica
from ..utils import tokenizer as tok_lib
from ..utils.guards import intended_transfer
from .generate import GenerateResult, decode, pick_bucket, prefill
from .program_inventory import program_table
from .sampling import SamplingParams
from .scoring import (
    derive_score_shapes,
    score_program,
    score_texts,
    warm_score,
)
from .spec import decode_spec

# Speculative draft sources (EngineConfig.draft_source).
DRAFT_SOURCES = ("prompt_lookup", "ngram")

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineConfig:
    # models/registry.py preset: gpt2 | gpt2-medium | gpt2-large |
    # gpt2-xl | tiny | llama3-8b | llama-tiny | gpt2-moe | moe-tiny
    model: str = "gpt2"
    checkpoint: Optional[str] = None   # .safetensors path (HF layout)
    vocab_path: Optional[str] = None   # GPT-2 vocab.json
    merges_path: Optional[str] = None  # GPT-2 merges.txt
    tokenizer_json: Optional[str] = None  # HF tokenizer.json (Llama)
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
    # Speculative decoding: draft this many tokens a step and verify them
    # in one forward (engine/draft.py), exactly; 0 = off. Both engines.
    spec_tokens: int = 0
    # Where drafts come from: "prompt_lookup" (the most recent n-gram
    # continuation) or "ngram" (the slot's modal-continuation table, the
    # paged engine only).
    draft_source: str = "prompt_lookup"
    # The scoring tenant: warmup covers the score program's shapes.
    scoring: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    seed: int = 0
    device: str = "cuda"


def check_quant(config: EngineConfig) -> None:
    """Raise for a quant mode neither package has (both engines)."""
    if config.quant not in (None, "int8"):
        raise ValueError(f"unsupported quant mode {config.quant!r}")


def kv_heads(cfg) -> int:
    """The model's KV head count (all heads for GPT-2 and its MoE)."""
    return getattr(cfg, "num_kv_heads", cfg.num_heads)


@dataclasses.dataclass(frozen=True)
class EngineAxes:
    """An engine's mesh axes (`parallel.mesh.ParallelAxis` each): tp
    shards the heads, ep the experts, sp the scoring forward's sequence,
    and dp replicates them all (only the scoring forward at sp > 1 splits
    its batch over dp); `ranks` is what the replicated host loop
    broadcasts over (the tp axis where the engine's ranks are its tp
    ranks, else all of them)."""

    tp: mesh_lib.ParallelAxis = mesh_lib.SINGLE
    ep: mesh_lib.ParallelAxis = mesh_lib.ParallelAxis(name="ep")
    sp: mesh_lib.ParallelAxis = mesh_lib.ParallelAxis(name="sp")
    ranks: mesh_lib.ParallelAxis = mesh_lib.SINGLE
    dp: mesh_lib.ParallelAxis = mesh_lib.ParallelAxis(name="dp")

    @property
    def world(self) -> int:
        return self.dp.size * self.tp.size * self.ep.size * self.sp.size


def check_expert_parallel(ep: int, family: str, cfg, model: str,
                          paged: bool = False) -> None:
    """Refuse ep > 1 on a family without experts, with the JAX engines'
    messages, and an ep that does not divide the experts (where the JAX
    package's `device_put` of the expert stacks refuses it)."""
    if ep <= 1:
        return
    if family != "gpt2_moe":
        tail = ("" if paged else " — the ep devices would silently "
                "replicate (shrinking dp) instead of helping")
        raise ValueError(f"ep={ep} requires an MoE family; {model!r} has "
                         f"no expert axis to shard{tail}")
    if cfg.num_experts % ep:
        raise ValueError(
            f"ep={ep} does not divide the {cfg.num_experts} experts of "
            f"{model!r}: each ep rank holds num_experts / ep of them; ep "
            f"ways that divide them: {mesh_lib.divisors(cfg.num_experts)}")


def engine_axes(config: EngineConfig, family: str, cfg,
                paged: bool = False,
                mesh: Optional[mesh_lib.Mesh] = None) -> EngineAxes:
    """The axes an engine runs over: `mesh`'s where given (its tp, ep and
    sp must be the config's); else every axis of size 1 outside a process
    group of several ranks, and inside one the group's, laid out by
    `make_mesh` with dp taking what tp x ep x sp leave (a group that is
    not a multiple of them is refused). The head split and ep are checked
    first (`partition.validate_tp_heads`, the JAX paged engine's check;
    `check_expert_parallel`), so a bad split raises before any group is
    needed."""
    partition.validate_tp_heads(kv_heads(cfg), config.tp, config.model)
    check_expert_parallel(config.ep, family, cfg, config.model, paged)
    model = config.tp * config.ep * config.sp
    if mesh is None:
        world = mesh_lib.make_mesh().world_size
        if world == 1 and model == 1:
            return EngineAxes()
        if world == 1:
            raise RuntimeError(
                f"tp={config.tp} x ep={config.ep} x sp={config.sp} runs one "
                f"process a rank: join a process group of {model} ranks "
                f"first (parallel.mesh.init_process_group, or "
                f"initialize_multihost under torchrun)")
        if world % model:
            raise ValueError(
                f"a process group of {world} ranks is not a multiple of "
                f"tp={config.tp} x ep={config.ep} x sp={config.sp} = "
                f"{model}: an engine's world is dp x tp x ep x sp ranks")
        mesh = mesh_lib.make_mesh({"tp": config.tp, "ep": config.ep,
                                   "sp": config.sp, "dp": -1})
    want = {"tp": config.tp, "ep": config.ep, "sp": config.sp}
    got = {a: mesh.shape[a] for a in want}
    if got != want:
        raise ValueError(f"the mesh's axes {got} are not the config's "
                         f"{want}")
    tp = mesh.tensor_parallel()
    return EngineAxes(tp=tp, ep=mesh.axis("ep"), sp=mesh.axis("sp"),
                      ranks=tp if tp.size == mesh.world_size
                      else mesh.world(), dp=mesh.axis("dp"))


def shard_for(params, family: str, axes: EngineAxes):
    """This rank's slice of a (quantized) parameter tree: the family's
    rules (`partition.slicing_rules`) over the tp axis and, for experts,
    the ep axis, cut after quantization so a row-parallel leaf keeps the
    scale of its whole column."""
    return partition.shard_params(params, partition.slicing_rules(family),
                                  axes.tp.rank, axes.tp.size,
                                  axes.ep.rank, axes.ep.size)


def shard_cfg(cfg, axes: EngineAxes, **changes):
    """The model config carrying `axes` (tp; ep where the config has
    experts; sp not: only the scoring forward's config carries it,
    `score_cfg`) and `changes`."""
    if hasattr(cfg, "expert_parallel"):
        changes["expert_parallel"] = axes.ep
    return dataclasses.replace(cfg, tensor_parallel=axes.tp, **changes)


def score_cfg(cfg, axes: EngineAxes):
    """The scoring forward's config: the serving config with the sp axis,
    which routes it through the ring forward at sp > 1."""
    if axes.sp.size == 1:
        return cfg
    return dataclasses.replace(cfg, sequence_parallel=axes.sp)


def load_tokenizer(config: EngineConfig, family: str, vocab_size: int):
    """The engine's tokenizer (`tokenizer_json`, else the GPT-2 files, else
    bytes), refusing what would feed the model wrong ids: a Llama
    checkpoint without its own tokenizer, and a vocabulary larger than the
    model's (both engines, as the JAX `TutoringEngine`)."""
    tokenizer = tok_lib.load_gpt2_tokenizer(
        config.vocab_path, config.merges_path, config.tokenizer_json)
    if family == "llama" and config.checkpoint and not config.tokenizer_json:
        raise ValueError(
            "a Llama checkpoint needs its own tokenizer: pass "
            "tokenizer_json (HF tokenizer.json); GPT-2 BPE or byte ids "
            "would map to the wrong embedding rows")
    if tokenizer.vocab_size > vocab_size:
        raise ValueError(
            f"tokenizer vocab {tokenizer.vocab_size} exceeds model "
            f"vocab {vocab_size}"
        )
    return tokenizer


def check_moe_spec(spec_tokens: int, family: str, cfg) -> None:
    """Raise for speculation on an MoE model that drops tokens (both
    engines, as the JAX engines): with capacity_factor < num_experts a
    token's output depends on its forward's other rows, so a verify window
    would sample from other distributions than step decode. The port's
    speculation with fused attention (a recorded difference) does not lift
    this."""
    if (spec_tokens > 0 and family == "gpt2_moe"
            and cfg.capacity_factor < cfg.num_experts):
        raise ValueError(
            "spec_tokens with an MoE model requires capacity_factor >= "
            "num_experts (no token dropping): capacity drops make a "
            "token's output depend on its forward-pass companions, so "
            "the speculative verify window would sample from different "
            "distributions than step decode (models/moe.py caveat)"
        )


def check_spec_window(spec_tokens: int, fused: bool) -> None:
    """Raise where a verify window (spec_tokens + 1 query rows a row) is
    wider than the attention kernel takes: with fused attention every
    window runs through it, and none drops to the plain version."""
    if fused and spec_tokens + 1 > attention_ops.MAX_WINDOW:
        raise ValueError(
            f"spec_tokens {spec_tokens}: a verify window of "
            f"{spec_tokens + 1} rows exceeds the attention kernel's "
            f"{attention_ops.MAX_WINDOW}; use spec_tokens <= "
            f"{attention_ops.MAX_WINDOW - 1} or fused_attention=False")


class TutoringEngine:
    def __init__(self, config: EngineConfig,
                 mesh: Optional[mesh_lib.Mesh] = None):
        check_quant(config)
        if config.spec_tokens > 0 and config.draft_source != "prompt_lookup":
            raise ValueError(
                f"draft_source {config.draft_source!r} is a paged-engine "
                "feature (the n-gram table reads the slot transcripts); "
                "TutoringEngine drafts by prompt_lookup only")
        self.config = config
        self.device = resolve_device(config.device)
        self.family, self.cfg = registry.resolve(
            config.model, config.dtype, config.param_dtype
        )
        check_moe_spec(config.spec_tokens, self.family.name, self.cfg)
        fused = config.fused_attention
        if fused is None:
            fused = self.device.type == "cuda"
        check_spec_window(config.spec_tokens, fused)
        # The mesh axes (the head split and ep checked first); `tp`, `ep`,
        # `sp` and `dp` are their sizes.
        self.axes = engine_axes(config, self.family.name, self.cfg,
                                mesh=mesh)
        self.tensor_parallel = self.axes.tp
        self.tp, self.ep, self.sp, self.dp = (
            self.axes.tp.size, self.axes.ep.size, self.axes.sp.size,
            self.axes.dp.size)
        self.cfg = shard_cfg(self.cfg, self.axes,
                             fused_decode_attention=fused,
                             quant_kv=config.kv_quant)
        # Over several ranks: rank 0's calls, replayed on the others.
        self._spmd = Replica(self, self.axes.ranks)
        self.tokenizer = load_tokenizer(config, self.family.name,
                                        self.cfg.vocab_size)
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
        self.params = shard_for(self.params, self.family.name, self.axes)
        log.info("params ready in %.1fs on %s (rank %d of %d: dp %d, tp "
                 "%d, ep %d, sp %d)", time.monotonic() - t0, self.device,
                 self.axes.ranks.rank, self.axes.world, self.dp, self.tp,
                 self.ep, self.sp)

        self.last_ttft_s: Optional[float] = None
        self.last_batch_ttfts: List[float] = []
        # Speculation's effect on the last generate: mean tokens a verify
        # window emitted per real row (1.0 = no draft accepted, spec_tokens
        # + 1 = all); None until a speculative generate ran.
        self.last_spec_tokens_per_window: Optional[float] = None
        self.total_generated_tokens = 0
        # Decode steps (model calls after prefill; verify windows under
        # speculation) run by generate_ids.
        self.decode_steps = 0
        # (program, wall-clock start, seconds) per answer_batch device batch
        # and per score batch.
        self._prog_times: List[Tuple[str, float, float]] = []
        # The scoring tenant's program and the shapes warmup runs it at
        # (none unless `config.scoring`).
        # At sp > 1 its forward runs round the ring (`score_cfg`), each dp
        # line over its own rows of the batch.
        self._score = functools.partial(
            score_program, cfg=score_cfg(self.cfg, self.axes),
            model=self.family, dp=self.axes.dp if self.sp > 1 else None)
        self.score_shapes: List[Tuple[int, int]] = (
            derive_score_shapes(config.length_buckets, config.batch_buckets,
                                self.cfg.max_position_embeddings,
                                sp=self.sp, dp=self.dp)
            if config.scoring else [])
        # The distinct static keys each program has run at (host only).
        self.programs = program_table("TutoringEngine")

    _PROG_TIMES_MAX = 1024

    def follow(self, on_result=None) -> None:
        """A rank other than 0: replay rank 0's calls until it stops
        (`stop_followers`); `on_result(name, result)` sees each replayed
        call's result (`Replica.follow`)."""
        self._spmd.follow(on_result)

    def stop_followers(self) -> None:
        """Rank 0: release the other ranks from `follow`."""
        self._spmd.stop()

    def pop_program_times(self) -> List[Tuple[str, float, float]]:
        """Drain (program, start_unix, wall_s) recorded since last call."""
        out, self._prog_times = self._prog_times, []
        return out

    def _max_prompt_len(self) -> int:
        # Speculation keeps its verify windows inside the position table:
        # the widest ends k-1 positions past the last budgeted token.
        extra = max(0, self.config.spec_tokens - 1)
        return min(
            max(self.config.length_buckets),
            self.cfg.max_position_embeddings
            - self.config.sampling.max_new_tokens - extra,
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
        the kernel build happen here, not on a request), then, with
        `config.scoring`, the score program at each of `score_shapes`;
        returns seconds."""
        with self._spmd.call("warmup", batch, bucket, collective=True):
            bucket = min(bucket or self.config.length_buckets[0],
                         self._max_prompt_len())
            t0 = time.monotonic()
            ids = np.zeros((batch, bucket), np.int32)
            mask = np.ones((batch, bucket), bool)
            self.generate_ids(ids, mask)
            self._warm_score()
            return time.monotonic() - t0

    @property
    def score_batch_cap(self) -> int:
        """Texts a single-dispatch score quantum holds (the largest batch
        bucket): the scoring tenant's preemption granularity."""
        return max(self.config.batch_buckets)

    def score(self, texts: Sequence[str]) -> List[dict]:
        """Log-likelihood scoring: per text, the total next-token log
        probability, the token count, the perplexity and a `truncated`
        flag (True when the text exceeded the length limit and only its
        prefix was scored). A full-sequence forward with no cache; groups
        larger than the biggest batch bucket run as several device batches
        (`engine/scoring.py`)."""
        with self._spmd.call("score", list(texts), collective=True):
            return score_texts(self, texts)

    def _warm_score(self) -> int:
        """Run the score program over its (batch bucket x length bucket)
        domain; a no-op when scoring is off."""
        return warm_score(self)

    @torch.inference_mode()
    def generate_ids(self, ids: np.ndarray, mask: np.ndarray,
                     real_rows: Optional[int] = None) -> GenerateResult:
        """Generate for a pre-bucketed id batch; records measured TTFT.

        `last_ttft_s` is wall-clock from dispatch to the first sampled
        token being on the host. Results come back as numpy arrays. Under
        speculation `last_spec_tokens_per_window` is set from the first
        `real_rows` rows (default all): batch-bucket filler rows do not
        count.
        """
        t0 = time.monotonic()
        with intended_transfer():  # the batch's upload (a copy that syncs)
            input_ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
            prompt_mask = torch.as_tensor(mask, dtype=torch.bool).to(
                self.device)
        statics = dict(sampling=self.config.sampling,
                       eos_id=self.tokenizer.eos_id,
                       pad_id=self.tokenizer.pad_id, model=self.family)
        self.programs["_prefill"].record(ids.shape)
        state = prefill(self.params, self.cfg, input_ids, prompt_mask,
                        self.generator, **statics)
        with intended_transfer():  # blocks until the token exists
            state.out[:, 0].cpu()
        self.last_ttft_s = time.monotonic() - t0
        k = self.config.spec_tokens
        self.programs["_decode"].record(ids.shape)
        if k > 0:
            result, final = decode_spec(self.params, state, input_ids,
                                        self.cfg, spec_tokens=k, **statics)
            self.decode_steps += final.windows
        else:
            result, final = decode(self.params, state, self.cfg,
                                   segments=self.config.decode_segments,
                                   **statics)
            self.decode_steps += final.step - 1
        with intended_transfer():  # the call's one sanctioned readback
            out = GenerateResult(
                tokens=result.tokens.to(torch.int32).cpu().numpy(),
                lengths=result.lengths.to(torch.int32).cpu().numpy(),
            )
        if k > 0:
            # The prefill's token (one a row, no window) is left out.
            n = len(ids) if real_rows is None else real_rows
            self.last_spec_tokens_per_window = float(
                (out.lengths[:n].sum() - n) / (max(1, final.windows) * n))
        return out

    def answer_batch(self, prompts: Sequence[str]) -> List[str]:
        """The serving entry: prompts in, decoded answers out. Groups larger
        than the biggest batch bucket run as several device batches."""
        if not prompts:
            return []
        with self._spmd.call("answer_batch", list(prompts), collective=True):
            return self._answer_batch(prompts)

    def _answer_batch(self, prompts: Sequence[str]) -> List[str]:
        cap = max(self.config.batch_buckets)
        answers: List[str] = []
        ttfts: List[float] = []
        t_submit = time.monotonic()
        for start in range(0, len(prompts), cap):
            chunk = prompts[start:start + cap]
            ids, mask, _ = self.encode_prompts(chunk)
            queued_s = time.monotonic() - t_submit
            t_gen, t_gen_unix = time.monotonic(), time.time()
            result = self.generate_ids(ids, mask, real_rows=len(chunk))
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
                # Host numpy (read back in generate_ids): no device work.
                toks = [int(t) for t in result.tokens[i, :n]
                        if t != self.tokenizer.eos_id]
                answers.append(self.tokenizer.decode(toks))
        self.last_batch_ttfts = ttfts
        return answers
