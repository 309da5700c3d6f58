"""BERT relevance gate: is a student's query related to their assignment?

Port of `distributed_lms_raft_llm_tpu/engine/gate.py`. The LMS calls
`check(query, context)` before a question may reach the tutoring node:
both texts are embedded by the BERT encoder (`models/bert.py`, mean-pooled
over the mask) and the query passes when their cosine similarity reaches
the threshold (0.6, `configs/cluster.toml [gate]`).

As in the JAX package:

- texts are WordPiece ids (`utils/tokenizer.py`; the byte fallback when no
  vocabulary is given), framed by [CLS]/[SEP], cut at the 512 positions
  (which can drop the [SEP]), right-padded to the smallest length bucket
  that holds the longest text of the call;
- the assignment's embedding is cached by its text (cleared wholesale at
  256 entries): a miss embeds [query, context] in one forward, a hit the
  query alone; mask-weighted pooling makes the two agree;
- `quant="int8"` stores the products and the word table as int8 with
  per-channel scales (`models/quant.py`); with bf16 activations the
  products run on the hand-written tensor-core kernel
  (`ops/quant_matmul.py`), 4 launches a layer.

The encoder runs eagerly on `GateConfig.device` ("cuda" unless the caller
asks for the CPU; without a card it raises). The products' weights are cast
to the compute dtype once, at load (`bert.cast_products`). `check` runs on
the LMS's executor threads, several at once: the cache and the forward
count are guarded by a lock, the forward itself shares only read-only
weights (the kernels' launch counters are plain integers, exact only
while one thread launches).

Tensor parallelism (`tp > 1`) and dp, the JAX gate's ``{"tp": tp, "dp":
-1}`` mesh under BERT_RULES: inside a process group of several ranks
(one process each) the gate runs over all of them, laid out by
`make_mesh` with dp taking what tp leaves (or over the `mesh` it is
given); every rank builds the same gate and holds its tp slice of the
encoder (`models/bert.py`), replicated over dp. Rank 0 takes the calls;
each forward (`embed_texts`) is broadcast to the other ranks, which
replay it (`follow()`, `parallel/spmd.py`), so the cache and the check
stay on rank 0. A tp that does not divide the word table's rows
(bert-base's 30,522 at tp 4) or the heads is refused before any group is
needed, as the JAX package refuses it, and so is a group that is not a
multiple of tp. There is no CLI flag for it, as the JAX package has none.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import bert, convert, quant
from ..parallel import mesh as mesh_lib
from ..parallel import partition
from ..parallel.spmd import Replica
from ..utils import tokenizer as tok_lib
from .generate import pick_bucket
from .program_inventory import program_table

log = logging.getLogger(__name__)

CONTEXT_CACHE_ENTRIES = 256


@dataclasses.dataclass
class GateConfig:
    model: str = "bert-base-uncased"  # or "tiny"
    checkpoint: Optional[str] = None  # .safetensors (HF layout)
    vocab_path: Optional[str] = None
    threshold: float = 0.6
    length_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    tp: int = 1
    # Weight-only int8 (models/quant.py), the tutoring engine's recipe.
    quant: Optional[str] = None
    dtype: torch.dtype = torch.bfloat16
    seed: int = 1
    device: str = "cuda"


def gate_axes(config: GateConfig, cfg: bert.BertConfig,
              mesh: Optional[mesh_lib.Mesh] = None
              ) -> Tuple[mesh_lib.ParallelAxis, mesh_lib.ParallelAxis]:
    """The gate's (tp axis, the ranks its host loop spans): `mesh`'s tp
    where given; else SINGLE for both outside a process group of several
    ranks, and inside one `make_mesh({"tp": tp, "dp": -1})` over the
    group, which must be a multiple of tp. The word table's rows and the
    heads are checked first, so a bad split raises before any group is
    needed."""
    if config.tp > 1:
        partition.check_split("embeddings/word", 0, cfg.vocab_size,
                              config.tp)
        partition.validate_tp_heads(cfg.num_heads, config.tp, config.model)
    if mesh is None:
        world = mesh_lib.make_mesh().world_size
        if world == 1 and config.tp == 1:
            return mesh_lib.SINGLE, mesh_lib.SINGLE
        if world % config.tp:
            raise RuntimeError(
                f"GateConfig.tp={config.tp} runs one process a rank: join a "
                f"process group of {config.tp} ranks (or a multiple of "
                f"them, dp taking the rest) first; this one holds {world}")
        mesh = mesh_lib.make_mesh({"tp": config.tp, "dp": -1})
    if mesh.shape["tp"] != config.tp:
        raise ValueError(f"the mesh's tp={mesh.shape['tp']} is not "
                         f"GateConfig.tp={config.tp}")
    tp = mesh.tensor_parallel()
    return tp, tp if tp.size == mesh.world_size else mesh.world()


class RelevanceGate:
    def __init__(self, config: GateConfig,
                 mesh: Optional[mesh_lib.Mesh] = None):
        if config.quant not in (None, "int8"):
            raise ValueError(f"unsupported quant mode {config.quant!r}")
        self.config = config
        self.device = resolve_device(config.device)
        factory = (bert.BertConfig.tiny if config.model == "tiny"
                   else bert.BertConfig.base_uncased)
        self.cfg = factory(dtype=config.dtype)
        self.tensor_parallel, ranks = gate_axes(config, self.cfg, mesh)
        self.dp = ranks.size // self.tensor_parallel.size
        self.cfg = dataclasses.replace(self.cfg,
                                       tensor_parallel=self.tensor_parallel)
        # Over several ranks: rank 0's forwards, replayed on the others.
        self._spmd = Replica(self, ranks)
        self.tokenizer = tok_lib.load_bert_tokenizer(config.vocab_path)
        if self.tokenizer.vocab_size > self.cfg.vocab_size:
            raise ValueError("tokenizer vocab exceeds model vocab")
        if config.checkpoint:
            sd = convert.load_safetensors(config.checkpoint)
            params = convert.bert_params_from_hf(sd, self.cfg, self.device)
        else:
            log.warning("no BERT checkpoint configured — random init")
            params = bert.init_params(self.cfg, config.seed, self.device)
        if config.quant:
            params = quant.quantize_params(params, "bert")
        params = bert.cast_products(params, self.cfg.dtype)
        tp = self.tensor_parallel
        self.params = partition.shard_params(
            params, partition.slicing_rules("bert"), tp.rank, tp.size)
        # Context (assignment text) embeddings are static per student and
        # re-checked on every query: caching them halves a hit's forward.
        self._ctx_cache: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.forwards = 0  # encoder forwards run; guarded-by: _lock
        # The (batch, length) shapes the encoder ran at (host only).
        self.programs = program_table("RelevanceGate")

    def _encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        limit = self.cfg.max_position_embeddings
        token_lists = [
            self.tokenizer.encode(t, add_special_tokens=True)[:limit]
            for t in texts
        ]
        longest = max(len(t) for t in token_lists)
        bucket = min(pick_bucket(longest, self.config.length_buckets), limit)
        ids = np.full((len(texts), bucket), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(texts), bucket), np.int64)
        for i, toks in enumerate(token_lists):
            toks = toks[:bucket]
            ids[i, : len(toks)] = toks  # BERT: right-padding
            mask[i, : len(toks)] = 1
        return ids, mask

    def follow(self, on_result=None) -> None:
        """A tp rank other than 0: replay rank 0's forwards until it stops
        (`stop_followers`; `Replica.follow`)."""
        self._spmd.follow(on_result)

    def stop_followers(self) -> None:
        """Rank 0: release the other ranks from `follow`."""
        self._spmd.stop()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Sentence embeddings [len(texts), D], numpy float32, from one
        forward (on every tp rank)."""
        with self._spmd.call("embed_texts", list(texts), collective=True):
            return self._embed_texts(texts)

    def _embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        ids, mask = self._encode(texts)
        self.programs["_embed"].record(ids.shape)
        with torch.inference_mode():
            out = bert.embed(
                self.params, self.cfg,
                torch.as_tensor(ids, device=self.device),
                attention_mask=torch.as_tensor(mask, device=self.device),
            )
            emb = out.cpu().numpy()
        with self._lock:
            self.forwards += 1
        return emb

    def check(self, query: str, context: str) -> Tuple[bool, float]:
        """(passes_gate, cosine_similarity) as Python values.

        A miss embeds [query, context] in ONE forward and caches the
        context half; a hit embeds the query alone.
        """
        with self._lock:
            ctx_emb = self._ctx_cache.get(context)
        if ctx_emb is None:
            emb = self.embed_texts([query, context])
            q_emb, ctx_emb = emb[0], emb[1]
            with self._lock:
                if len(self._ctx_cache) >= CONTEXT_CACHE_ENTRIES:
                    self._ctx_cache.clear()
                self._ctx_cache[context] = ctx_emb
        else:
            q_emb = self.embed_texts([query])[0]
        sim = float(
            np.dot(q_emb, ctx_emb)
            / max(float(np.linalg.norm(q_emb) * np.linalg.norm(ctx_emb)),
                  1e-12)
        )
        return sim >= self.config.threshold, sim

    def warmup(self) -> None:
        self.embed_texts(["warmup"])
