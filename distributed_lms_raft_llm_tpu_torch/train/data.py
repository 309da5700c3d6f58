"""Course-text data pipeline for fine-tuning the tutoring model.

The port's copy of `distributed_lms_raft_llm_tpu/train/data.py`, its
logic as it is (numpy, and the port's `utils/pdf.py` through the same
relative import): for the same inputs its batches equal the JAX
package's, array for array.

The training story the LMS implies (SURVEY.md §2.2: no training in the
reference, models frozen from the hub): fine-tune GPT-2 on the course's own
materials so the tutor answers in-domain. Sources are plain-text or PDF
files — the same PDFs instructors upload through `LMS.Post`
(utils/pdf.py extracts their text, the identical path the BERT gate uses,
reference analogue lms_server.py:918).

Pipeline shape (TPU-first): tokenize once, concatenate with EOS joints,
and PACK into fixed [B, T] blocks — static shapes, no padding waste, every
token supervised (loss_mask all-ones except the leading position of each
block which has no preceding context beyond the pack boundary; packing
keeps it simple and dense, the standard LM recipe). Shuffling is
deterministic per epoch via a seeded permutation of block starts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils import pdf as pdf_lib


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0


def load_corpus_texts(paths: Sequence[str]) -> List[str]:
    """Read .txt/.md as UTF-8 and .pdf via the stdlib extractor; directories
    are walked recursively in sorted order (deterministic)."""
    texts: List[str] = []
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names))
        else:
            files.append(p)
    for f in sorted(files):
        ext = os.path.splitext(f)[1].lower()
        if ext == ".pdf":
            with open(f, "rb") as fh:
                text = pdf_lib.extract_text(fh.read())
        elif ext in (".txt", ".md", ""):
            with open(f, "r", encoding="utf-8", errors="replace") as fh:
                text = fh.read()
        else:
            continue
        if text.strip():
            texts.append(text)
    return texts


def pack_tokens(
    texts: Sequence[str], tokenizer, seq_len: int
) -> np.ndarray:
    """Tokenize + concatenate (EOS between documents) + reshape into
    [num_blocks, seq_len]; the ragged tail is dropped (static shapes)."""
    stream: List[int] = []
    for text in texts:
        stream.extend(tokenizer.encode(text))
        stream.append(tokenizer.eos_id)
    n_blocks = len(stream) // seq_len
    if n_blocks == 0:
        raise ValueError(
            f"corpus too small: {len(stream)} tokens < seq_len {seq_len}"
        )
    return np.asarray(
        stream[: n_blocks * seq_len], np.int32
    ).reshape(n_blocks, seq_len)


class PackedDataset:
    """Deterministically shuffled epochs of packed [B, T] batches."""

    def __init__(self, blocks: np.ndarray, cfg: DataConfig):
        if len(blocks) < cfg.batch_size:
            raise ValueError(
                f"{len(blocks)} blocks < batch_size {cfg.batch_size}; "
                f"lower batch_size/seq_len or add course material"
            )
        self.blocks = blocks
        self.cfg = cfg

    @classmethod
    def from_paths(
        cls, paths: Sequence[str], tokenizer, cfg: DataConfig
    ) -> "PackedDataset":
        texts = load_corpus_texts(paths)
        if not texts:
            raise ValueError(f"no usable .txt/.md/.pdf files under {paths}")
        return cls(pack_tokens(texts, tokenizer, cfg.seq_len), cfg)

    def batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of {input_ids, loss_mask} batches, seeded by epoch."""
        order = np.random.default_rng(
            self.cfg.seed + epoch
        ).permutation(len(self.blocks))
        b = self.cfg.batch_size
        for start in range(0, len(order) - b + 1, b):
            ids = self.blocks[order[start : start + b]]
            yield {
                "input_ids": ids,
                "loss_mask": np.ones_like(ids, bool),
            }

    def steps_per_epoch(self) -> int:
        return len(self.blocks) // self.cfg.batch_size
