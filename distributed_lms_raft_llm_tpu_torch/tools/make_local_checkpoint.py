"""Build the deployment's local HF-layout artifacts: checkpoints and
trained vocabularies, with no `tokenizers` and no `transformers`.

    python -m distributed_lms_raft_llm_tpu_torch.tools.make_local_checkpoint
        [--out data/gpt2-local] [--bert-out data/bert-local]
        [--model gpt2] [--vocab-size 50257] [--seed 0]
        [--device cuda|cpu] [--corpus all|checkout]

writes what `configs/cluster.toml` names:

- `data/gpt2-local/`: a byte-level BPE (`vocab.json`, `merges.txt`)
  trained on local text, and a full-size `GPT2LMHeadModel` state dict of
  seeded random weights (`model.safetensors`, `lm_head.weight` left out:
  tied to `wte`);
- `data/bert-local/`: a WordPiece `vocab.txt` trained on the same text,
  and a full-size `BertModel` state dict (`pooler.*` left out: the gate
  mean-pools).

The files are what the tutoring node and the relevance gate load through
`models/convert.py` (`load_safetensors` -> `gpt2_params_from_hf` /
`bert_params_from_hf`): the same path serves downloaded pretrained weights,
so pointing the flags at those files changes nothing else.

The state dicts have the keys, shapes and float32 dtype of `transformers`'
`GPT2LMHeadModel(GPT2Config(...))` and `BertModel(BertConfig())`, in their
order, drawn by its initialisation law: N(0, 0.02) for embeddings and
weights, 0.02 / sqrt(2 n_layer) for GPT-2's `c_proj` weights, zero biases,
LayerNorm at 1 and 0, BERT's `[PAD]` row of `word_embeddings` zeroed. The
draws come from one `torch.Generator` on `--device` seeded by `--seed`, so
a seed gives the same file, byte for byte, on one device (not
`transformers`' own draws). The vocabularies come from `train_vocab.py`.

Idempotent: a file that exists is kept. The corpus is the repo's Markdown,
the JAX package's modules and the tests, and (`--corpus all`, the default)
the system's Python library and text documentation, 400 files a pattern
at most; `--corpus checkout` keeps to the repo's files.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

REPO = str(Path(__file__).resolve().parents[2])
CHECKOUT_GLOBS = (
    f"{REPO}/*.md",
    f"{REPO}/distributed_lms_raft_llm_tpu/**/*.py",
    f"{REPO}/tests/*.py",
)
CORPUS_GLOBS = {
    "checkout": CHECKOUT_GLOBS,
    "all": CHECKOUT_GLOBS + ("/usr/lib/python3*/[a-z]*.py",
                             "/usr/share/doc/**/*.txt"),
}
GPT2_SMALL = dict(n_embd=768, n_layer=12, n_positions=1024, vocab_size=50257)
GPT2_ARCHS = {  # GPT2Config's fields that differ from GPT-2 small's
    "gpt2": dict(),
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),
}
BERT_BASE = dict(hidden=768, intermediate=3072, layers=12, vocab=30522,
                 positions=512, type_vocab=2, pad_id=0)  # BertConfig()'s
INIT_STD = 0.02  # GPT2Config / BertConfig initializer_range


def build_corpus(out_path: str, max_files: int = 400,
                 patterns: Sequence[str] = CORPUS_GLOBS["all"]) -> dict:
    """Concatenate local prose and code into a training corpus at
    `out_path`, each file followed by a line break; returns its record
    (path, bytes, sha256, files, seconds)."""
    t0 = time.monotonic()
    sources = []
    for pattern in patterns:
        sources.extend(sorted(glob.glob(pattern, recursive=True))[:max_files])
    files = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for src in sources:
            try:
                with open(src, encoding="utf-8", errors="ignore") as f:
                    out.write(f.read())
                    out.write("\n")
                files += 1
            except OSError:
                continue
    with open(out_path, "rb") as f:
        data = f.read()
    return dict(path=out_path, bytes=len(data),
                sha256=hashlib.sha256(data).hexdigest(), files=files,
                seconds=time.monotonic() - t0)


class _Init:
    """The initialisation law's draws, in call order, from one generator
    on `device`."""

    def __init__(self, seed: int, device):
        import torch

        from ..device import resolve_device

        self.torch = torch
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, *shape, std: float = INIT_STD):
        return self.torch.empty(shape, dtype=self.torch.float32,
                                device=self.device).normal_(
            0.0, std, generator=self.gen)

    def ones(self, *shape):
        return self.torch.ones(shape, dtype=self.torch.float32,
                               device=self.device)

    def zeros(self, *shape):
        return self.torch.zeros(shape, dtype=self.torch.float32,
                                device=self.device)


def gpt2_state_dict(model: str = "gpt2", seed: int = 0,
                    device="cuda") -> Dict[str, object]:
    """`GPT2LMHeadModel(GPT2Config(**GPT2_ARCHS[model]))`'s state dict
    less `lm_head.weight`, seeded random (see the module docstring)."""
    arch = {**GPT2_SMALL, **GPT2_ARCHS[model]}
    d, n_layer = arch["n_embd"], arch["n_layer"]
    init = _Init(seed, device)
    proj = INIT_STD / math.sqrt(2 * n_layer)
    sd = {"transformer.wte.weight": init.normal(arch["vocab_size"], d),
          "transformer.wpe.weight": init.normal(arch["n_positions"], d)}
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        sd.update({
            p + "ln_1.weight": init.ones(d), p + "ln_1.bias": init.zeros(d),
            p + "attn.c_attn.weight": init.normal(d, 3 * d),
            p + "attn.c_attn.bias": init.zeros(3 * d),
            p + "attn.c_proj.weight": init.normal(d, d, std=proj),
            p + "attn.c_proj.bias": init.zeros(d),
            p + "ln_2.weight": init.ones(d), p + "ln_2.bias": init.zeros(d),
            p + "mlp.c_fc.weight": init.normal(d, 4 * d),
            p + "mlp.c_fc.bias": init.zeros(4 * d),
            p + "mlp.c_proj.weight": init.normal(4 * d, d, std=proj),
            p + "mlp.c_proj.bias": init.zeros(d),
        })
    sd["transformer.ln_f.weight"] = init.ones(d)
    sd["transformer.ln_f.bias"] = init.zeros(d)
    return sd


def bert_state_dict(seed: int = 0, device="cuda") -> Dict[str, object]:
    """`BertModel(BertConfig())`'s state dict (bert-base-uncased) less
    `pooler.*`, seeded random (see the module docstring)."""
    arch = BERT_BASE
    d, ff = arch["hidden"], arch["intermediate"]
    init = _Init(seed, device)
    words = init.normal(arch["vocab"], d)
    words[arch["pad_id"]] = 0.0
    sd = {"embeddings.word_embeddings.weight": words,
          "embeddings.position_embeddings.weight": init.normal(
              arch["positions"], d),
          "embeddings.token_type_embeddings.weight": init.normal(
              arch["type_vocab"], d),
          "embeddings.LayerNorm.weight": init.ones(d),
          "embeddings.LayerNorm.bias": init.zeros(d)}
    for i in range(arch["layers"]):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            sd[p + name + ".weight"] = init.normal(d, d)
            sd[p + name + ".bias"] = init.zeros(d)
        sd.update({
            p + "attention.output.LayerNorm.weight": init.ones(d),
            p + "attention.output.LayerNorm.bias": init.zeros(d),
            p + "intermediate.dense.weight": init.normal(ff, d),
            p + "intermediate.dense.bias": init.zeros(ff),
            p + "output.dense.weight": init.normal(d, ff),
            p + "output.dense.bias": init.zeros(d),
            p + "output.LayerNorm.weight": init.ones(d),
            p + "output.LayerNorm.bias": init.zeros(d),
        })
    return sd


def _write_checkpoint(path: str, draw) -> dict:
    """`draw()`'s state dict written to `path`: its record, with the
    seconds to draw the weights and to write them."""
    from ..models import convert

    t0 = time.monotonic()
    sd = draw()
    t1 = time.monotonic()
    convert.save_safetensors(path, sd)
    return dict(path=path, params=sum(int(v.numel()) for v in sd.values()),
                bytes=os.path.getsize(path), draw_s=t1 - t0,
                write_s=time.monotonic() - t1)


def _trained_corpus(out_dir: str, corpus: str) -> dict:
    return build_corpus(os.path.join(out_dir, "corpus.txt"),
                        patterns=CORPUS_GLOBS[corpus])


def build_bert_local(out_dir: str, seed: int = 0, vocab_size: int = 30522,
                     device="cuda", corpus: str = "all") -> dict:
    """`out_dir`/vocab.txt (a WordPiece vocabulary trained on the corpus)
    and `out_dir`/model.safetensors (bert-base-uncased, seeded random);
    each skipped where it exists. Returns what was done, with seconds."""
    from . import train_vocab

    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "model.safetensors")
    vocab = os.path.join(out_dir, "vocab.txt")
    record: dict = {}
    if not os.path.exists(vocab):
        record["corpus"] = _trained_corpus(out_dir, corpus)
        t0 = time.monotonic()
        tokens = train_vocab.train_wordpiece([record["corpus"]["path"]],
                                             vocab_size)
        train_vocab.write_wordpiece(out_dir, tokens)
        os.remove(record["corpus"]["path"])
        record["vocab"] = dict(path=vocab, tokens=len(tokens),
                               train_s=time.monotonic() - t0)
        print(f"trained WordPiece vocab: {len(tokens)} tokens -> {vocab}")
    if not os.path.exists(ckpt):
        record["checkpoint"] = _write_checkpoint(
            ckpt, lambda: bert_state_dict(seed, device))
        print(f"wrote bert-base checkpoint: "
              f"{record['checkpoint']['params'] / 1e6:.0f}M params -> {ckpt}")
    return record


def build_gpt2_local(out_dir: str, model: str = "gpt2", seed: int = 0,
                     vocab_size: int = 50257, device="cuda",
                     corpus: str = "all") -> dict:
    """`out_dir`/vocab.json + merges.txt (a byte-level BPE trained on the
    corpus) and `out_dir`/model.safetensors (`model`, seeded random); each
    skipped where it exists. Returns what was done, with seconds."""
    from . import train_vocab

    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "model.safetensors")
    vocab = os.path.join(out_dir, "vocab.json")
    merges = os.path.join(out_dir, "merges.txt")
    record: dict = {}
    if not (os.path.exists(vocab) and os.path.exists(merges)):
        record["corpus"] = _trained_corpus(out_dir, corpus)
        t0 = time.monotonic()
        table, ranked = train_vocab.train_byte_level_bpe(
            [record["corpus"]["path"]], vocab_size)
        train_vocab.write_bpe(out_dir, table, ranked)
        os.remove(record["corpus"]["path"])
        record["vocab"] = dict(path=vocab, tokens=len(table),
                               merges=len(ranked),
                               train_s=time.monotonic() - t0)
        print(f"trained BPE vocab: {len(table)} tokens -> {vocab}")
    if not os.path.exists(ckpt):
        record["checkpoint"] = _write_checkpoint(
            ckpt, lambda: gpt2_state_dict(model, seed, device))
        print(f"wrote {model} checkpoint: "
              f"{record['checkpoint']['params'] / 1e6:.0f}M params -> {ckpt}")
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="data/gpt2-local")
    ap.add_argument("--model", default="gpt2", choices=sorted(GPT2_ARCHS))
    ap.add_argument("--vocab-size", type=int, default=50257)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bert-out", default="data/bert-local",
                    help="BERT gate artifact directory ('' skips)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the weights are drawn (cuda raises without "
                         "a card)")
    ap.add_argument("--corpus", default="all", choices=sorted(CORPUS_GLOBS),
                    help="the training text: the repo's files and the "
                         "system's Python library and docs (all), or the "
                         "repo's files alone (checkout)")
    args = ap.parse_args(argv)
    if args.bert_out:
        build_bert_local(args.bert_out, seed=args.seed, device=args.device,
                         corpus=args.corpus)
    build_gpt2_local(args.out, model=args.model, seed=args.seed,
                     vocab_size=args.vocab_size, device=args.device,
                     corpus=args.corpus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
