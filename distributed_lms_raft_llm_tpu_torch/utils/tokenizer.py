"""Tokenizers for the port's serving path and relevance gate — pure Python.

The port's own copy of `distributed_lms_raft_llm_tpu/utils/tokenizer.py`
(less the `tokenizers`-backed `HFTokenizer`):

- `BPETokenizer`  — GPT-2's byte-level BPE, from `vocab.json` + `merges.txt`;
- `WordPieceTokenizer` — BERT's WordPiece, from `vocab.txt`, behind BERT's
  basic pre-split (lowercase, accent stripping, punctuation and CJK
  splits): the relevance gate's tokenizer;
- `ByteTokenizer` — the byte-level fallback (ids 0..255 plus one special)
  used when no vocab files are configured, so the serving stack and the
  gate run end to end with seeded random weights;
- `full_byte_vocab` — a seeded byte-level vocabulary of GPT-2's size in
  which every id decodes to non-empty text (the byte fallback drops every
  id >= 256), for checks that must see each sampled token.

`regex` (GPT-2's pre-tokenization pattern needs \\p classes) is imported
only when a BPE tokenizer is built, so the byte path runs without it.

All expose: `encode(text) -> List[int]`, `decode(ids) -> str`,
`vocab_size`, `eos_id`, `pad_id`; the GPT-2 ones also
`decode_complete(ids) -> str`.
"""

from __future__ import annotations

import codecs
import json
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# GPT-2's exact pre-tokenization pattern (contractions, unicode words,
# numbers, punctuation runs, trailing/other whitespace). \p classes matter:
# é is a letter, not punctuation — ASCII-only approximations break parity
# with HF on any non-English text.
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def _complete_text(data: bytes) -> str:
    """`data` decoded as UTF-8 (errors replaced) without a trailing
    incomplete character: the text no later byte can rewrite."""
    return codecs.getincrementaldecoder("utf-8")("replace").decode(
        data, final=False)


class BPETokenizer:
    """GPT-2 byte-level BPE from vocab.json + merges.txt."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        import regex  # \p{L}/\p{N} classes: required for the exact pattern

        self._pat = regex.compile(_GPT2_PATTERN)
        self.eos_id = self.encoder.get("<|endoftext|>", len(self.encoder) - 1)
        self.pad_id = self.eos_id

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok_bytes):
                ids.append(self.encoder[piece])
        return ids

    def _bytes(self, ids: Sequence[int]) -> bytes:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        return bytes(self.byte_decoder.get(ch, ord("?")) for ch in text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._bytes(ids).decode("utf-8", errors="replace")

    def decode_complete(self, ids: Sequence[int]) -> str:
        """decode() less a trailing incomplete UTF-8 character (an id can
        end inside one): the part of the text later ids cannot rewrite."""
        return _complete_text(self._bytes(ids))


class WordPieceTokenizer:
    """BERT WordPiece from vocab.txt, with BERT basic (lowercase) pre-split."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.unk_id = self.vocab.get("[UNK]", 0)
        self.cls_id = self.vocab.get("[CLS]", 0)
        self.sep_id = self.vocab.get("[SEP]", 0)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.eos_id = self.sep_id

    @classmethod
    def from_file(cls, vocab_path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @staticmethod
    def _is_punct(ch: str) -> bool:
        # BERT's definition: ASCII symbol ranges (treated as punctuation even
        # where unicode says otherwise, e.g. $ ^ `) or any unicode P category.
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        cp = ord(ch)
        return (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        )

    def _split(self, text: str) -> List[str]:
        """BERT basic tokenization: clean, CJK-space, lowercase+strip accents,
        whitespace-split, then isolate punctuation (matches HF BertTokenizer's
        BasicTokenizer so WordPiece sees identical words)."""
        cleaned = []
        for ch in text:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if cp == 0 or cp == 0xFFFD or (cat.startswith("C") and ch not in "\t\n\r"):
                continue
            if ch in "\t\n\r" or cat == "Zs":
                cleaned.append(" ")
            elif self._is_cjk(ch):
                cleaned.append(f" {ch} ")
            else:
                cleaned.append(ch)
        text = "".join(cleaned)
        if self.lowercase:
            text = text.lower()
            text = "".join(
                ch for ch in unicodedata.normalize("NFD", text)
                if unicodedata.category(ch) != "Mn"
            )
        out: List[str] = []
        for chunk in text.split():
            cur = ""
            for ch in chunk:
                if self._is_punct(ch):
                    if cur:
                        out.append(cur)
                        cur = ""
                    out.append(ch)
                else:
                    cur += ch
            if cur:
                out.append(cur)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for word in self._split(text):
            ids.extend(self._wordpiece(word))
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
        out = []
        for t in toks:
            if t in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


class ByteTokenizer:
    """Fallback: UTF-8 bytes as ids 0..255; specials above.

    Keeps every text path (serving, gate, tests, demos) runnable without any
    vocab files. id 256 = BOS/EOS/pad.
    """

    def __init__(self, vocab_size: int = 257):
        assert vocab_size >= 257
        self._vocab_size = vocab_size
        self.eos_id = 256
        self.pad_id = 256
        self.cls_id = 256
        self.sep_id = 256

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in (int(x) for x in ids) if i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_complete(self, ids: Sequence[int]) -> str:
        """decode() less a trailing incomplete UTF-8 character."""
        return _complete_text(bytes(i for i in (int(x) for x in ids)
                                    if i < 256))


def full_byte_vocab(size: int = 50257, seed: int = 0) -> Dict[str, int]:
    """A byte-level BPE vocabulary of `size` entries in which every id
    decodes to non-empty text, built from `seed` (no files, no merges):
    ids 0..255 are the 256 byte symbols (id = byte value), ids 256..size-2
    distinct strings of 2-4 random bytes (many end inside a UTF-8
    character, so a stream's decode is not always prefix-stable), and the
    last id is ``<|endoftext|>`` (eos and pad), as in GPT-2. With
    ``BPETokenizer(full_byte_vocab(), [])`` a random-weight model's every
    sampled id shows in the decoded text."""
    import random

    if size < 258:
        raise ValueError(f"a full byte vocabulary needs > 257 ids, not {size}")
    enc = _bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    rng = random.Random(seed)
    while len(vocab) < size - 1:
        piece = "".join(enc[rng.randrange(256)]
                        for _ in range(rng.randint(2, 4)))
        vocab.setdefault(piece, len(vocab))
    vocab["<|endoftext|>"] = size - 1
    return vocab


class HFTokenizer:
    """A HF `tokenizer.json` through the `tokenizers` library (the JAX
    package's `HFTokenizer`): the format Llama-3-style checkpoints ship
    (byte-level BPE with their own pre-tokenizer). Reads the local file
    only. `tokenizers` is imported here, not with the module: only a node
    serving such a checkpoint needs it."""

    def __init__(self, path: str):
        import tokenizers

        self._tok = tokenizers.Tokenizer.from_file(path)
        self._vocab = self._tok.get_vocab()
        specials = [t for t in ("<|end_of_text|>", "<|endoftext|>", "</s>",
                                "<|eot_id|>") if t in self._vocab]
        self.eos_id = (self._vocab[specials[0]] if specials
                       else self._tok.get_vocab_size() - 1)
        self.pad_id = self.eos_id

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=True)

    def decode_complete(self, ids: Sequence[int]) -> str:
        """decode() less a trailing incomplete UTF-8 character, which the
        byte-level decoder shows as U+FFFD."""
        return self.decode(ids).rstrip("\ufffd")


def load_gpt2_tokenizer(
    vocab_path: Optional[str] = None,
    merges_path: Optional[str] = None,
    tokenizer_json: Optional[str] = None,
):
    """Serving tokenizer resolution, as in the JAX package: an HF
    `tokenizer.json` (Llama) when given, else GPT-2 vocab.json + merges.txt
    BPE when both are given, else the byte fallback."""
    if tokenizer_json:
        return HFTokenizer(tokenizer_json)
    if vocab_path and merges_path:
        return BPETokenizer.from_files(vocab_path, merges_path)
    return ByteTokenizer()


def load_bert_tokenizer(vocab_path: Optional[str] = None):
    """The relevance gate's tokenizer: BERT WordPiece from `vocab.txt` when
    given, else the byte fallback (whose `cls_id`/`sep_id` frame a text as
    WordPiece's do)."""
    if vocab_path:
        return WordPieceTokenizer.from_file(vocab_path)
    return ByteTokenizer()
