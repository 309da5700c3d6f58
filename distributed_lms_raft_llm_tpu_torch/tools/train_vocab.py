"""Vocabulary trainers for the deployment's tokenizers, in plain Python.

    train_byte_level_bpe(files, vocab_size) -> (vocab, merges)
    write_bpe(out_dir, vocab, merges)       # vocab.json + merges.txt
    train_wordpiece(files, vocab_size)      -> [token, ...] in id order
    write_wordpiece(out_dir, tokens)        # vocab.txt

The byte-level BPE is the trainer of the `tokenizers` library's
`ByteLevelBPETokenizer().train(files, vocab_size, min_frequency,
special_tokens)` followed by `save_model`, rule for rule, so the two
write the same bytes:

- each file is read line by line, the line break kept with its line (a
  pre-token never crosses a line), pre-tokenized with GPT-2's pattern and
  mapped through GPT-2's byte-to-character table;
- ids run: the special tokens, then the 256 byte characters sorted by code
  point, then one id a merge in merge order;
- a merge takes the pair with the highest count, ties going to the lower
  (left id, right id) pair; training stops at the vocabulary size or when
  the best pair counts fewer than `min_frequency`;
- pair counts are updated incrementally from the words a merge touches, as
  that trainer does (a lazily refreshed heap of pairs, each with the words
  it occurs in), so a full-size vocabulary takes seconds.

The WordPiece trainer follows `tokenizers`' `WordPieceTrainer` (under
`BertWordPieceTokenizer().train`): BERT's normalisation and pre-split
(`WordPieceTokenizer._split`), the `limit_alphabet` most frequent
characters, a BPE over words whose non-initial characters carry `##`, and
the special tokens first. That trainer is not deterministic: it visits
words in hash order, so the ids of the `##` characters, and through them
ties between pairs, change from run to run (its `vocab.txt` differs from
run to run in a few tenths of a percent of its tokens). This one fixes
the order: the alphabet by code point (ties at the alphabet's limit drop
the higher code point), the `##` forms by their first occurrence in the
corpus. So the same corpus always gives the same `vocab.txt`.

No `tokenizers`: the card's machine has none. `regex` is needed for
GPT-2's pattern, as by the port's `BPETokenizer`.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

from ..utils.tokenizer import _GPT2_PATTERN, WordPieceTokenizer, _bytes_to_unicode

BPE_SPECIALS = ("<|endoftext|>",)
WORDPIECE_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
PREFIX = "##"

Pair = Tuple[int, int]


def lines_of(files: Sequence[str]) -> Iterator[str]:
    """Each file's lines, each with its own "\\n" (the only break the
    reference trainer splits on: a lone "\\r" or a form feed stays inside
    its line)."""
    for path in files:
        with open(path, encoding="utf-8", newline="") as f:
            text = f.read()
        start = 0
        while start < len(text):
            end = text.find("\n", start)
            end = len(text) if end < 0 else end + 1
            yield text[start:end]
            start = end


def count_words(pieces: Iterable[Iterable[str]]) -> Dict[str, int]:
    """Word -> count, in the order of first occurrence."""
    counts: Dict[str, int] = {}
    for words in pieces:
        for word in words:
            counts[word] = counts.get(word, 0) + 1
    return counts


# BERT's basic split of an ASCII line, fast: control characters dropped,
# tab and line breaks to spaces, lowercase, then runs of other characters
# and single ASCII punctuation marks (`WordPieceTokenizer._split` gives the
# same words; other lines go through it).
_ASCII_CLEAN = {cp: None for cp in [*range(0, 32), 127]}
_ASCII_CLEAN.update({ord("\t"): " ", ord("\n"): " ", ord("\r"): " "})
_ASCII_LOWER = {cp: cp + 32 for cp in range(ord("A"), ord("Z") + 1)}
_PUNCT = r"!-/:-@\[-`{-~"
_ASCII_WORD = re.compile(f"[^ {_PUNCT}]+|[{_PUNCT}]")


def bert_words(splitter: WordPieceTokenizer, line: str) -> List[str]:
    """`splitter._split(line)`, with a fast path for ASCII lines."""
    if not line.isascii():
        return splitter._split(line)
    line = line.translate(_ASCII_CLEAN)
    if splitter.lowercase:
        line = line.translate(_ASCII_LOWER)
    return _ASCII_WORD.findall(line)


def _merge_word(symbols: List[int], a: int, b: int,
                new: int) -> List[Tuple[Pair, int]]:
    """Merge every (a, b) of `symbols` into `new`, left to right, in place;
    return the pair count changes (pair, +1 or -1) of this word, as the
    reference trainer's `Word::merge` gives them."""
    changes: List[Tuple[Pair, int]] = []
    i = 0
    while i < len(symbols):
        if symbols[i] == a and i + 1 < len(symbols) and symbols[i + 1] == b:
            if i > 0:
                changes.append(((symbols[i - 1], a), -1))
                changes.append(((symbols[i - 1], new), 1))
            symbols[i:i + 2] = [new]
            if i < len(symbols) - 1:
                changes.append(((b, symbols[i + 1]), -1))
                changes.append(((new, symbols[i + 1]), 1))
        i += 1
    return changes


def _train_merges(words: List[List[int]], counts: List[int],
                  w2id: Dict[str, int], id2w: List[str], vocab_size: int,
                  min_frequency: int, prefix: str = "") -> List[Tuple[Pair, int]]:
    """The BPE merge loop over `words` (id lists, modified in place) with
    their `counts`; grows `w2id`/`id2w` and returns (pair, new id) per
    merge in order. A stale heap entry is pushed back with its pair's
    current count and its own word set, as the reference does."""
    pair_counts: Dict[Pair, int] = {}
    where: Dict[Pair, set] = {}
    for wi, word in enumerate(words):
        c = counts[wi]
        for pair in zip(word, word[1:]):
            pair_counts[pair] = pair_counts.get(pair, 0) + c
            where.setdefault(pair, set()).add(wi)
    seq = itertools.count()
    heap = [(-pair_counts[p], p, next(seq), pos) for p, pos in where.items()
            if pair_counts[p] > 0]
    heapq.heapify(heap)
    merges: List[Tuple[Pair, int]] = []
    while len(w2id) < vocab_size and heap:
        neg, pair, _, pos = heapq.heappop(heap)
        count = pair_counts[pair]
        if -neg != count:
            heapq.heappush(heap, (-count, pair, next(seq), pos))
            continue
        if count < 1 or count < min_frequency:
            break
        a, b = pair
        right = id2w[b]
        if prefix and right.startswith(prefix):
            right = right[len(prefix):]
        token = id2w[a] + right
        new = w2id.get(token)
        if new is None:
            new = w2id[token] = len(id2w)
            id2w.append(token)
        merges.append((pair, new))
        where = {}
        for wi in pos:
            c = counts[wi]
            for p, change in _merge_word(words[wi], a, b, new):
                pair_counts[p] = pair_counts.get(p, 0) + change * c
                if change > 0:
                    where.setdefault(p, set()).add(wi)
        for p, ws in where.items():
            if pair_counts[p] > 0:
                heapq.heappush(heap, (-pair_counts[p], p, next(seq), ws))
    return merges


def train_byte_level_bpe(files: Sequence[str], vocab_size: int,
                         min_frequency: int = 2,
                         special_tokens: Sequence[str] = BPE_SPECIALS
                         ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A byte-level BPE over `files` (see the module docstring): returns
    (vocab token -> id, merges in rank order) as `save_model` writes them:
    a pair merged twice keeps its later rank only."""
    import regex

    pat = regex.compile(_GPT2_PATTERN)
    enc = _bytes_to_unicode()
    table = {b: enc[b] for b in range(256)}
    word_counts = count_words(
        ("".join(table[b] for b in piece.encode("utf-8"))
         for piece in pat.findall(line)) for line in lines_of(files))
    id2w = list(dict.fromkeys(special_tokens))
    id2w += sorted(set(enc.values()) - set(id2w))
    w2id = {w: i for i, w in enumerate(id2w)}
    words = [[w2id[ch] for ch in word] for word in word_counts]
    merges = _train_merges(words, list(word_counts.values()), w2id, id2w,
                           vocab_size, min_frequency)
    rank = {pair: i for i, (pair, _) in enumerate(merges)}
    ordered = sorted(rank, key=rank.__getitem__)
    return w2id, [(id2w[a], id2w[b]) for a, b in ordered]


def write_bpe(out_dir: str, vocab: Dict[str, int],
              merges: Sequence[Tuple[str, str]]) -> Tuple[str, str]:
    """vocab.json (compact JSON in id order) and merges.txt (a version
    line, then one merge a line) in `out_dir`, as `save_model` writes
    them; returns their paths."""
    vocab_path = os.path.join(out_dir, "vocab.json")
    merges_path = os.path.join(out_dir, "merges.txt")
    ordered = dict(sorted(vocab.items(), key=lambda kv: kv[1]))
    with open(vocab_path, "w", encoding="utf-8", newline="") as f:
        f.write(json.dumps(ordered, ensure_ascii=False,
                           separators=(",", ":")))
    with open(merges_path, "w", encoding="utf-8", newline="") as f:
        f.write("#version: 0.2\n")
        f.write("".join(f"{a} {b}\n" for a, b in merges))
    return vocab_path, merges_path


def train_wordpiece(files: Sequence[str], vocab_size: int,
                    min_frequency: int = 2,
                    special_tokens: Sequence[str] = WORDPIECE_SPECIALS,
                    limit_alphabet: int = 1000,
                    lowercase: bool = True) -> List[str]:
    """A WordPiece vocabulary over `files` (see the module docstring), its
    tokens in id order."""
    splitter = WordPieceTokenizer({}, lowercase=lowercase)
    word_counts = count_words(bert_words(splitter, line)
                              for line in lines_of(files))
    id2w = list(dict.fromkeys(special_tokens))
    w2id = {w: i for i, w in enumerate(id2w)}
    chars: Dict[str, int] = {}
    for word, c in word_counts.items():
        for ch in word:
            chars[ch] = chars.get(ch, 0) + c
    kept = sorted(chars, key=lambda ch: (chars[ch], -ord(ch)))
    kept = sorted(kept[max(0, len(kept) - limit_alphabet):], key=ord)
    for ch in kept:
        if ch not in w2id:
            w2id[ch] = len(id2w)
            id2w.append(ch)
    words = []
    for word in word_counts:
        ids = []
        for i, ch in enumerate(word):
            if ch not in w2id:
                continue  # outside the alphabet: dropped, as the reference
            piece = ch if i == 0 else PREFIX + ch
            if piece not in w2id:
                w2id[piece] = len(id2w)
                id2w.append(piece)
            ids.append(w2id[piece])
        words.append(ids)
    _train_merges(words, list(word_counts.values()), w2id, id2w, vocab_size,
                  min_frequency, prefix=PREFIX)
    return id2w


def write_wordpiece(out_dir: str, tokens: Sequence[str]) -> str:
    """vocab.txt in `out_dir`, one token a line in id order; its path."""
    path = os.path.join(out_dir, "vocab.txt")
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("".join(f"{t}\n" for t in tokens))
    return path
