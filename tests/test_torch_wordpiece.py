"""The port's WordPiece tokenizer against the JAX package's, on the CPU.

The relevance gate tokenizes both texts with BERT's WordPiece
(`utils/tokenizer.py::WordPieceTokenizer`): ids must be equal to the JAX
package's for the same text, so both gates embed the same tokens. Held on
a small vocabulary this test writes itself (always runs) and on the
deployment's trained vocabulary `data/bert-local/vocab.txt` (skipped
where absent; built by scripts/make_local_checkpoint.py). Without a
vocabulary both packages fall back to the byte tokenizer, framed by the
same [CLS]/[SEP] ids.
"""

import os

import pytest

from distributed_lms_raft_llm_tpu.utils import tokenizer as jax_tok
from distributed_lms_raft_llm_tpu_torch.utils import tokenizer as port_tok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT_VOCAB = os.path.join(REPO, "data", "bert-local", "vocab.txt")

TEXTS = [
    "How does Raft elect a leader?",
    "Naïve café résumé über STRASSE Ångström",  # accents stripped
    "日本語のテキストと中文文本",                    # CJK split per character
    "punctuation!!! (brackets) [more], $money^ `ticks` a-b_c ... ?!",
    "x" * 101 + " short",                          # past the piece limit
    "unaffordable zyzzyva qwxq",                   # unknown words
    "  tabs\tand\nnewlines\r\nand  spaces  ",
    "control\x00chars�and​zero width",
    "",
]

# A small vocabulary: the specials in BERT's order, single characters,
# whole words and continuation pieces, each once.
SMALL_VOCAB = list(dict.fromkeys(
    ["[PAD]"] + [f"[unused{i}]" for i in range(3)]
    + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + list("abcdefghijklmnopqrstuvwxyz0123456789!?.,()[]$^`-_")
    + ["日", "本", "中", "文"]
    + ["how", "does", "raft", "elect", "a", "leader", "naive", "cafe",
       "resume", "uber", "strasse", "angstrom", "short", "un", "afford",
       "tabs", "and", "new", "lines", "spaces", "control", "chars", "zero",
       "width", "punctuation", "brackets", "more", "money", "ticks"]
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    + ["##able", "##ford", "##afford", "##s", "##lines"]
))


@pytest.fixture(scope="module")
def small_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("wordpiece") / "vocab.txt"
    path.write_text("\n".join(SMALL_VOCAB) + "\n", encoding="utf-8")
    return str(path)


def _pair(vocab_path):
    return (port_tok.load_bert_tokenizer(vocab_path),
            jax_tok.load_bert_tokenizer(vocab_path))


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("specials", [True, False])
def test_ids_equal_jax_on_a_small_vocabulary(small_vocab, text, specials):
    tok, jtok = _pair(small_vocab)
    assert isinstance(tok, port_tok.WordPieceTokenizer)
    ids = tok.encode(text, add_special_tokens=specials)
    assert ids == jtok.encode(text, add_special_tokens=specials)
    assert tok.decode(ids) == jtok.decode(ids)


def test_small_vocabulary_cases(small_vocab):
    """What each case exercises: specials at BERT's ids, lowercasing with
    accents stripped, a word past 100 characters and an unknown word as
    one [UNK], greedy longest-match continuation pieces."""
    tok, _ = _pair(small_vocab)
    assert (tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id) == (0, 4, 5, 6)
    assert tok.vocab_size == len(SMALL_VOCAB)
    assert tok.encode("") == [tok.cls_id, tok.sep_id]
    assert tok.decode(tok.encode("Naïve CAFÉ")) == "naive cafe"
    assert tok.encode("x" * 101, add_special_tokens=False) == [tok.unk_id]
    assert tok.encode("zyzzyva", add_special_tokens=False) == [
        tok.vocab["z"], tok.vocab["##y"], tok.vocab["##z"], tok.vocab["##z"],
        tok.vocab["##y"], tok.vocab["##v"], tok.vocab["##a"]]
    assert tok.encode("unaffordable", add_special_tokens=False) == [
        tok.vocab["un"], tok.vocab["##afford"], tok.vocab["##able"]]
    assert tok.encode("中文 x", add_special_tokens=False) == [
        tok.vocab["中"], tok.vocab["文"], tok.vocab["x"]]
    assert tok.encode("é€", add_special_tokens=False) == [tok.unk_id]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_fallback_equals_jax(text):
    tok, jtok = _pair(None)
    assert isinstance(tok, port_tok.ByteTokenizer)
    assert tok.encode(text, add_special_tokens=True) == jtok.encode(
        text, add_special_tokens=True)
    assert (tok.cls_id, tok.sep_id, tok.pad_id, tok.vocab_size) == (
        jtok.cls_id, jtok.sep_id, jtok.pad_id, jtok.vocab_size)


@pytest.mark.skipif(not os.path.exists(BERT_VOCAB),
                    reason="data/bert-local is absent (built by "
                    "scripts/make_local_checkpoint.py)")
def test_ids_equal_jax_on_the_trained_vocabulary():
    tok, jtok = _pair(BERT_VOCAB)
    assert tok.vocab_size == jtok.vocab_size
    assert (tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id) == (
        jtok.pad_id, jtok.unk_id, jtok.cls_id, jtok.sep_id)
    corpus = TEXTS + [
        "Distributed systems, CS 451 notes, week 6: Raft keeps a replicated "
        "log consistent across servers by electing a leader.",
        "naïve café résumé über straße — mixed: αβγ δ, кириллица, עברית",
        "emoji 🙂🚀 and symbols ∑∫√ and ½ " * 4,
    ]
    for text in corpus:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.decode(ids) == jtok.decode(ids)
