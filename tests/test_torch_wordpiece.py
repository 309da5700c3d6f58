"""The port's WordPiece tokenizer against the JAX package's, on the CPU.

The relevance gate tokenizes both texts with BERT's WordPiece
(`utils/tokenizer.py::WordPieceTokenizer`): ids must be equal to the JAX
package's for the same text, so both gates embed the same tokens. Held on
a small vocabulary this test writes itself and on the deployment's
trained vocabulary `data/bert-local/vocab.txt` (built by
scripts/make_local_checkpoint.py; where data/ is absent, that script's
`build_bert_local` trains one on this checkout's text into a temporary
directory, at a reduced size, as tests/test_torch_checkpoint.py does).
Without a vocabulary both packages fall back to the byte tokenizer, framed
by the same [CLS]/[SEP] ids.
"""

import glob
import importlib.util
import os
import shutil

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


def _checkout_corpus(out_path, max_files=400):
    """The builder's corpus over this checkout's files alone."""
    sources = []
    for pattern in (f"{REPO}/*.md",
                    f"{REPO}/distributed_lms_raft_llm_tpu/**/*.py",
                    f"{REPO}/tests/*.py"):
        sources.extend(sorted(glob.glob(pattern, recursive=True))[:max_files])
    with open(out_path, "w", encoding="utf-8") as out:
        for src in sources:
            with open(src, encoding="utf-8", errors="ignore") as f:
                out.write(f.read())
                out.write("\n")
    return out_path


@pytest.fixture(scope="module")
def trained_vocab(tmp_path_factory):
    """data/bert-local/vocab.txt, else one trained by the builder (8,000
    pieces) into a temporary directory removed after the module."""
    if os.path.exists(BERT_VOCAB):
        yield BERT_VOCAB
        return
    spec = importlib.util.spec_from_file_location(
        "make_local_checkpoint",
        os.path.join(REPO, "scripts", "make_local_checkpoint.py"))
    builders = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(builders)
    out = tmp_path_factory.mktemp("bert-local")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builders, "build_corpus", _checkout_corpus)
        builders.build_bert_local(str(out), vocab_size=8000)
    try:
        yield str(out / "vocab.txt")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def test_ids_equal_jax_on_the_trained_vocabulary(trained_vocab):
    tok, jtok = _pair(trained_vocab)
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
