"""The port's artifact tools against the references they replace, on the
CPU: `tools/train_vocab.py` against the `tokenizers` trainers,
`tools/make_local_checkpoint.py`'s state dicts against `transformers`'
models, `tools/profile_decode.py`'s dispatch-gap counts against
scripts/profile_decode.py, and `tools/regen_proto_stream.py` against
scripts/regen_proto_stream.py.

- The byte-level BPE writes `vocab.json` and `merges.txt` byte-equal to
  `ByteLevelBPETokenizer().train(...)` + `save_model` (on this checkout's
  corpus, and on a text of whitespace runs, CRLF, tabs, a lone carriage
  return, non-ASCII and tied counts).
- The WordPiece trainer is deterministic, puts the special tokens first,
  and differs from a `tokenizers` run in at most 1% of its tokens (two
  `tokenizers` runs differ from each other: that trainer visits words in
  hash order); both packages' WordPiece tokenizers encode the corpus alike
  under the port's `vocab.txt`.
- The builders import no `jax`, `tokenizers`, `transformers` or JAX
  package module.
"""

import filecmp
import hashlib
import importlib.util
import json
import math
import os
import signal
import subprocess
import sys

import jax
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.utils.tokenizer import (
    WordPieceTokenizer as JaxWordPiece,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.tools import (
    make_local_checkpoint as mk,
    profile_decode,
    regen_proto_stream,
    train_vocab,
)
from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import WordPieceTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED_VOCAB = 8000  # tests/test_torch_checkpoint.py's
FIXED_TEXT = ("ab ab cd cd\r\nef  \t  gh\r\n" * 3
              + "naïve café   résumé\n\n\n    indented\tand\ttabs\n"
              + "lone\rcarriage\x0cform feed\n"
              + "日本語 日本語 über über straße\n" * 2
              + "xy xy zw zw\n   \n\t\t\nemoji 🙂🙂 🚀\n"
              + "it's we'll they're 12345 3.14\n") * 3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """This checkout's corpus (the builders' `--corpus checkout`)."""
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    return mk.build_corpus(str(path), patterns=mk.CORPUS_GLOBS["checkout"])


@pytest.mark.parametrize("which,vocab_size", [("checkout", REDUCED_VOCAB),
                                              ("fixed_text", 400)])
def test_bpe_files_byte_equal_to_tokenizers(tmp_path, corpus, which,
                                            vocab_size):
    tokenizers = pytest.importorskip("tokenizers")
    path = corpus["path"]
    if which == "fixed_text":
        path = str(tmp_path / "fixed.txt")
        with open(path, "w", encoding="utf-8", newline="") as f:
            f.write(FIXED_TEXT)
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    bpe = tokenizers.ByteLevelBPETokenizer()
    bpe.train([path], vocab_size=vocab_size, min_frequency=2,
              special_tokens=["<|endoftext|>"], show_progress=False)
    bpe.save_model(str(ref))
    vocab, merges = train_vocab.train_byte_level_bpe([path], vocab_size)
    train_vocab.write_bpe(str(port), vocab, merges)
    for name in ("vocab.json", "merges.txt"):
        assert filecmp.cmp(ref / name, port / name, shallow=False), name
    assert len(vocab) > 300 and vocab["<|endoftext|>"] == 0


@pytest.fixture(scope="module")
def wordpiece(corpus, tmp_path_factory):
    """The port's vocab.txt at REDUCED_VOCAB over the corpus, twice, and
    one `tokenizers` run's tokens."""
    tokenizers = pytest.importorskip("tokenizers")
    runs = [train_vocab.train_wordpiece([corpus["path"]], REDUCED_VOCAB)
            for _ in range(2)]
    out = tmp_path_factory.mktemp("wordpiece")
    path = train_vocab.write_wordpiece(str(out), runs[0])
    wp = tokenizers.BertWordPieceTokenizer(lowercase=True)
    wp.train([corpus["path"]], vocab_size=REDUCED_VOCAB, min_frequency=2,
             special_tokens=list(train_vocab.WORDPIECE_SPECIALS),
             show_progress=False)
    wp.save_model(str(out), "ref")
    with open(out / "ref-vocab.txt", encoding="utf-8") as f:
        ref = f.read().split("\n")[:-1]
    return runs, path, ref


def test_wordpiece_is_deterministic_and_within_a_percent(wordpiece):
    (first, second), path, ref = wordpiece
    assert first == second
    assert first[:5] == list(train_vocab.WORDPIECE_SPECIALS) == ref[:5]
    assert len(set(first)) == len(first) == len(ref) == REDUCED_VOCAB
    differ = len(set(first) ^ set(ref)) / 2
    assert differ <= 0.01 * REDUCED_VOCAB
    with open(path, encoding="utf-8") as f:
        assert f.read() == "".join(t + "\n" for t in first)


def test_both_wordpiece_tokenizers_encode_alike(wordpiece, corpus):
    _, path, _ = wordpiece
    port, jax_tok = (WordPieceTokenizer.from_file(path),
                     JaxWordPiece.from_file(path))
    lines = list(train_vocab.lines_of([corpus["path"]]))
    sample = lines[::25] + [ln for ln in lines if not ln.isascii()][:500]
    sample += FIXED_TEXT.split("\n")
    unknown = 0
    for line in sample:
        ids = port.encode(line)
        assert ids == jax_tok.encode(line)
        assert train_vocab.bert_words(port, line) == port._split(line)
        unknown += ids.count(port.unk_id)
    assert unknown < len(sample)


@pytest.fixture(scope="module")
def reference_dicts():
    """transformers' models' state dicts on the meta device: (name, shape,
    dtype) in order, less the tied head and the pooler."""
    transformers = pytest.importorskip("transformers")
    with torch.device("meta"):
        gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config())
        bert = transformers.BertModel(transformers.BertConfig())
    return {name: [(k, tuple(v.shape), v.dtype)
                   for k, v in model.state_dict().items()
                   if k != "lm_head.weight" and not k.startswith("pooler.")]
            for name, model in (("gpt2", gpt2), ("bert", bert))}


def _law(name: str) -> tuple:
    """(mean, std) of a tensor by the initialisation law."""
    if name.endswith("bias"):
        return 0.0, 0.0
    if "ln" in name or "LayerNorm" in name:
        return 1.0, 0.0
    if "c_proj" in name:
        return 0.0, 0.02 / math.sqrt(24)
    return 0.0, 0.02


@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_state_dicts_match_transformers_and_the_law(reference_dicts, model):
    sd = (mk.gpt2_state_dict(seed=0, device="cpu") if model == "gpt2"
          else mk.bert_state_dict(seed=0, device="cpu"))
    assert [(k, tuple(v.shape), v.dtype) for k, v in sd.items()] == \
        reference_dicts[model]
    for name, value in sd.items():
        mean, std = _law(name)
        if model == "bert" and name == "embeddings.word_embeddings.weight":
            assert not value[0].any()  # the [PAD] row
            value = value[1:]
        assert abs(float(value.mean()) - mean) < 3e-3, name
        assert abs(float(value.std()) - std) < 0.05 * 0.02 + 1e-7, name


def test_a_seed_gives_the_same_file(tmp_path):
    digests = []
    for seed, name in ((0, "a"), (0, "b")):
        path = str(tmp_path / f"{name}.safetensors")
        mk._write_checkpoint(path, lambda s=seed: mk.bert_state_dict(s, "cpu"))
        with open(path, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
        os.remove(path)
    assert digests[0] == digests[1]
    other = mk.bert_state_dict(1, "cpu")
    same = mk.bert_state_dict(0, "cpu")
    k = "encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(other[k], same[k])
    assert torch.equal(other["embeddings.LayerNorm.weight"],
                       same["embeddings.LayerNorm.weight"])


def test_the_tools_import_no_reference_package(tmp_path):
    """With `jax`, `tokenizers`, `transformers` and the JAX package
    unimportable, the builders run (a reduced BPE) and both other tools
    answer `--help`."""
    code = (
        "import sys\n"
        "for m in ('jax', 'tokenizers', 'transformers',\n"
        "          'distributed_lms_raft_llm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from distributed_lms_raft_llm_tpu_torch.tools import (\n"
        "    make_local_checkpoint, profile_decode, regen_proto_stream)\n"
        "make_local_checkpoint.main(['--out', sys.argv[1], '--bert-out',\n"
        "    sys.argv[2], '--vocab-size', '600', '--device', 'cpu',\n"
        "    '--corpus', 'checkout'])\n"
        "for tool in (profile_decode, regen_proto_stream):\n"
        "    try:\n"
        "        tool.main(['--help'])\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code == 0\n"
        "print('ok')\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "g"), str(tmp_path / "b")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    with open(tmp_path / "g" / "vocab.json", encoding="utf-8") as f:
        assert len(json.load(f)) == 600
    assert sorted(os.listdir(tmp_path / "b")) == ["model.safetensors",
                                                   "vocab.txt"]


MEGASTEP_ARGS = ["--megastep", "4", "--model", "tiny", "--greedy",
                 "--batch", "2", "--chunk", "2"]
MEGASTEP_KEYS = ("host_dispatches", "emitted_tokens",
                 "megastep_dead_lane_tokens")


def test_dispatch_gap_counts_equal_the_jax_script(tmp_path, monkeypatch):
    import distributed_lms_raft_llm_tpu.engine as jax_engine

    trees = []

    class Recorded(jax_engine.PagedEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trees.append(jax.device_get(self.params))

    monkeypatch.setattr(jax_engine, "PagedEngine", Recorded)
    script = _script("profile_decode")
    ns = script.__dict__["argparse"].Namespace
    out = tmp_path / "jax.json"
    script.profile_megastep(ns(
        batch=2, bf16=False, out=str(out), spec_tokens=0, greedy=True,
        megastep=4, model="tiny", chunk=2, tp=1, ep=1))
    with open(out) as f:
        want = json.load(f)
    args = profile_decode.build_parser().parse_args(
        MEGASTEP_ARGS + ["--device", "cpu"])
    got = profile_decode.profile_megastep(
        args, params=params_from_jax(trees[0], torch.float32, device="cpu"))
    for run in ("before", "after"):
        assert got[run]["megastep"] == want[run]["megastep"]
        assert {k: got[run][k] for k in MEGASTEP_KEYS} == \
            {k: want[run][k] for k in MEGASTEP_KEYS}
    assert got["after"]["host_dispatches"] < got["before"]["host_dispatches"]


@pytest.mark.parametrize("mode", ["megastep", "device"])
def test_two_tp_ranks_under_torchrun(tmp_path, mode):
    """`--tp 2` under torchrun over gloo on the CPU: the ranks join as the
    node's do, rank 1 follows rank 0's calls, rank 0 alone writes, and the
    dispatch-gap counts equal one rank's."""
    out = tmp_path / "tp2.json"
    flags = (MEGASTEP_ARGS if mode == "megastep" else
             ["--model", "tiny", "--greedy", "--batch", "2"])
    # A session of its own, so a hang takes torchrun's ranks down with it.
    run = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", profile_decode.__name__, *flags,
         "--device", "cpu", "--tp", "2", "--tp-backend", "gloo",
         "--out", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = run.communicate(timeout=120)
    finally:
        if run.poll() is None:
            os.killpg(run.pid, signal.SIGKILL)
            run.wait()
    assert run.returncode == 0, stderr[-3000:]
    assert stdout.count("wrote ") == 1
    with open(out) as f:
        got = json.load(f)
    if mode == "device":
        assert got["decode_steps"] > 0 and got["scopes_ms"]["attention"] > 0
        return
    one = profile_decode.profile_megastep(profile_decode.build_parser(
        ).parse_args(MEGASTEP_ARGS + ["--device", "cpu"]))
    for key in ("before", "after"):
        assert {k: got[key][k] for k in MEGASTEP_KEYS} == \
            {k: one[key][k] for k in MEGASTEP_KEYS}


def test_device_mode_credits_kernels_to_module_scopes(tmp_path):
    """The device mode on the CPU (leaf ATen ops for kernels): every
    module scope holds time, and the scopes add up to the total."""
    out = tmp_path / "decode.json"
    assert profile_decode.main(["--model", "tiny", "--device", "cpu",
                                "--greedy", "--batch", "2",
                                "--out", str(out)]) == 0
    with open(out) as f:
        payload = json.load(f)
    scopes = payload["scopes_ms"]
    for scope in ("embed", "ln1", "qkv", "attention", "attn_out", "ln2",
                  "mlp_in", "mlp_out", "block", "ln_f", "unembed",
                  profile_decode.OUTSIDE):
        assert scopes.get(scope, 0) > 0, scope
    assert sum(scopes.values()) == pytest.approx(payload["total_device_ms"])
    assert payload["decode_steps"] > 0 and payload["kernels"] > 0
    rows = payload["ops_ms"]
    assert all(sum(r["scopes"].values()) == pytest.approx(r["ms"])
               for r in rows)


def test_port_launches_take_the_innermost_open_scope():
    """Each of the port's launches (counted by their wrappers, by route) is
    credited to the innermost module scope open when it ran, in launch
    order; where a trace lost records of a route launched in several
    scopes, its kernels stand unmatched, and a trace holding more kernels
    than were launched raises."""
    scopes = profile_decode.ModuleScopes()

    def at(x, y=0):
        return {"x": x, "y": y}

    scopes.marks = [(at(12), "block"), (at(12), "ln1"), (at(12), None),
                    (at(12), "qkv"), (at(13), None), (at(13), "attention"),
                    (at(15, 1), None), (at(16, 1), "mlp_out"),
                    (at(17, 1), None), (at(17, 1), None)]
    out = profile_decode.OUTSIDE
    assert scopes.launch_scopes(at(10), at(18, 2)) == {
        "x": [out, out, "qkv", "attention", "attention", "block", "mlp_out",
              out],
        "y": ["attention", out]}
    credit = profile_decode.port_kernel_scopes
    assert credit(3, list("abc")) == (list("abc"), "launch_order")
    assert credit(2, list("aaa")) == (list("aa"), "launch_scope")
    assert credit(2, list("abc")) == ([profile_decode.UNMATCHED] * 2,
                                      "unmatched")
    with pytest.raises(ValueError, match="launched 2 times"):
        credit(3, list("ab"))


def test_regen_proto_stream_writes_the_committed_bytes():
    got = regen_proto_stream.regenerate()
    with open(regen_proto_stream.PB2_PATH, "rb") as f:
        assert got == f.read()
    assert got == _script("regen_proto_stream").regenerate()
