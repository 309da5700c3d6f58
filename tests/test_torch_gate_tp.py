"""The relevance gate at tensor parallelism in the port: two gloo ranks on
the CPU, held against the JAX gate at tp 2 (its 8-virtual-device mesh)
on the same weights (the JAX gate's tree carried across), with
tests/test_torch_gate.py's pairs and buckets at the tiny width.

Held here: float32 similarities within 1e-5 of the JAX gate's at tp 2
(tests/test_torch_gate.py's float32 tolerance: summation order) with
equal verdicts on every pair; each rank holding half the word table's
rows; both ranks running every forward (rank 0 checks, rank 1 follows).
A tp that does not divide bert-base's 30,522 word rows (tp 4) is refused
before any process group, as the JAX package refuses it; a group that
does not hold tp ranks is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from test_torch_gate import BUCKETS, CONTEXTS, QUESTIONS
from torch_tp_ranks import Ranks

from distributed_lms_raft_llm_tpu.engine.gate import (
    GateConfig as JaxGateConfig,
    RelevanceGate as JaxGate,
)
from distributed_lms_raft_llm_tpu.models import bert as jax_bert
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.parallel import partition as jax_partition
from distributed_lms_raft_llm_tpu_torch.engine import GateConfig, RelevanceGate
from distributed_lms_raft_llm_tpu_torch.models import convert

TP = 2
F32_TOL = 1e-5
# Every question against every context of a bucket (the truncated and the
# empty context included): 16 pairs, each context a miss then hits.
PAIRS = [(q, c) for q in QUESTIONS[:2] for c in CONTEXTS] + [
    (q, CONTEXTS[1]) for q in QUESTIONS[2:]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(TP, tmp_path_factory.mktemp("gate_rendezvous"))
    yield r
    r.close()


def test_gate_at_tp2_matches_jax_gate_at_tp2(ranks):
    jgate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32, tp=TP,
                                  length_buckets=BUCKETS))
    assert jgate.mesh.shape["tp"] == TP
    want = [jgate.check(q, c) for q, c in PAIRS]
    tree = convert.params_from_jax(jax.device_get(jgate.params),
                                   device="cpu")
    got = ranks.run("gate", tree=tree, pairs=PAIRS,
                    gate_kw=dict(length_buckets=BUCKETS))
    leader, follower = got
    checks = leader["checks"]
    assert [ok for ok, _ in checks] == [ok for ok, _ in want]
    np.testing.assert_allclose([s for _, s in checks],
                               [s for _, s in want], atol=F32_TOL, rtol=0)
    rows = jax_bert.BertConfig.tiny().vocab_size // TP
    assert leader["word_rows"] == follower["word_rows"] == rows
    assert leader["forwards"] == follower["forwards"] > 0


def test_tp4_is_refused_for_bert_base_as_jax_refuses_it():
    """30,522 word rows do not split four ways: the port refuses at
    construction, before it needs a process group; the JAX package
    refuses in `shard_tree`."""
    with pytest.raises(ValueError, match="does not split over tp=4"):
        RelevanceGate(GateConfig(tp=4, device="cpu"))
    table = {"embeddings": {"word": jnp.zeros((30522, 8))}}
    m = jax_mesh.make_mesh({"tp": 4, "dp": -1}, devices=jax.devices()[:8])
    with pytest.raises(ValueError):
        jax_partition.shard_tree(table, m, jax_partition.BERT_RULES)


def test_tp_without_its_ranks_is_refused():
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        RelevanceGate(GateConfig(model="tiny", tp=2, device="cpu",
                                 dtype=torch.float32))
