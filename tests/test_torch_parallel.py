"""The port's `parallel/` (mesh, partition rules, each rank's slice, the
replicated loop's plumbing) held against the JAX package's
`parallel/mesh.py` and `parallel/partition.py` on the 8-virtual-device CPU
mesh: the same mesh sizes and errors, the same specs on the same trees,
the same head-split checks, and the divisibility refusals exactly where the
JAX `shard_tree` raises; `make_hybrid_mesh`'s rank layout against JAX's
`create_hybrid_device_mesh`. No process group is needed here (the ranks
run in tests/test_torch_tp.py).
"""

import dataclasses
import re
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_tp_ranks import jax_hybrid_ranks

from distributed_lms_raft_llm_tpu.models import bert as jax_bert
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import llama as jax_llama
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.parallel import partition as jax_partition
from distributed_lms_raft_llm_tpu_torch.engine import EngineConfig, PagedEngine
from distributed_lms_raft_llm_tpu_torch.engine import TutoringEngine
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.parallel import mesh, partition, spmd

# ------------------------------------------------------------------ mesh

MESH_CASES = [
    ({"tp": 2, "dp": -1}, 8),
    ({"tp": 2}, 8),                # the remainder goes to dp
    ({"tp": 4, "ep": 2}, 8),
    ({"tp": -1}, 8),
    ({}, 8),
    ({"tp": 2}, 2),
    ({"tp": 3}, 8),                # not a divisor, dp set implicitly
    ({"tp": 2, "dp": 2}, 8),       # explicit sizes that miss the count
    ({"tp": -1, "dp": 3}, 8),      # -1 over a non-divisor
    ({"tp": -1, "dp": -1}, 8),     # two inferred axes
    ({"xp": 2}, 8),                # unknown axis
]


def _jax_sizes(axis_sizes, n):
    try:
        m = jax_mesh.make_mesh(axis_sizes, devices=jax.devices()[:n])
    except ValueError as e:
        return "error", str(e)
    return "ok", dict(m.shape)


def _port_sizes(axis_sizes, n):
    try:
        m = mesh.make_mesh(axis_sizes, world_size=n, rank=0)
    except ValueError as e:
        return "error", str(e)
    return "ok", m.shape


@pytest.mark.parametrize("axis_sizes,n", MESH_CASES,
                         ids=[str(i) for i in range(len(MESH_CASES))])
def test_make_mesh_sizes_and_errors_equal_jax(axis_sizes, n):
    assert _port_sizes(axis_sizes, n) == _jax_sizes(axis_sizes, n)


def test_mesh_coordinates_put_tp_innermost():
    """Rank r's tp index is r mod tp, as device r sits in JAX's mesh."""
    sizes = {"tp": 2, "dp": -1}
    jm = jax_mesh.make_mesh(sizes, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        coords = mesh.make_mesh(sizes, world_size=8, rank=rank).coords()
        where = np.argwhere(ids == jax.devices()[rank].id)[0]
        assert [coords[a] for a in jm.axis_names] == list(where)


def test_only_tp_may_spread_the_ranks():
    """pp above 1 inside one engine is refused loudly (the pipeline is the
    trainer's); dp, ep and sp may spread the ranks beside tp (an engine's
    world is dp x tp x ep x sp), each axis' ranks those that share every
    other coordinate."""
    m = mesh.make_mesh({"tp": 2, "dp": -1}, world_size=8, rank=5)
    tp = m.tensor_parallel()
    assert (tp.size, tp.rank, m.coords()["dp"]) == (2, 1, 2)
    assert (m.axis_ranks("tp"), m.axis_ranks("dp")) == ((4, 5), (1, 3, 5, 7))
    with pytest.raises(NotImplementedError, match="pp"):
        mesh.make_mesh({"tp": 2, "pp": 2}, world_size=4,
                       rank=0).tensor_parallel()
    tp = mesh.make_mesh({"tp": 2}, world_size=2, rank=1).tensor_parallel()
    assert (tp.size, tp.rank, tp.leader) == (2, 1, False)
    assert mesh.make_mesh({}, world_size=1).tensor_parallel() is mesh.SINGLE
    m = mesh.make_mesh({"tp": 2, "ep": 2, "sp": 2}, world_size=8, rank=5)
    assert m.tensor_parallel().rank == 1
    assert (m.axis_ranks("tp"), m.axis_ranks("sp"), m.axis_ranks("ep")) \
        == ((4, 5), (5, 7), (1, 5))
    assert m.world().size == 8


# ------------------------------------------------------------ hybrid mesh


# (ici, dcn, ranks a host): the first is not row-major in rank.
HYBRID = [({"dp": 2, "tp": 2}, {"sp": 2}, 4), ({"tp": 4}, {"dp": 2}, 4),
          ({"tp": 2}, {"dp": 2, "sp": 2}, 2), ({"dp": 2}, {"tp": 2}, 2)]


@pytest.mark.parametrize("ici,dcn,local", HYBRID,
                         ids=[str(i) for i in range(len(HYBRID))])
def test_hybrid_mesh_lays_out_ranks_as_jax(ici, dcn, local):
    """The rank layout, every rank's coordinates and its axes' ranks equal
    JAX's hybrid device mesh (device id = rank)."""
    n = local * int(np.prod(list(dcn.values())))
    ids = jax_hybrid_ranks(ici, dcn, local, n)
    for rank in range(n):
        m = mesh.make_hybrid_mesh(ici, dcn, world_size=n, rank=rank,
                                  local_world_size=local)
        assert m.layout == tuple(ids.ravel())
        where = tuple(np.argwhere(ids == rank)[0])
        assert tuple(m.coords().values()) == where
        for axis, name in enumerate(m.axis_names):
            line = list(where)
            line[axis] = slice(None)
            assert m.axis_ranks(name) == tuple(ids[tuple(line)])


def test_hybrid_mesh_degrades_to_flat_local_mesh():
    """tests/test_multihost.py's: no dcn axis is `make_mesh`'s mesh."""
    hybrid = mesh.make_hybrid_mesh({"dp": 4, "tp": 2}, world_size=8)
    flat = mesh.make_mesh({"dp": 4, "tp": 2}, world_size=8)
    assert hybrid == flat and hybrid.layout is None
    assert hybrid.shape == dict(jax_mesh.make_hybrid_mesh(
        {"dp": 4, "tp": 2}).shape)


def test_hybrid_mesh_dcn_axis_merges_in_single_process():
    """tests/test_multihost.py's: dcn dp 1 and ici dp 2 give dp 2."""
    m = mesh.make_hybrid_mesh({"dp": 2, "tp": 2, "sp": 2}, {"dp": 1},
                              world_size=8)
    assert m.shape["dp"] == 2 and m.world_size == 8
    assert m.shape == dict(jax_mesh.make_hybrid_mesh(
        {"dp": 2, "tp": 2, "sp": 2}, {"dp": 1}).shape)


def test_hybrid_mesh_rejects_unknown_axis_and_hosts_that_do_not_fit():
    errors = []
    for make in (jax_mesh.make_hybrid_mesh, mesh.make_hybrid_mesh):
        with pytest.raises(ValueError, match="unknown mesh axes") as err:
            make({"zz": 2})
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="number of hosts 4 must equal"):
        mesh.make_hybrid_mesh({"tp": 2}, {"dp": 2}, world_size=8,
                              local_world_size=2)
    with pytest.raises(ValueError, match="a host's 4 ranks must equal"):
        mesh.make_hybrid_mesh({"tp": 2}, {"dp": 2}, world_size=8,
                              local_world_size=4)


def test_collectives_are_the_identity_at_tp_1():
    x = torch.arange(6.0).reshape(2, 3)
    tp = mesh.SINGLE
    assert tp.all_reduce(x) is x and tp.all_gather(x) is x
    assert tp.broadcast_object({"a": 1}) == {"a": 1}


def test_initialize_multihost_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.initialize_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend"):
        mesh.initialize_multihost()


def test_backends_are_named_never_chosen():
    with pytest.raises(ValueError, match="unknown backend"):
        mesh.init_process_group("mpi", "file:///nonexistent", 1, 0)
    assert mesh.backend_can_capture("nccl")
    assert not mesh.backend_can_capture("gloo")
    assert mesh.backend_can_capture(None)


# ------------------------------------------------------------ partition


def _jax_trees():
    key = jax.random.key(0)
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    gpt2 = jax_gpt2.init_params(key, jax_gpt2.GPT2Config.tiny(**f32))
    llama = jax_llama.init_params(key, jax_llama.LlamaConfig.tiny(**f32))
    bert = jax_bert.init_params(key, jax_bert.BertConfig.tiny(**f32))
    moe = jax_moe.init_params(key, jax_moe.GPT2MoEConfig.tiny(**f32))
    return {
        "gpt2": ("gpt2", gpt2), "gpt2-int8": ("gpt2", jax_quant.
                                               quantize_params(gpt2, "gpt2")),
        "llama": ("llama", llama),
        "llama-int8": ("llama", jax_quant.quantize_params(llama, "llama")),
        "bert": ("bert", bert),
        "bert-int8": ("bert", jax_quant.quantize_params(bert, "bert")),
        "gpt2_moe": ("gpt2_moe", moe),
        "gpt2_moe-int8": ("gpt2_moe",
                          jax_quant.quantize_params(moe, "gpt2_moe")),
    }


TREES = _jax_trees()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("name", sorted(TREES))
def test_match_partition_rules_equals_jax(name):
    family, tree = TREES[name]
    want = jax_partition.match_partition_rules(
        jax_partition.RULES_FOR[family], tree)
    got = partition.match_partition_rules(
        partition.RULES_FOR[family],
        params_from_jax(jax.device_get(tree), device="cpu"))
    assert dict(_flat(got)) == {p: tuple(s) for p, s in _flat(want)}


def test_rule_tables_equal_jax():
    for family, rules in jax_partition.RULES_FOR.items():
        assert [(p, tuple(s)) for p, s in rules] == \
            list(partition.RULES_FOR[family]), family
    assert {k: tuple(v) for k, v in
            jax_partition.PAGED_PLANE_SPECS.items()} == \
        partition.PAGED_PLANE_SPECS


@pytest.mark.parametrize("heads", [1, 2, 4, 12, 20, 25, 8])
def test_supported_tp_and_validate_tp_heads_equal_jax(heads):
    assert partition.supported_tp(heads) == jax_partition.supported_tp(heads)
    for tp in range(1, 10):
        outcome = []
        for module in (jax_partition, partition):
            try:
                module.validate_tp_heads(heads, tp, "m")
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (heads, tp)


# Vocabulary tables at their published row counts (narrow columns: the
# refusal depends on the sharded axis alone).
VOCAB = {
    "gpt2 wte": ("gpt2", {"wte": np.zeros((50257, 8), np.float32)}),
    "llama embed": ("llama", {"embed": np.zeros((128256, 8), np.float32),
                              "lm_head": np.zeros((128256, 8), np.float32)}),
    "bert word": ("bert", {"embeddings": {
        "word": np.zeros((30522, 8), np.float32)}}),
}


def _jax_shards(family, tree, tp):
    m = jax_mesh.make_mesh({"tp": tp, "dp": -1}, devices=jax.devices()[:8])
    try:
        jax_partition.shard_tree(tree, m, jax_partition.RULES_FOR[family])
    except ValueError:
        return False
    return True


def _port_shards(family, tree, tp):
    try:
        for rank in range(tp):
            partition.shard_params(
                params_from_jax(tree, device="cpu"),
                partition.RULES_FOR[family], rank, tp)
    except ValueError as e:
        assert re.search(r"size \d+ does not split over tp=\d+; tp ways "
                         r"that divide it: \[", str(e)), str(e)
        return False
    return True


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(VOCAB))
def test_divisibility_refusals_where_jax_refuses(name, tp):
    """The port refuses a table exactly where the JAX shard_tree raises:
    GPT-2's 50,257 rows at tp 2 and 4, BERT's 30,522 at tp 4; Llama's
    128,256 pass."""
    family, tree = VOCAB[name]
    jax_ok = _jax_shards(family, tree, tp)
    assert _port_shards(family, tree, tp) == jax_ok
    assert jax_ok == {("gpt2 wte", 2): False, ("gpt2 wte", 4): False,
                      ("bert word", 2): True, ("bert word", 4): False,
                      ("llama embed", 2): True,
                      ("llama embed", 4): True}[(name, tp)]


def test_refusal_names_the_leaf_its_size_and_the_divisors():
    with pytest.raises(ValueError) as err:
        partition.shard_params({"wte": torch.zeros(50257, 8)},
                               partition.GPT2_RULES, 0, 2)
    assert str(err.value) == (
        "wte: axis 0 of size 50257 does not split over tp=2; tp ways that "
        "divide it: [1, 29, 1733, 50257]")


@pytest.mark.parametrize("name", ["gpt2", "gpt2-int8", "bert", "bert-int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_fused_qkv_slices_each_rank_its_heads(name, tp):
    """Rank r's wqkv (bqkv, and the int8 pair's q and s) holds the q, k
    and v columns of its heads, in that order: per head within each third,
    never a contiguous block of the fused axis."""
    family, tree = TREES[name]
    host = jax.device_get(tree)
    port = params_from_jax(host, device="cpu")
    d = np.asarray(host["blocks"]["attn"]["bqkv"]).shape[-1] // 3
    per = d // tp
    for rank in range(tp):
        mine = partition.shard_params(port, partition.RULES_FOR[family],
                                      rank, tp)["blocks"]["attn"]
        want_cols = np.concatenate([np.arange(j * d + rank * per,
                                              j * d + (rank + 1) * per)
                                    for j in range(3)])
        for leaf in ("wqkv", "bqkv"):
            got, ref = mine[leaf], host["blocks"]["attn"][leaf]
            pairs = ([(got["q"], ref["q"]), (got["s"], ref["s"])]
                     if isinstance(got, dict) else [(got, ref)])
            for g, r in pairs:
                r = np.asarray(r)
                assert g.is_contiguous()
                np.testing.assert_array_equal(
                    g.numpy(), np.take(r, want_cols, axis=-1))


def test_row_parallel_scales_stay_whole_and_others_shard():
    """int8: a column-parallel leaf's scales split with its columns, a
    row-parallel leaf's scales stay whole (they apply after the sum), an
    embedding's per-row scales split with its rows."""
    _, tree = TREES["llama-int8"]
    port = params_from_jax(jax.device_get(tree), device="cpu")
    mine = partition.shard_params(port, partition.LLAMA_RULES, 1, 2)
    full = port["blocks"]
    assert mine["blocks"]["attn"]["wo"]["s"] is full["attn"]["wo"]["s"]
    assert mine["blocks"]["mlp"]["wd"]["s"] is full["mlp"]["wd"]["s"]
    n = full["mlp"]["wg"]["s"].shape[-1]
    assert torch.equal(mine["blocks"]["mlp"]["wg"]["s"],
                       full["mlp"]["wg"]["s"][:, n // 2:])
    k = full["mlp"]["wd"]["q"].shape[1]
    assert torch.equal(mine["blocks"]["mlp"]["wd"]["q"],
                       full["mlp"]["wd"]["q"][:, k // 2:])
    v = port["embed"]["s"].shape[0]
    assert torch.equal(mine["embed"]["s"], port["embed"]["s"][v // 2:])
    assert partition.shard_params(port, partition.LLAMA_RULES, 0, 1) is port


# ----------------------------------------------- engines without a group


def _config(**kw):
    return EngineConfig(model=kw.pop("model", "tiny"), device="cpu",
                        dtype=torch.float32, param_dtype=torch.float32, **kw)


@pytest.mark.parametrize("engine", [PagedEngine, TutoringEngine])
def test_uneven_head_split_raises_at_construction(engine, monkeypatch):
    """tp must divide the KV heads (the JAX paged engine's check and
    message), before any process group is needed."""
    with pytest.raises(ValueError, match=r"supported tp ways for this "
                       r"model: \[1, 2, 4\]"):
        engine(_config(tp=3))
    with pytest.raises(ValueError, match=r"llama-tiny.*\[1, 2\]"):
        engine(_config(model="llama-tiny", tp=4))


@pytest.mark.parametrize("engine", [PagedEngine, TutoringEngine])
def test_tp_without_a_process_group_raises(engine):
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        engine(_config(tp=2))


class _Owner:
    def __init__(self):
        self.calls = []

    def note(self, *args):
        self.calls.append(args)


def test_replica_records_host_calls_and_refuses_followers():
    """Rank 0 records host calls and defers what other threads call; a
    follower refuses a caller's call (it takes rank 0's)."""
    owner = _Owner()
    leader = spmd.Replica(owner, mesh.TensorParallel(size=2, rank=0))
    with leader.call("note", 1):
        owner.note(1)
    assert leader.defer("note", 2) is True
    assert [(n, a, d) for n, a, d in leader._ops] == [
        ("note", (1,), False), ("note", (2,), True)]
    assert owner.calls == [(1,)]
    follower = spmd.Replica(owner, mesh.TensorParallel(size=2, rank=1))
    with pytest.raises(RuntimeError, match="follower"):
        with follower.call("note", 3):
            pass
    single = spmd.Replica(owner)
    assert single.defer("note", 4) is False
    with single.call("step", collective=True):
        pass
    with pytest.raises(RuntimeError, match="other than 0"):
        single.follow()


@dataclasses.dataclass(frozen=True)
class _Loopback(mesh.TensorParallel):
    """A tp axis of two without a process group: rank 0 records what it
    broadcasts; a follower receives `inbox`'s batches in order. Aborts are
    counted."""

    sent: list = dataclasses.field(default_factory=list)
    inbox: list = dataclasses.field(default_factory=list)
    aborts: list = dataclasses.field(default_factory=list)

    def broadcast_object(self, obj=None):
        if self.leader:
            self.sent.append(obj)
            return obj
        return self.inbox.pop(0)

    def abort(self):
        self.aborts.append(self.rank)


def test_replica_defers_another_threads_calls_while_a_call_runs():
    """Nesting is counted per thread: while rank 0's step runs, another
    thread's defer records its call for the next broadcast (rank 0 applies
    it there, or at stop), and the stepping thread's own just runs."""
    owner = _Owner()
    tp = _Loopback(size=2, rank=0)
    leader = spmd.Replica(owner, tp)
    seen = []
    with leader.call("step", collective=True):
        other = threading.Thread(
            target=lambda: seen.append(leader.defer("note", "other")))
        other.start()
        other.join()
        seen.append(leader.defer("note", "own"))
    assert seen == [True, False] and owner.calls == []
    with leader.call("step", collective=True):
        assert owner.calls == [("other",)]
    assert tp.sent[-1][0] == [("note", ("other",)), ("step", ())]
    assert leader.defer("note", "late") is True
    leader.stop()
    assert tp.sent[-1][0] == [("note", ("late",)), ("stop", ())]
    assert owner.calls == [("other",), ("late",)]


def test_replica_runs_two_threads_calls_one_after_the_other():
    """A call from another thread waits for the call in progress, so the
    two never interleave their collectives."""
    owner = _Owner()
    leader = spmd.Replica(owner, _Loopback(size=2, rank=0))
    order = []

    def submit():
        with leader.call("note", 1):
            order.append("other")

    with leader.call("step", collective=True):
        other = threading.Thread(target=submit)
        other.start()
        time.sleep(0.05)
        order.append("step")
    other.join()
    assert order == ["step", "other"]


def test_replica_fails_the_group_when_a_call_raises():
    """A body that raises on rank 0, or a replayed call that raises on a
    follower, aborts the process group and raises TensorParallelFailure;
    every later call on rank 0 raises it at once."""
    owner = _Owner()
    tp = _Loopback(size=2, rank=0)
    leader = spmd.Replica(owner, tp)
    with pytest.raises(spmd.TensorParallelFailure,
                       match=r"tp rank 0: step\(\) raised ValueError: boom"):
        with leader.call("step", collective=True):
            raise ValueError("boom")
    assert tp.aborts == [0]
    with pytest.raises(spmd.TensorParallelFailure,
                       match="after the tp group failed"):
        with leader.call("note", 1):
            pass
    with pytest.raises(spmd.TensorParallelFailure):
        leader.defer("note", 2)
    leader.stop()  # nothing to release: no broadcast
    assert len(tp.sent) == 1 and tp.aborts == [0]

    class _Broken(_Owner):
        def step(self):
            raise RuntimeError("a fault on this rank")

    broken = _Broken()
    ftp = _Loopback(size=2, rank=1, inbox=[([("note", (1,)), ("step", ())],
                                            0.0)])
    follower = spmd.Replica(broken, ftp)
    with pytest.raises(spmd.TensorParallelFailure,
                       match=r"tp rank 1: step\(\) raised RuntimeError"):
        follower.follow()
    assert broken.calls == [(1,)] and ftp.aborts == [1]

