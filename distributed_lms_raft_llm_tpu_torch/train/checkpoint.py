"""Training checkpoint save/restore (safetensors + sidecar metadata).

Port of `distributed_lms_raft_llm_tpu/train/checkpoint.py`, writing the
reference's file layout: one `.safetensors` holding every state leaf
under its tree path (`params/blocks/attn/wqkv`, `opt_state/1/0/mu/...`,
`step`), in JAX's flattening order (dict keys sorted, a named tuple's
fields and a tuple's items in order), plus `<path>.json` with the step and
the sorted leaf names. For equal leaves the files are byte-equal to the
JAX package's, so a checkpoint of either package resumes in the other.

`export_model()` writes the params alone in HF layout, so a fine-tuned
model serves through the standard checkpoint path
(`TutoringEngine(checkpoint=...)`, the node's `--checkpoint`).

A sharded train state (`train.train.train_state_shardings`) is saved and
exported whole: every rank's slice of each leaf is gathered
(`parallel.partition.gather_leaf`; every rank of the mesh calls), rank 0
writes one file with the unsharded layout, JAX's keys, shapes and dtypes,
and every rank waits for it. `restore_train_state` reads the whole file on
every rank and keeps the rank's slice, so a run saved at one layout
resumes at another (the JAX package's `restore_train_state(...,
shardings=)`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import convert


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """A node's (key, child) pairs in JAX's flattening order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(slash-joined path, leaf) of every leaf, in JAX's order: the names
    `jax.tree_util.tree_flatten_with_path` gives the reference's state."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """The tree rebuilt with `fn(path, leaf)` at every leaf."""
    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_paths(fn, v, sub(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _gathered(tree: Any, mesh: Any, prefix: str = "") -> Any:
    """`tree` (a rank's slice of the train state, or of its params under
    `prefix` "params/") with each leaf gathered whole over the mesh
    (`parallel.partition.gather_leaf`, by the leaf's partition spec): a
    collective, every rank calls and gets the whole tree."""
    from ..parallel import partition
    from .train import model_axes, state_spec

    params = tree if prefix else tree["params"]
    spec = state_spec(mesh, "moe" in params.get("blocks", {}))
    axes = model_axes(mesh)
    with torch.no_grad():
        return map_with_paths(
            lambda key, leaf: partition.gather_leaf(
                key, leaf, spec(prefix + key, leaf), axes), tree)


def _flatten(state: Any, mesh: Any = None) -> Dict[str, Any]:
    """Every leaf on the host by its path; over a mesh of several ranks
    gathered whole first (every rank calls), an empty dict on every rank
    but 0."""
    if mesh is not None and mesh.world_size > 1:
        state = _gathered(state, mesh)
        if mesh.rank != 0:
            return {}
    return {key: convert.to_host(leaf)
            for key, leaf in flatten_with_paths(state)}


def _written(mesh: Any) -> None:
    """Every rank of a mesh of several waits here until rank 0 has
    written."""
    if mesh is not None and mesh.world_size > 1:
        from torch import distributed as dist

        dist.barrier(group=mesh.group)


def save_train_state(path: str, state: Any, mesh: Any = None) -> None:
    """Write the whole train state to `path` (.safetensors) + `path`.json.
    Over a `mesh` of several ranks: every rank calls, rank 0 writes the
    gathered state."""
    flat = _flatten(state, mesh)
    if mesh is not None and mesh.rank != 0:
        _written(mesh)
        return
    convert.save_safetensors(path, flat)
    meta = {
        "step": int(state["step"]),
        "leaves": sorted(flat),
    }
    tmp = path + ".json.tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path + ".json")
    _written(mesh)


def restore_train_state(path: str, template: Any, mesh: Any = None) -> Any:
    """Load a checkpoint back into `template`'s structure.

    `template` is a freshly built train state (`init_train_state`): it
    gives the tree, each leaf's expected shape, dtype and device, and
    whether it requires grad (the params do). Over a `mesh` of several
    ranks the template is this rank's slice, and each whole leaf of the
    file is cut to it (`parallel.partition.slice_leaf`). A missing leaf or
    a shape that differs raises.
    """
    tensors = convert.load_safetensors(path)
    cut = None
    if mesh is not None and mesh.world_size > 1:
        from ..parallel import partition
        from .train import state_spec

        spec = state_spec(mesh, "moe" in template["params"].get("blocks", {}))
        coords, sizes = mesh.coords(), mesh.shape

        def cut(key, value):
            value = torch.as_tensor(value)
            return partition.slice_leaf(key, value, spec(key, value), coords,
                                        sizes)

    def restore(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if key not in tensors:
            raise ValueError(f"checkpoint {path} missing leaf {key!r}")
        value = tensors[key]
        if cut is not None:
            value = cut(key, value)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {value.shape}, "
                f"expected {tuple(leaf.shape)}"
            )
        out = convert.to_tensor(value, leaf.dtype, leaf.device)
        return out.requires_grad_(leaf.requires_grad)

    return map_with_paths(restore, template)


def export_model(path: str, state: Any, mesh: Any = None) -> None:
    """Write just the fine-tuned parameters in HF GPT-2 layout (the inverse
    of the import mapping), so `TutoringEngine(checkpoint=path)` serves the
    fine-tuned model through the standard checkpoint path. MoE params have
    no HF counterpart layout; they export in the native tree layout
    (slash-joined paths), which `models.moe.params_from_hf` reads back.
    Over a `mesh` of several ranks: every rank calls, rank 0 writes the
    gathered params."""
    params = state["params"]
    if mesh is None or mesh.world_size == 1:
        _export(path, params)
        return
    params = _gathered(params, mesh, prefix="params/")
    if mesh.rank == 0:
        _export(path, params)
    _written(mesh)


def _export(path: str, params: Any) -> None:
    if "moe" in params.get("blocks", {}):
        convert.save_safetensors(path, _flatten(params))
        return
    convert.save_safetensors(path, convert.gpt2_params_to_hf(params))


def latest_step(path: str) -> Optional[int]:
    """Step recorded in `path`'s sidecar, or None if no checkpoint."""
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as fh:
        return int(json.load(fh)["step"])

