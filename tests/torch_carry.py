"""Carries a JAX-package test module onto the port's framework-free modules.

The port's host side (`raft/`, `lms/`, the resilience and fault utils) is
a copy of the JAX package's, so the JAX package's own tests of that code
are the port's tests too. `carry(name)` reads `tests/<name>.py`, points
its imports of the JAX package's modules at the port's (all of them, or
only those under the prefixes in `modules`), and executes the result as a
module of its own (`<name>_port`); the test files unchanged on disk.
`carried_cases(module, prefix)` returns its test functions and fixtures under
prefixed names, for a `tests/test_torch_*.py` file to put in its globals,
where pytest collects them as the port's cases.
"""

import pathlib
import re
import sys
import types
from typing import Dict, Iterable, Optional

TESTS = pathlib.Path(__file__).resolve().parent
REFERENCE = "distributed_lms_raft_llm_tpu"
PORT = "distributed_lms_raft_llm_tpu_torch"


def _retarget(source: str, modules: Optional[Iterable[str]]) -> str:
    prefixes = None if modules is None else tuple(modules)

    def sub(match: "re.Match[str]") -> str:
        mod = match.group(1)
        if prefixes is None or any(
                mod == p or mod.startswith(p + ".") for p in prefixes):
            return f"{PORT}.{mod}"
        return match.group(0)

    return re.sub(rf"\b{REFERENCE}\.([A-Za-z_][\w.]*)", sub, source)


def carry(name: str, *, modules: Optional[Iterable[str]] = None,
          helpers: Iterable[str] = ()) -> types.ModuleType:
    """`tests/<name>.py` run against the port; `helpers` are the test
    modules it imports from (`from test_raft_cluster import ...`), carried
    the same way and imported as their `_port` copies."""
    key = f"{name}_port"
    if key in sys.modules:
        return sys.modules[key]
    path = TESTS / f"{name}.py"
    source = _retarget(path.read_text(encoding="utf-8"), modules)
    for helper in helpers:
        carry(helper, modules=modules)
        source = re.sub(rf"\bfrom {helper} import", f"from {helper}_port import",
                        source)
    module = types.ModuleType(key)
    module.__file__ = str(path)
    sys.modules[key] = module
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


def carried_cases(module: types.ModuleType, prefix: str,
             skip: Iterable[str] = ()) -> Dict[str, object]:
    """The module's `test_*` functions as `test_<prefix>_<name>`, and its
    fixtures under their own names."""
    skip = set(skip)
    out: Dict[str, object] = {}
    for attr, obj in vars(module).items():
        if attr in skip or not callable(obj):
            continue
        if attr.startswith("test_"):
            out[f"test_{prefix}_{attr[len('test_'):]}"] = obj
        elif hasattr(obj, "_pytestfixturefunction") or (
                type(obj).__name__ == "FixtureFunctionDefinition"):
            out[attr] = obj
    return out
