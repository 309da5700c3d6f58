"""The port package under the lint gate.

`tests/test_lint_clean.py` runs dlrl-lint over its default paths (the JAX
package, `scripts/` and `tests/`); the port package is not among them.
This test runs the same `run_lint` with every rule over
`distributed_lms_raft_llm_tpu_torch/` and expects no finding: the run
`python scripts/lint.py distributed_lms_raft_llm_tpu_torch/` makes. No
rule is disabled for the package: an intended case carries its own
`# lint: disable=<rule>` or sits in a `with intended_transfer():` block,
as in the JAX package. The per-file rules read every port file; the
project rules (call graph, metrics registry, config consistency) build
their model from the default tree and report only inside the paths
asked for, so on a subset run they reach no port file (a limit of the
gate, `analysis/core.py::run_lint`).
"""

from pathlib import Path

import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.analysis import all_rules, run_lint

PORT = Path(__file__).resolve().parent.parent / \
    "distributed_lms_raft_llm_tpu_torch"


def test_port_package_is_lint_clean():
    rules = all_rules()
    assert len(rules) >= 20
    findings = run_lint(paths=[PORT], rules=rules)
    assert not findings, (
        f"{len(findings)} unsuppressed lint finding(s) in the port:\n"
        + "\n".join(f.format() for f in findings))


def test_the_gate_sees_the_port_dispatch_modules():
    """The host-sync rule is scoped by module path suffix, so it applies
    to the port's engine modules too: an unmarked readback there is a
    finding, the same line inside `intended_transfer()` is not."""
    from distributed_lms_raft_llm_tpu.analysis.core import Source
    from distributed_lms_raft_llm_tpu.analysis.rules.host_sync import (
        HostSyncInDispatchRule,
    )

    rule = HostSyncInDispatchRule()
    rel = "distributed_lms_raft_llm_tpu_torch/engine/paged.py"
    assert rule.applies_to(rel)
    bare = "def f(x):\n    return x.tolist()\n"
    marked = ("def f(x):\n    with intended_transfer():\n"
              "        return x.tolist()\n")
    for text, n in ((bare, 1), (marked, 0)):
        src = Source(PORT.parent / rel, root=PORT.parent, text=text)
        assert len(rule.check(src)) == n
