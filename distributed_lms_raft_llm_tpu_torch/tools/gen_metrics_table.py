"""Render the README's port metrics table from `utils/metrics_registry.py`.

    python -m distributed_lms_raft_llm_tpu_torch.tools.gen_metrics_table
    ... --check    # exit 1 if the README block drifted
    ... --write    # rewrite the README block

The table lives between the `<!-- torch-metrics-table:begin -->` and
`<!-- torch-metrics-table:end -->` markers in README.md.
"""

from __future__ import annotations

import argparse
import sys

from ..utils import metrics_registry
from .blocks import README, sync

BEGIN = "<!-- torch-metrics-table:begin -->"
END = "<!-- torch-metrics-table:end -->"
COMMAND = "python -m distributed_lms_raft_llm_tpu_torch.tools.gen_metrics_table"


def rendered_block() -> str:
    return f"{BEGIN}\n{metrics_registry.render_markdown_table()}\n{END}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render the README's port metrics table.")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="exit 1 when README's table differs from the "
                           "registry")
    mode.add_argument("--write", action="store_true",
                      help="rewrite README's table block in place")
    args = parser.parse_args(argv)
    block = rendered_block()
    if not (args.check or args.write):
        print(block)
        return 0
    return sync({README: (BEGIN, END, block)}, check=args.check,
                command=COMMAND)


if __name__ == "__main__":
    sys.exit(main())
