"""Generated blocks between begin/end markers in a text file (README.md,
engine/program_inventory.py), shared by the generators' --check/--write."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

REPO = Path(__file__).resolve().parents[2]
README = REPO / "README.md"


def current(text: str, begin: str, end: str) -> Optional[str]:
    """The block from `begin` through `end`, or None without both."""
    start = text.find(begin)
    stop = text.find(end)
    if start == -1 or stop == -1 or stop < start:
        return None
    return text[start: stop + len(end)]


def sync(blocks: Dict[Path, Tuple[str, str, str]], check: bool,
         command: str) -> int:
    """Compare (check) or rewrite each file's (begin, end, rendered)
    block; returns the exit code. A file without its markers fails."""
    stale = []
    for path, (begin, end, block) in blocks.items():
        text = path.read_text()
        existing = current(text, begin, end)
        if existing is None:
            print(f"{path.name} has no {begin} / {end} markers",
                  file=sys.stderr)
            return 1
        if existing != block:
            stale.append(path)
            if not check:
                path.write_text(text.replace(existing, block))
    names = ", ".join(p.relative_to(REPO).as_posix() for p in stale)
    if check and stale:
        print(f"generated blocks drifted in: {names}; run `{command} "
              f"--write`", file=sys.stderr)
        return 1
    print(f"rewrote: {names}" if stale else "generated blocks up to date")
    return 0
