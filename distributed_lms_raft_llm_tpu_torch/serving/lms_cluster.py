"""A local LMS cluster started from a deployment file, one process a node.

What an operator does by hand on one machine, as a library: write a copy
of a deployment file (configs/cluster.toml) with a few values changed
(`deployment_copy`: the data directory, free ports, the tutoring node's
address; each change is returned so it can be printed), start each LMS
node as its own process through the port's entry point

    python -m distributed_lms_raft_llm_tpu_torch.serving.lms_server \\
        --config <copy> --id N --metrics-port P [--device cuda|cpu]

(`LMSProcess`, its output kept in a log file), and read the nodes' health
and metrics planes (`http_json`) and their `WhoIsLeader` (`who_is_leader`).
Nothing here imports torch; the nodes do, for their relevance gate.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import load_config

REMOVE = object()  # a `deployment_copy` change that deletes the key
MODULE = "distributed_lms_raft_llm_tpu_torch.serving.lms_server"
PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent


def free_ports(n: int) -> List[int]:
    """`n` distinct ports of 127.0.0.1 that were free when probed."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_toml_value(v) for v in value) + "]"
    raise TypeError(f"no TOML form for {value!r}")


def _set_key(lines: List[str], section: str, key: str, value: Any) -> None:
    """Set (or with REMOVE delete) `key` in `[section]` of a TOML file's
    lines, keeping the line's trailing comment. The key must be there."""
    header = re.compile(r"^\s*\[([^\[\]]+)\]\s*(#.*)?$")
    start = end = None
    for i, line in enumerate(lines):
        m = header.match(line)
        if m:
            if start is not None and end is None:
                end = i
            if m.group(1).strip() == section:
                start = i
    if start is not None and end is None:
        end = len(lines)
    if start is None:
        raise KeyError(f"no [{section}] in the file")
    pattern = re.compile(rf"^(\s*){re.escape(key)}\s*=\s*(.*)$")
    for i in range(start + 1, end):
        m = pattern.match(lines[i])
        if not m:
            continue
        if value is REMOVE:
            del lines[i]
            return
        comment = ""
        rest = m.group(2)
        cut = _comment_start(rest)
        if cut is not None:
            comment = "  " + rest[cut:].strip()
        lines[i] = f"{m.group(1)}{key} = {_toml_value(value)}{comment}"
        return
    raise KeyError(f"no {key} in [{section}]")


def _comment_start(text: str) -> Optional[int]:
    """Index of the `#` that opens a trailing comment (outside strings)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == "\\" and quote == '"':
                continue
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return i
    return None


def deployment_copy(source: str, directory: str,
                    changes: Dict[Tuple[str, str], Any],
                    name: str = "cluster.toml") -> Tuple[str, List[str]]:
    """Write `source` to `directory/name` with `changes` ((section, key) ->
    value, or REMOVE) applied line by line, everything else as it is.
    Returns (the copy's path, one line per change). The copy must load
    (`config.load_config`), or this raises."""
    lines = Path(source).read_text(encoding="utf-8").splitlines()
    applied = []
    for (section, key), value in changes.items():
        _set_key(lines, section, key, value)
        applied.append(f"[{section}] {key} "
                       + ("removed" if value is REMOVE
                          else f"= {_toml_value(value)}"))
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
    load_config(path)
    return path, applied


class LMSProcess:
    """One LMS node as a child process of this one, started from the
    deployment file with `--config <file> --id N`; its standard output and
    error go to `log_path`."""

    def __init__(self, config_path: str, node_id: int, *,
                 metrics_port: int, log_dir: str, device: str = "cuda"):
        self.config_path, self.node_id = config_path, node_id
        self.metrics_port, self.device = metrics_port, device
        self.log_dir = log_dir
        self.env = dict(os.environ)
        path = str(PACKAGE_ROOT)
        old = self.env.get("PYTHONPATH")
        self.env["PYTHONPATH"] = path if not old else f"{path}:{old}"
        self.proc: Optional[subprocess.Popen] = None
        self.starts = 0
        self.log_path = ""

    @property
    def argv(self) -> List[str]:
        return [sys.executable, "-m", MODULE, "--config", self.config_path,
                "--id", str(self.node_id), "--metrics-port",
                str(self.metrics_port), "--device", self.device]

    def start(self) -> "LMSProcess":
        self.starts += 1
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_path = os.path.join(
            self.log_dir, f"lms_node{self.node_id}.{self.starts}.log")
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                self.argv, stdout=log, stderr=subprocess.STDOUT,
                cwd=str(PACKAGE_ROOT), env=self.env)
        return self

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL, as a crash: no shutdown path runs."""
        if self.alive:
            self.proc.send_signal(signal.SIGKILL)
        if self.proc is not None:
            self.proc.wait(30)

    def stop(self, timeout: float = 15.0) -> None:
        """SIGTERM, then SIGKILL if it has not exited within `timeout`."""
        if not self.alive:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill()

    def tail(self, n: int = 20) -> str:
        try:
            lines = Path(self.log_path).read_text(
                encoding="utf-8", errors="replace").splitlines()
        except OSError:
            return ""
        return "\n".join(lines[-n:])


def http_json(port: int, path: str,
              timeout: float = 5.0) -> Tuple[int, Any]:
    """(status, JSON) of a GET to a node's health and admin plane on
    127.0.0.1."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def health(port: int, timeout: float = 2.0) -> Optional[dict]:
    """A node's /healthz document, or None while it does not answer."""
    try:
        code, doc = http_json(port, "/healthz", timeout=timeout)
    except (OSError, ValueError):
        return None
    return doc if code == 200 else None


def who_is_leader(address: str, timeout: float = 2.0) -> Optional[int]:
    """The leader id an LMS node names through `LMS.WhoIsLeader` (None
    while it names none or does not answer)."""
    import grpc

    from ..proto import lms_pb2, rpc

    try:
        with grpc.insecure_channel(address) as channel:
            resp = rpc.LMSStub(channel).WhoIsLeader(lms_pb2.Empty(),
                                                    timeout=timeout)
    except grpc.RpcError:
        return None
    return resp.leader_id if resp.leader_id > 0 else None


def wait_for(predicate, timeout: float, interval: float = 0.05,
             alive: Sequence[LMSProcess] = ()) -> Tuple[Any, float]:
    """Poll `predicate` until it returns a true value; (value, seconds).
    Raises TimeoutError after `timeout`, or RuntimeError as soon as one of
    `alive` has exited."""
    t0 = time.monotonic()
    while True:
        for p in alive:
            if not p.alive:
                raise RuntimeError(
                    f"LMS node {p.node_id} exited with code "
                    f"{p.proc.returncode if p.proc else None}:\n{p.tail()}")
        value = predicate()
        if value:
            return value, time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"not within {timeout} s")
        time.sleep(interval)
