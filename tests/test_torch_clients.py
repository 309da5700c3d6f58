"""The port's LMS clients: the Tkinter client and the terminal client.

- Carried (`torch_carry.py`): `tests/test_gui.py` on the port's `client`
  and `proto` (its fake toolkit drives every screen of the port's
  `client/gui.py`), as `test_port_gui_<case>`.
- The terminal client: the JAX package's `client/cli.py` and the port's,
  each run as `python -m ... --servers ...` with the same piped stdin
  (register, log in, post an assignment PDF, ask the instructor, read the
  grade, log out) against one two-group port LMS in process
  (`torch_lms_harness.GroupedCluster`), one student homed in each group:
  the two outputs are equal line for line, the usernames aside, and the
  posts landed in each student's home group.

`tests/test_client_leader_hint.py` is carried in
`tests/test_torch_lms_cluster.py`.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch_threads  # noqa: F401 (caps torch's threads)
from test_torch_group_router import homed
from torch_carry import carry, carried_cases
from torch_lms_harness import GroupedCluster

from distributed_lms_raft_llm_tpu_torch.utils import pdf

REPO = Path(__file__).resolve().parent.parent

globals().update(carried_cases(
    carry("test_gui", modules=("client", "proto")), "port_gui"))


def _cli(package, servers, stdin):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.client.cli", "--servers",
         ",".join(servers)], input=stdin, capture_output=True, text=True,
        timeout=120, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_cli_journeys_equal_jax_cli_on_a_two_group_lms(tmp_path):
    paper = tmp_path / "hw.pdf"
    paper.write_bytes(pdf.make_pdf("Homework 3: Raft leader election"))
    (g0,), (g1,) = homed(2, 1, prefix="cli").values()
    script = ("1\n{u}\npw\nstudent\n2\n{u}\npw\n3\n" + str(paper)
              + "\n6\nwhen is hw3 due?\n4\nq\nq\n")
    cluster = GroupedCluster(["port"] * 3, tmp_path / "lms").start()
    try:
        servers = list(cluster.addresses.values())
        outputs = {}
        for package, user in (("distributed_lms_raft_llm_tpu", g0),
                              ("distributed_lms_raft_llm_tpu_torch", g1)):
            out = _cli(package, servers, script.format(u=user))
            outputs[package] = out.replace(user, "<user>")
        states = {gid: cluster.converged(gid)[1] for gid in (0, 1)}
    finally:
        cluster.close()
    port = outputs["distributed_lms_raft_llm_tpu_torch"]
    assert port == outputs["distributed_lms_raft_llm_tpu"]
    assert "logged in as <user> (student)" in port and "uploaded" in port
    assert "sent" in port
    assert list(states[0]["assignments"]) == [g0]
    assert list(states[1]["assignments"]) == [g1]
    assert set(states[0]["users"]) == set(states[1]["users"]) == {g0, g1}
