"""The port's LMS state machine and storage against the JAX package's.

- State: one command sequence over every op (the reshard ops FreezeKeys,
  InstallKeys and DropKeys included, and a replayed request id) gives
  equal `LMSState.data`, equal digests and byte-equal snapshot files.
- Snapshots: a file written by either package loads in the other; the same
  damage raises `SnapshotCorruption` in both.
- The WAL: v1 and v2 records written by either package are byte-equal for
  equal records and replay in the other to the same term, vote, log,
  snapshot anchor and membership; the same torn tail is cut in both, the
  same mid-file damage raises `WALCorruption` in both.

All comparisons are exact (bytes and JSON-equal dicts).

Carried: `tests/test_lms_state.py`, `test_storage_integrity.py` and
`test_crashpoints.py` (its soak stays `slow`) run against the port's
modules, as `test_port_<file>_<case>` (`torch_carry.py`).
"""

import os

import pytest
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_carry import carry, carried_cases

from distributed_lms_raft_llm_tpu.lms import persistence as jax_persistence
from distributed_lms_raft_llm_tpu.lms import state as jax_state
from distributed_lms_raft_llm_tpu.raft import messages as jax_messages
from distributed_lms_raft_llm_tpu.raft import storage as jax_storage
from distributed_lms_raft_llm_tpu.utils import pdf as jax_pdf
from distributed_lms_raft_llm_tpu_torch.lms import persistence as port_persistence
from distributed_lms_raft_llm_tpu_torch.lms import state as port_state
from distributed_lms_raft_llm_tpu_torch.raft import messages as port_messages
from distributed_lms_raft_llm_tpu_torch.raft import storage as port_storage
from distributed_lms_raft_llm_tpu_torch.utils import pdf as port_pdf

for _name in ("lms_state", "storage_integrity", "crashpoints"):
    globals().update(carried_cases(carry(f"test_{_name}"), f"port_{_name}"))

PACKAGES = {
    "jax": (jax_state, jax_persistence, jax_storage, jax_messages),
    "port": (port_state, port_persistence, port_storage, port_messages),
}
ACROSS = [("jax", "port"), ("port", "jax")]


def command_sequence():
    """(op, args, request_id) over every applier."""
    hp = jax_state.hash_password("pw", "5a17")
    return [
        ("Register", {"username": "ana", "password_hash": hp, "salt": "5a17",
                      "role": "student"}, "r1"),
        ("Register", {"username": "ana", "password_hash": "x",
                      "role": "instructor"}, "r2"),
        ("Register", {"username": "ina", "password_hash": hp,
                      "role": "instructor"}, "r3"),
        ("Register", {"username": "bo", "password_hash": hp,
                      "role": "student"}, None),
        ("Login", {"username": "ana", "token": "tok-a"}, "r4"),
        ("Login", {"username": "bo", "token": "tok-b"}, None),
        ("PostAssignment", {"student": "ana", "filename": "hw1.pdf",
                            "filepath": "assignments/ana/hw1.pdf",
                            "text": "B-trees: insert and split"}, "r5"),
        ("PostAssignment", {"student": "ana", "filename": "hw1.pdf",
                            "filepath": "assignments/ana/hw1.pdf",
                            "text": "replayed"}, "r5"),
        ("PostCourseMaterial", {"instructor": "ina", "filename": "l1.pdf",
                                "filepath": "materials/l1.pdf"}, "r6"),
        ("AskQuery", {"username": "ana", "query": "what is a split?"}, "r7"),
        ("AskQuery", {"username": "bo", "query": "and a merge?"}, "r8"),
        ("RespondToQuery", {"instructor": "ina", "student": "ana",
                            "response": "half the keys move"}, "r9"),
        ("GradeAssignment", {"student": "ana", "grade": "A"}, "r10"),
        ("SetVal", {"key": "k", "value": "v"}, None),
        ("Noop", {}, None),
        ("FreezeKeys", {"users": ["bo"], "reshard_id": "rs1"}, "r11"),
        ("AskQuery", {"username": "bo", "query": "frozen: dropped"}, "r12"),
        ("InstallKeys", {"payload": {
            "users": ["cy"],
            "assignments": {"cy": [{"filename": "a.pdf",
                                    "filepath": "assignments/cy/a.pdf",
                                    "grade": None, "text": "t"}]},
            "queries": {"cy": [{"query": "q", "answered": False,
                                "response": None}]},
            "course_materials": [{"filename": "m.pdf",
                                  "filepath": "materials/m.pdf",
                                  "instructor": "cy"}],
            "applied_requests": {"old-1": True},
        }}, "r13"),
        ("DropKeys", {"users": ["bo", "bo"], "reshard_id": "rs1"}, "r14"),
        ("Logout", {"token": "tok-b"}, None),
    ]


def _apply_all(state_mod):
    st = state_mod.LMSState()
    for op, args, rid in command_sequence():
        if rid is not None:
            args = dict(args, request_id=rid)
        st.apply(op, args)
    return st


def test_state_over_every_op_matches_jax():
    ref, port = _apply_all(jax_state), _apply_all(port_state)
    assert port.data == ref.data
    assert port.digest() == ref.digest()
    assert port.data["moved"] == {"bo": "rs1"}  # the reshard ops applied
    assert port_state.empty_state() == jax_state.empty_state()
    assert port_state.hash_password("pw", "5a17") \
        == jax_state.hash_password("pw", "5a17")
    with pytest.raises(Exception) as e_ref:
        ref.apply("Unknown", {})
    with pytest.raises(Exception) as e_port:
        port.apply("Unknown", {})
    assert type(e_port.value).__name__ == type(e_ref.value).__name__


@pytest.mark.parametrize("writer,reader", ACROSS)
def test_snapshot_files_are_byte_equal_and_load_across(tmp_path, writer,
                                                       reader):
    paths = {}
    for name, (state_mod, pers, _, _) in PACKAGES.items():
        paths[name] = str(tmp_path / name / "lms_data.json")
        pers.SnapshotStore(paths[name]).save(_apply_all(state_mod), 21)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    state, index = PACKAGES[reader][1].SnapshotStore(paths[writer]).load()
    assert index == 21
    assert state.data == _apply_all(jax_state).data


@pytest.mark.parametrize("damage", ["flip", "truncate", "garbage"])
def test_snapshot_damage_raises_in_both(tmp_path, damage):
    path = str(tmp_path / "lms_data.json")
    jax_persistence.SnapshotStore(path).save(_apply_all(jax_state), 3)
    data = bytearray(open(path, "rb").read())
    if damage == "flip":
        data[len(data) // 2] ^= 0x20
    elif damage == "truncate":
        data = data[: len(data) - 9]
    else:
        data = bytearray(b"lmssnap\x00\xff\xfe")
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    for _, pers, _, _ in PACKAGES.values():
        with pytest.raises(pers.SnapshotCorruption):
            pers.SnapshotStore(path).load()


def _write_wal(storage_mod, messages, path, checksums):
    fs = storage_mod.FileStorage(path, fsync=False, checksums=checksums)
    fs.save_meta(3, 2)
    cmds = [messages.encode_command("SetVal", {"key": f"k{i}", "value": i})
            for i in range(6)]
    fs.append_entries(1, [messages.Entry(1, c) for c in cmds[:4]])
    fs.truncate_from(3)
    fs.append_entries(3, [messages.Entry(3, c) for c in cmds[2:]])
    fs.save_members({1: "127.0.0.1:50051", 2: "127.0.0.1:50052"})
    fs.compact_to(2, 1)
    fs.close()


def _replayed(storage_mod, path):
    fs = storage_mod.FileStorage(path, fsync=False)
    term, vote, log, snap_index, snap_term = fs.load()
    out = (term, vote, [(e.term, e.command) for e in log], snap_index,
           snap_term, fs.members)
    fs.close()
    return out


@pytest.mark.parametrize("checksums", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("writer,reader", ACROSS)
def test_wal_bytes_equal_and_replay_across(tmp_path, checksums, writer,
                                           reader):
    paths = {}
    for name, (_, _, storage_mod, messages) in PACKAGES.items():
        paths[name] = str(tmp_path / name / "raft_wal.jsonl")
        _write_wal(storage_mod, messages, paths[name], checksums)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    got = _replayed(PACKAGES[reader][2], paths[writer])
    assert got == _replayed(jax_storage, paths["jax"])
    assert got[0] == 3 and got[3] == 2 and len(got[2]) == 4
    rec = {"t": "meta", "term": 1, "vote": None}
    assert port_storage.frame_record(rec) == jax_storage.frame_record(rec)


@pytest.mark.parametrize("checksums", [True, False], ids=["v2", "v1"])
def test_torn_tail_is_cut_alike(tmp_path, checksums):
    base = str(tmp_path / "w" / "raft_wal.jsonl")
    _write_wal(jax_storage, jax_messages, base, checksums)
    with open(base, "ab") as fh:
        fh.write(b'{"t": "append", "index": 9, "ter')  # crash mid-append
    replays = {}
    for name, (_, _, storage_mod, _) in PACKAGES.items():
        path = str(tmp_path / name / "raft_wal.jsonl")
        os.makedirs(os.path.dirname(path))
        with open(base, "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        replays[name] = _replayed(storage_mod, path)
        with open(path, "rb") as fh:
            replays[name + "_bytes"] = fh.read()
    assert replays["port"] == replays["jax"]
    assert replays["port_bytes"] == replays["jax_bytes"]


def test_midfile_corruption_raises_in_both(tmp_path):
    path = str(tmp_path / "raft_wal.jsonl")
    _write_wal(jax_storage, jax_messages, path, True)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 3] ^= 0x01
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    for _, _, storage_mod, _ in PACKAGES.values():
        with pytest.raises(storage_mod.WALCorruption):
            storage_mod.FileStorage(path, fsync=False)


def test_pdf_round_trip_matches_jax():
    text = "Homework 2: B-trees (insert, split)\nand a \\ backslash"
    made = port_pdf.make_pdf(text)
    assert made == jax_pdf.make_pdf(text)
    assert port_pdf.extract_text(made) == jax_pdf.extract_text(made)
