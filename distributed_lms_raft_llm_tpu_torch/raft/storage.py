"""Durable Raft state: current_term, voted_for, the log, and its snapshot base.

The port's copy of `distributed_lms_raft_llm_tpu/raft/storage.py`,
its logic as it is.

The reference keeps all Raft state in process memory — a restarted node
rejoins at term 0 with an empty log, violating Raft's durability assumptions
(SURVEY.md §5 checkpoint/resume). Here every meta/log mutation is appended
to a write-ahead file before the core sends any message that depends on it;
recovery replays the file.

The log is compactable (Raft §7): once the application has snapshotted its
state at index S, the WAL prefix 1..S is dropped and replaced by a `snap`
record carrying (S, term-at-S). Entry indices are ABSOLUTE throughout — the
in-memory list holds entries S+1..last, and `snapshot_index` anchors the
offset. The reference kept every entry forever (it persisted nothing).

Record payloads (JSON):
    {"t": "meta", "term": N, "voted_for": id|null}
    {"t": "entry", "i": index, "term": N, "cmd": "..."}
    {"t": "trunc", "i": index}          # delete entries >= index
    {"t": "snap", "i": index, "term": N}  # prefix <= index now snapshot-covered
    {"t": "members", "m": {"id": "addr", ...}}  # base membership (see
        RaftCore: membership entries compacted out of the log fold here)

On-disk framing (WAL format v2): each payload rides one line as

    <crc32-of-payload:08x> <payload-byte-length> <payload-json>\\n

so recovery can tell a *torn tail* (the final record truncated by a crash
mid-append: drop it and continue, exactly what Raft's durability contract
allows) from *mid-file corruption* (bit rot, a short write that later
appends merged into — committed state is damaged: raise `WALCorruption`
and let the node rejoin from the leader instead of silently truncating
the acked suffix, which is what the pre-v2 replay did). Legacy v1 lines
(bare JSON, no framing) still load — one clean boot migrates them: the
next compaction rewrites every surviving record framed.

Compaction rewrites the file from live state (snap record + surviving
suffix) when it grows past a bound or when `compact_to` is called — via
temp file + fsync + rename + parent-dir fsync, each step routed through
the `utils.diskfaults.FileSystem` seam so crash-point tests can interpose.
`MemoryStorage` backs deterministic tests and simulated restarts.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional, Sequence, Tuple

from ..utils import metrics_registry as metric
from ..utils.diskfaults import REAL_FS, FileSystem
from .messages import Entry

# (term, voted_for, entries, snapshot_index, snapshot_term)
LoadResult = Tuple[int, Optional[int], List[Entry], int, int]

# Temp-file prefix for atomic WAL rewrites; boot sweeps strays.
TMP_PREFIX = ".raftwal."


class WALCorruption(Exception):
    """Mid-file WAL damage (not a torn tail): a record before the end of
    the file fails its CRC/length/JSON checks. The committed log suffix
    after it cannot be trusted, so the storage layer refuses to serve —
    the node must be restored or discard local state and rejoin via
    InstallSnapshot (lms.node recovery='rejoin')."""

    def __init__(self, path: str, offset: int, reason: str):
        super().__init__(
            f"WAL {path} corrupt at byte {offset}: {reason} — refusing to "
            f"silently truncate committed state; restore the file or let "
            f"the node rejoin from the leader"
        )
        self.path = path
        self.offset = offset
        self.reason = reason


class MemoryStorage:
    """In-memory storage; survives simulated 'restarts' of a RaftCore by
    being handed to the next incarnation."""

    def __init__(self):
        self.term = 0
        self.voted_for: Optional[int] = None
        self.entries: List[Entry] = []
        self.snapshot_index = 0
        self.snapshot_term = 0
        # Membership as of snapshot_index (id -> address); None = the core
        # falls back to its boot-time peer list. See RaftCore membership.
        self.members = None

    def save_members(self, members) -> None:
        self.members = dict(members)

    def load(self) -> LoadResult:
        return (self.term, self.voted_for, list(self.entries),
                self.snapshot_index, self.snapshot_term)

    def save_meta(self, term: int, voted_for: Optional[int]) -> None:
        self.term = term
        self.voted_for = voted_for

    def append_entries(self, first_index: int, entries: Sequence[Entry]) -> None:
        expected = self.snapshot_index + len(self.entries) + 1
        assert first_index == expected, (first_index, expected)
        self.entries.extend(entries)

    def truncate_from(self, index: int) -> None:
        del self.entries[index - self.snapshot_index - 1:]

    def compact_to(self, index: int, term: int) -> None:
        """Drop entries <= index (now covered by the app snapshot)."""
        if index <= self.snapshot_index:
            return
        del self.entries[: index - self.snapshot_index]
        self.snapshot_index = index
        self.snapshot_term = term

    def install_snapshot(self, index: int, term: int,
                         remaining: Sequence[Entry]) -> None:
        """Follower side: replace the whole log with snapshot base + suffix."""
        self.snapshot_index = index
        self.snapshot_term = term
        self.entries = list(remaining)


def frame_record(rec: dict) -> str:
    """One v2 WAL line: crc32 + byte length + payload."""
    payload = json.dumps(rec)
    raw = payload.encode("utf-8")
    return f"{zlib.crc32(raw) & 0xFFFFFFFF:08x} {len(raw)} {payload}\n"


def _parse_line(line: bytes) -> Tuple[dict, bool]:
    """(record, was_legacy). Raises ValueError with a reason on any
    framing/CRC/JSON failure — the caller classifies torn-tail vs corrupt
    by position."""
    if line.startswith(b"{"):
        # Legacy v1: bare JSON, no integrity check available.
        try:
            return json.loads(line.decode("utf-8")), True
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"legacy record unparsable: {e}") from e
    head = line.split(b" ", 2)
    if len(head) != 3 or len(head[0]) != 8:
        raise ValueError("unrecognized record framing")
    crc_hex, length_s, payload = head
    try:
        want_crc = int(crc_hex, 16)
        want_len = int(length_s)
    except ValueError as e:
        raise ValueError(f"bad frame header: {e}") from e
    if len(payload) < want_len:
        raise ValueError(
            f"payload truncated: {len(payload)} of {want_len} bytes"
        )
    if len(payload) > want_len:
        raise ValueError(
            f"payload overrun: {len(payload)} bytes vs declared {want_len}"
        )
    got_crc = zlib.crc32(payload) & 0xFFFFFFFF
    if got_crc != want_crc:
        raise ValueError(
            f"CRC mismatch: stored {want_crc:08x}, computed {got_crc:08x}"
        )
    try:
        return json.loads(payload.decode("utf-8")), False
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"checksummed payload unparsable: {e}") from e


class FileStorage:
    """Checksummed WAL with snapshot-aware compaction (format v2)."""

    def __init__(self, path: str, *, fsync: bool = True,
                 compact_every_bytes: int = 4 * 1024 * 1024,
                 checksums: bool = True,
                 fs: Optional[FileSystem] = None,
                 metrics=None):
        self.path = path
        self.fsync = fsync
        self.checksums = checksums
        self.compact_every_bytes = compact_every_bytes
        self.fs = fs or REAL_FS
        self._metrics = metrics
        self._term = 0
        self._voted_for: Optional[int] = None
        self._entries: List[Entry] = []
        self._snapshot_index = 0
        self._snapshot_term = 0
        self._members = None
        # Diagnostics for the migration path: v1 records seen at replay.
        self.legacy_records = 0
        self._dir = os.path.dirname(os.path.abspath(path))
        self.fs.makedirs(self._dir)
        self._sweep_stale_tmps()
        existed = self.fs.exists(self.path)
        self._replay()
        self._fh = self.fs.open(self.path, "a", encoding="utf-8")
        if not existed:
            # The WAL's own directory entry must survive a crash, or the
            # first acked append vanishes with the whole file.
            self.fs.fsync_dir(self._dir)
        self._good_offset = self.fs.getsize(self.path)

    # ------------------------------------------------------------- boot

    def _sweep_stale_tmps(self) -> None:
        """A crash between mkstemp and rename leaks the temp file forever;
        collect strays from prior incarnations."""
        removed = 0
        if self.fs.isdir(self._dir):
            for name in self.fs.listdir(self._dir):
                if name.startswith(TMP_PREFIX):
                    self.fs.remove(os.path.join(self._dir, name))
                    removed += 1
        if removed and self._metrics is not None:
            self._metrics.inc(metric.STALE_TMP_FILES_REMOVED, removed)

    # -------------------------------------------------------------- replay

    def _replay(self) -> None:
        if not self.fs.exists(self.path):
            return
        data = self.fs.read_bytes(self.path)
        offset = 0
        while True:
            nl = data.find(b"\n", offset)
            if nl == -1:
                break  # unterminated remainder = torn tail, handled below
            line = data[offset:nl]
            if line:
                try:
                    rec, legacy = _parse_line(line)
                except ValueError as e:
                    # A damaged record WITH its newline intact is not a
                    # torn write (a crash truncates the byte stream; it
                    # does not rewrite bytes mid-line): committed state
                    # is corrupt, whether mid-file or at the tail.
                    if self._metrics is not None:
                        self._metrics.inc(metric.WAL_CORRUPT_RECORDS)
                    raise WALCorruption(self.path, offset, str(e)) from e
                if legacy:
                    self.legacy_records += 1
                self._apply_record(rec)
            offset = nl + 1
        # Drop any torn tail so the next append starts on a clean line —
        # otherwise the new record merges into the partial one and the
        # *following* replay would refuse the merged garbage as corrupt.
        # An unterminated final record is NEVER applied, even when its
        # frame happens to parse (a torn write missing only its newline):
        # it is about to be truncated, and applying it would put memory
        # ahead of disk and skew every later index.
        if offset < len(data):
            if self._metrics is not None:
                self._metrics.inc(metric.WAL_TORN_TAIL_TRUNCATIONS)
            self.fs.truncate(self.path, offset)

    def _apply_record(self, rec: dict) -> None:
        kind = rec.get("t")
        if kind == "meta":
            self._term = rec["term"]
            self._voted_for = rec["voted_for"]
        elif kind == "entry":
            idx = rec["i"]
            if idx == self._snapshot_index + len(self._entries) + 1:
                self._entries.append(
                    Entry(term=rec["term"], command=rec["cmd"])
                )
        elif kind == "trunc":
            del self._entries[rec["i"] - self._snapshot_index - 1:]
        elif kind == "snap":
            idx = rec["i"]
            if idx > self._snapshot_index:
                drop = min(idx - self._snapshot_index, len(self._entries))
                del self._entries[:drop]
                self._snapshot_index = idx
                self._snapshot_term = rec["term"]
        elif kind == "members":
            self._members = {int(k): v for k, v in rec["m"].items()}

    # ----------------------------------------------------------------- api

    def load(self) -> LoadResult:
        return (self._term, self._voted_for, list(self._entries),
                self._snapshot_index, self._snapshot_term)

    def _format(self, rec: dict) -> str:
        if self.checksums:
            return frame_record(rec)
        return json.dumps(rec) + "\n"  # legacy v1 (rollback escape hatch)

    def _write(self, rec: dict) -> None:
        line = self._format(rec)
        try:
            self.fs.write(self._fh, line)
            if self.fsync:
                self.fs.fsync(self._fh)
            else:
                self._fh.flush()
        except OSError:
            # A short write (ENOSPC) leaves a partial record on disk; the
            # NEXT append would merge into it and replay would then refuse
            # the merged garbage as mid-file corruption. Roll the file back
            # to the last good record boundary and surface the error.
            self._repair_tail()
            raise
        self._good_offset += len(line.encode("utf-8"))

    def _maybe_compact(self) -> None:
        """Size-triggered compaction. Called by the public mutators AFTER
        their in-memory update — _compact rewrites from memory, so firing
        inside _write would drop the record being written."""
        if self._good_offset > self.compact_every_bytes:
            self._compact()

    def _repair_tail(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover - close after failed write
            pass
        self.fs.truncate(self.path, self._good_offset)
        self._fh = self.fs.open(self.path, "a", encoding="utf-8")

    @property
    def members(self):
        return None if self._members is None else dict(self._members)

    def save_members(self, members) -> None:
        members = {int(k): v for k, v in dict(members).items()}
        self._write({
            "t": "members",
            "m": {str(k): v for k, v in members.items()},
        })
        self._members = members
        self._maybe_compact()

    def save_meta(self, term: int, voted_for: Optional[int]) -> None:
        # Disk first, memory second: a failed write must not leave the
        # in-memory view ahead of durable state (the pre-v2 ordering did).
        self._write({"t": "meta", "term": term, "voted_for": voted_for})
        self._term = term
        self._voted_for = voted_for
        self._maybe_compact()

    def append_entries(self, first_index: int, entries: Sequence[Entry]) -> None:
        for i, e in enumerate(entries):
            idx = first_index + i
            assert idx == self._snapshot_index + len(self._entries) + 1
            self._write({"t": "entry", "i": idx, "term": e.term,
                         "cmd": e.command})
            self._entries.append(e)
        self._maybe_compact()

    def truncate_from(self, index: int) -> None:
        self._write({"t": "trunc", "i": index})
        del self._entries[index - self._snapshot_index - 1:]
        self._maybe_compact()

    def compact_to(self, index: int, term: int) -> None:
        """Drop the WAL prefix <= index (the app snapshot now covers it) and
        rewrite the file so the disk footprint actually shrinks."""
        if index <= self._snapshot_index:
            return
        del self._entries[: index - self._snapshot_index]
        self._snapshot_index = index
        self._snapshot_term = term
        self._compact()

    def install_snapshot(self, index: int, term: int,
                         remaining: Sequence[Entry]) -> None:
        self._snapshot_index = index
        self._snapshot_term = term
        self._entries = list(remaining)
        self._compact()

    def _compact(self) -> None:
        """Rewrite the WAL as meta + snap + live entries, atomically:
        tmp write -> fsync -> rename -> parent-dir fsync (the rename is
        only durable once the directory entry is)."""
        f, tmp = self.fs.create_temp(self._dir, TMP_PREFIX, text=True)
        try:
            with f:
                self.fs.write(f, self._format(
                    {"t": "meta", "term": self._term,
                     "voted_for": self._voted_for}
                ))
                if self._members is not None:
                    self.fs.write(f, self._format({
                        "t": "members",
                        "m": {str(k): v for k, v in self._members.items()},
                    }))
                if self._snapshot_index:
                    self.fs.write(f, self._format(
                        {"t": "snap", "i": self._snapshot_index,
                         "term": self._snapshot_term}
                    ))
                for i, e in enumerate(self._entries,
                                      start=self._snapshot_index + 1):
                    self.fs.write(f, self._format(
                        {"t": "entry", "i": i, "term": e.term,
                         "cmd": e.command}
                    ))
                self.fs.fsync(f)
        except OSError:
            # Failed rewrite: the live WAL is untouched; drop the partial
            # temp and keep appending to the old file.
            if self.fs.exists(tmp):
                self.fs.remove(tmp)
            raise
        self.fs.replace(tmp, self.path)
        self.fs.fsync_dir(self._dir)
        self._fh.close()
        self._fh = self.fs.open(self.path, "a", encoding="utf-8")
        self._good_offset = self.fs.getsize(self.path)

    def close(self) -> None:
        self._fh.close()
