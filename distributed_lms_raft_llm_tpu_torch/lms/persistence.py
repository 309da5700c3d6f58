"""LMS snapshot persistence + the PDF blob store.

The port's copy of `distributed_lms_raft_llm_tpu/lms/persistence.py`,
its logic as it is.

Parity target: the reference rewrites `lms_data.json` after every applied
command and keeps PDFs under `uploads/` (reference:
GUI_RAFT_LLM_SourceCode/lms_server.py:30-92, 312). Here:

- the snapshot additionally records `applied_index`, so on boot the node
  restores the snapshot and Raft replays only the WAL suffix after it
  (the reference had no Raft durability at all);
- the snapshot carries an integrity header (format version, CRC32 of the
  payload, applied_index) — a corrupt snapshot *raises*
  `SnapshotCorruption` instead of silently loading as an empty state at
  index 0, which after WAL compaction was unrecoverable data loss (the
  WAL prefix the snapshot covered is gone). The node then recovers per
  `[storage].recovery`: refuse to start, or discard local state and
  rejoin via InstallSnapshot (lms.node);
- writes are atomic AND durable: tmp + fsync + rename + parent-dir fsync
  (rename without the source fsync can survive a crash that the file's
  *contents* did not — the uploaded-PDF-becomes-empty-file bug);
- every file op routes through the `utils.diskfaults.FileSystem` seam so
  disk faults and crash points are injectable;
- the blob store confines paths to its root (the reference wrote whatever
  `destination_path` a peer sent — path traversal by design).

Snapshot format v2 (two lines):

    {"t": "lmssnap", "v": 2, "crc": "<crc32:08x>", "len": N, "applied_index": I}
    <payload: {"applied_index": I, "data": {...}} — exactly N bytes>

Legacy v1 files (a bare JSON object) still load — one clean boot
migrates them: the next save writes v2.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional, Tuple

from ..utils import metrics_registry as metric
from ..utils.diskfaults import REAL_FS, FileSystem
from .state import LMSState

SNAP_TMP_PREFIX = ".lmssnap."
# Exact temp prefixes, matched in full by the boot sweep. Blob rel_paths
# arrive over the wire, so these names are RESERVED (_resolve refuses
# them): a looser match like ".blob" would let the sweep delete a
# legitimately named acked upload (e.g. ".blobs-week3.pdf").
BLOB_TMP_PREFIXES = (".blob.", ".blobstream.")
SNAP_MAGIC = '{"t": "lmssnap"'


class SnapshotCorruption(Exception):
    """The LMS state snapshot failed its integrity check. Loading it as
    an empty state would silently discard every applied command the
    compacted WAL no longer holds."""

    def __init__(self, path: str, reason: str):
        super().__init__(
            f"snapshot {path} corrupt: {reason} — refusing to load an "
            f"empty state over compacted history; restore the file or let "
            f"the node rejoin from the leader"
        )
        self.path = path
        self.reason = reason


class SnapshotStore:
    def __init__(self, path: str, *, fs: Optional[FileSystem] = None,
                 metrics=None):
        self.path = path
        self.fs = fs or REAL_FS
        self._metrics = metrics
        self._dir = os.path.dirname(os.path.abspath(path))
        self.fs.makedirs(self._dir)
        # Diagnostics for the migration path: True once a v1 file loaded.
        self.legacy_loaded = False
        removed = 0
        for name in self.fs.listdir(self._dir):
            if name.startswith(SNAP_TMP_PREFIX):
                self.fs.remove(os.path.join(self._dir, name))
                removed += 1
        if removed and self._metrics is not None:
            self._metrics.inc(metric.STALE_TMP_FILES_REMOVED, removed)

    def load(self) -> Tuple[LMSState, int]:
        """(state, applied_index) — empty state at index 0 when absent.
        Raises SnapshotCorruption on integrity failure (never silently
        empty: absence and damage are different recovery situations)."""
        if not self.fs.exists(self.path):
            return LMSState(), 0
        # A read error (transient EIO, EACCES) is NOT corruption: it must
        # propagate as the OSError it is and fail the boot loudly, not
        # trigger rejoin-mode quarantine of possibly-good state.
        data = self.fs.read_bytes(self.path)
        try:
            if data.startswith(SNAP_MAGIC.encode("utf-8")):
                obj = self._load_v2(data)
            else:
                # Legacy v1: no integrity header; accepted so a
                # pre-checksum deployment boots cleanly once, then the
                # next save upgrades the file in place.
                obj = json.loads(data.decode("utf-8"))
                if not isinstance(obj, dict):
                    raise ValueError("not a JSON object")
                self.legacy_loaded = True
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            if self._metrics is not None:
                self._metrics.inc(metric.SNAPSHOT_INTEGRITY_FAILURES)
            raise SnapshotCorruption(self.path, str(e)) from e
        return LMSState(obj.get("data", {})), int(obj.get("applied_index", 0))

    def _load_v2(self, data: bytes) -> dict:
        nl = data.find(b"\n")
        if nl < 0:
            raise ValueError("v2 header line unterminated (torn write)")
        header = json.loads(data[:nl].decode("utf-8"))
        payload = data[nl + 1:]
        if payload.endswith(b"\n"):
            payload = payload[:-1]
        want_len = int(header["len"])
        if len(payload) != want_len:
            raise ValueError(
                f"payload is {len(payload)} bytes, header declares "
                f"{want_len} (torn or truncated write)"
            )
        got_crc = zlib.crc32(payload) & 0xFFFFFFFF
        if f"{got_crc:08x}" != header["crc"]:
            raise ValueError(
                f"CRC mismatch: stored {header['crc']}, computed "
                f"{got_crc:08x}"
            )
        obj = json.loads(payload.decode("utf-8"))
        if int(obj.get("applied_index", -1)) != int(header["applied_index"]):
            raise ValueError("header/payload applied_index disagree")
        return obj

    def save(self, state: LMSState, applied_index: int) -> None:
        payload = json.dumps(
            {"applied_index": applied_index, "data": state.data}
        ).encode("utf-8")
        header = json.dumps({
            "t": "lmssnap", "v": 2,
            "crc": f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}",
            "len": len(payload), "applied_index": applied_index,
        })
        f, tmp = self.fs.create_temp(self._dir, SNAP_TMP_PREFIX)
        try:
            with f:
                self.fs.write(f, header.encode("utf-8") + b"\n")
                self.fs.write(f, payload + b"\n")
                self.fs.fsync(f)
        except OSError:
            if self.fs.exists(tmp):
                self.fs.remove(tmp)
            raise
        self.fs.replace(tmp, self.path)
        self.fs.fsync_dir(self._dir)


class BlobStore:
    """PDF files under one root; all paths are stored and exchanged relative
    to it (wire `destination_path` stays inside the root on every node)."""

    def __init__(self, root: str, *, fs: Optional[FileSystem] = None,
                 metrics=None):
        self.root = os.path.abspath(root)
        self.fs = fs or REAL_FS
        self._metrics = metrics
        self.fs.makedirs(self.root)
        removed = self._sweep(self.root)
        if removed and self._metrics is not None:
            self._metrics.inc(metric.STALE_TMP_FILES_REMOVED, removed)

    def _sweep(self, dir_: str) -> int:
        removed = 0
        for name in self.fs.listdir(dir_):
            full = os.path.join(dir_, name)
            if self.fs.isdir(full):
                removed += self._sweep(full)
            elif name.startswith(BLOB_TMP_PREFIXES):
                self.fs.remove(full)
                removed += 1
        return removed

    def _resolve(self, rel_path: str) -> str:
        full = os.path.abspath(os.path.join(self.root, rel_path))
        if not full.startswith(self.root + os.sep) and full != self.root:
            raise ValueError(f"path escapes blob root: {rel_path!r}")
        if os.path.basename(full).startswith(BLOB_TMP_PREFIXES):
            # Reserved temp namespace: a stored blob carrying a temp
            # prefix would be deleted by the next boot's stray sweep.
            raise ValueError(
                f"blob name uses a reserved temp prefix: {rel_path!r}"
            )
        return full

    def put(self, rel_path: str, data: bytes) -> str:
        full = self._resolve(rel_path)
        parent = os.path.dirname(full)
        self.fs.makedirs(parent)
        f, tmp = self.fs.create_temp(parent, ".blob.")
        try:
            with f:
                self.fs.write(f, data)
                # fsync BEFORE rename: the rename's directory update can
                # survive a crash the un-synced contents did not, leaving
                # a durable name pointing at an empty/partial file.
                self.fs.fsync(f)
        except OSError:
            if self.fs.exists(tmp):
                self.fs.remove(tmp)
            raise
        self.fs.replace(tmp, full)
        self.fs.fsync_dir(parent)
        return full

    def get(self, rel_path: str) -> Optional[bytes]:
        full = self._resolve(rel_path)
        if not self.fs.exists(full):
            return None
        return self.fs.read_bytes(full)

    def exists(self, rel_path: str) -> bool:
        return self.fs.exists(self._resolve(rel_path))

    def open_writer(self, rel_path: str):
        """Streaming writer for chunked replication: collects chunks into a
        temp file and renames on close (re-sent files replace, never append —
        the reference appended with 'ab', duplicating content on resend,
        defect D5)."""
        full = self._resolve(rel_path)
        self.fs.makedirs(os.path.dirname(full))
        return _BlobWriter(full, self.fs)


class _BlobWriter:
    def __init__(self, final_path: str, fs: Optional[FileSystem] = None):
        self.final_path = final_path
        self.fs = fs or REAL_FS
        self._parent = os.path.dirname(final_path)
        self._f, self._tmp = self.fs.create_temp(
            self._parent, ".blobstream."
        )
        self.bytes_written = 0

    def write(self, chunk: bytes) -> None:
        self.fs.write(self._f, chunk)
        self.bytes_written += len(chunk)

    def commit(self) -> None:
        # flush+fsync before the rename, then make the rename itself
        # durable — without both, a crash can leave a committed *name*
        # whose bytes never reached the platter.
        self.fs.fsync(self._f)
        self._f.close()
        self.fs.replace(self._tmp, self.final_path)
        self.fs.fsync_dir(self._parent)

    def abort(self) -> None:
        self._f.close()
        if self.fs.exists(self._tmp):
            self.fs.remove(self._tmp)
