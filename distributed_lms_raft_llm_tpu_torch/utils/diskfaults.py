"""Injectable filesystem seam + disk fault injection for the storage layer.

The port's copy of `distributed_lms_raft_llm_tpu/utils/diskfaults.py`,
its logic as it is.

PRs 1-4 hardened the *network* fault surface (drops, delays, partitions,
chaos soaks); the *disk* surface was untested — and the storage modules
called `open`/`os.fsync`/`os.replace` directly, so no test could interpose
on them. This module is the seam: `raft/storage.py`, `lms/persistence.py`,
and the blob store route every byte they persist through a `FileSystem`
object, and three implementations plug in:

- `FileSystem` — the real thing (`REAL_FS` module default). Adds the two
  primitives POSIX durability actually requires beyond what the stdlib
  hands out: `fsync(f)` and `fsync_dir(path)` (rename/create durability
  needs the *parent directory* synced — the ALICE/OSDI'14 bug class).
- `FaultyFS` — wraps any FileSystem with a `DiskFaultInjector`: seeded
  ENOSPC short writes, fsync failures, bit flips on written data, and
  crash-at-op-N. Wired to the live admin plane as `POST /admin/faults`
  target `"disk"`, mirroring how `FaultyTransport` shapes the network.
- `MemCrashFS` — a purely in-memory filesystem with an explicit
  durable/pending split, for the exhaustive crash-point checker
  (tests/test_crashpoints.py). Data `write()`s and namespace ops
  (create/rename/unlink) are *pending* until `fsync`/`fsync_dir`; a
  simulated crash at any op boundary then materializes a post-crash view
  under an adversarial persistence mode:

      "none"  — nothing un-fsynced survived (strict ordering),
      "all"   — everything issued survived (write-back cache flushed),
      "meta"  — namespace ops survived but un-fsynced data did not (the
                rename-beats-content reordering that turns an uploaded
                PDF into an empty file),
      ("tail", n) — like "all" but the final un-fsynced data write only
                persisted its first n bytes (n < 0 counts back from its
                end: -1 = everything but the final byte — for a WAL
                append, a complete record missing only its newline).

Determinism: `FaultyFS` samples from one `random.Random(seed)`, like
`utils.faults.FaultInjector`; a soak failure replays from its seed.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import tempfile
import threading
from typing import Dict, List, Optional, Tuple, Union


class SimulatedCrash(BaseException):
    """Raised by a crash-injecting FS at the configured op index.

    Deliberately a BaseException: storage code must NOT be able to catch
    it with `except Exception` cleanup paths — a real power cut gives no
    such opportunity, and the checker asserts recovery works without it.
    """


class DiskFault(OSError):
    """An injected disk error (ENOSPC, EIO); callers treat it exactly
    like the real OSError it imitates."""


# --------------------------------------------------------------- real FS


class FileSystem:
    """The real filesystem, plus the durability primitives storage needs.

    Methods mirror the exact op set the storage modules use, so a fault
    or crash-sim implementation can interpose on every byte and every
    ordering point. File handles returned by `open`/`create_temp` are
    plain file objects (or wrappers quacking like them); all *durability*
    ops go through the seam (`fs.fsync(f)`, `fs.fsync_dir(path)`) rather
    than through the handle, which is what the durable-rename lint rule
    keys on.
    """

    def open(self, path: str, mode: str = "r",
             encoding: Optional[str] = None):
        return open(path, mode, encoding=encoding)

    def create_temp(self, dir_: str, prefix: str,
                    text: bool = False) -> Tuple[object, str]:
        """mkstemp + fdopen: an exclusive temp file in `dir_`."""
        fd, tmp = tempfile.mkstemp(dir=dir_, prefix=prefix)
        f = os.fdopen(fd, "w" if text else "wb",
                      encoding="utf-8" if text else None)
        return f, tmp

    def write(self, f, data) -> int:
        return f.write(data)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def fsync_dir(self, path: str) -> None:
        """Durably persist `path`'s directory entries (created/renamed/
        unlinked names). A no-op on platforms without O_DIRECTORY opens."""
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform dependent
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def truncate(self, path: str, size: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(size)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def getsize(self, path: str) -> int:
        return os.path.getsize(path)

    def remove(self, path: str) -> None:
        os.unlink(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()


REAL_FS = FileSystem()


# ------------------------------------------------------- fault injection


@dataclasses.dataclass
class DiskFaultSpec:
    """Per-op fault probabilities for the live chaos plane (all default
    to 'no fault'); mirrors utils.faults.FaultSpec for the admin API."""

    write_error: float = 0.0   # P(write raises ENOSPC after a short write)
    fsync_error: float = 0.0   # P(fsync raises EIO)
    bit_flip: float = 0.0      # P(one byte of a write is corrupted)
    crash_at_op: int = 0       # abort the process-level op stream at op N
    #                            (0 = never; used by the crash-point checker
    #                            and targeted tests, not the admin plane)

    def clamped(self) -> "DiskFaultSpec":
        return DiskFaultSpec(
            write_error=min(1.0, max(0.0, self.write_error)),
            fsync_error=min(1.0, max(0.0, self.fsync_error)),
            bit_flip=min(1.0, max(0.0, self.bit_flip)),
            crash_at_op=max(0, int(self.crash_at_op)),
        )


class DiskFaultInjector:
    """Seeded sampler for disk faults; one per node, mutable at runtime
    via `POST /admin/faults {"target": "disk", ...}` (serving/lms_server).
    Dormant (None spec, zero overhead beyond an attribute read) until the
    admin plane installs a spec."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)          # guarded-by: _lock
        self._spec: Optional[DiskFaultSpec] = None  # guarded-by: _lock
        self._ops = 0                            # guarded-by: _lock
        self._injected = 0                       # guarded-by: _lock
        self._lock = threading.Lock()

    def configure(self, **kwargs) -> DiskFaultSpec:
        known = {f.name for f in dataclasses.fields(DiskFaultSpec)}
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"unknown disk fault field(s) {sorted(bad)} "
                             f"(known: {sorted(known)})")
        spec = DiskFaultSpec(**{
            k: (int(v) if k == "crash_at_op" else float(v))
            for k, v in kwargs.items()
        }).clamped()
        with self._lock:
            self._spec = spec
        return spec

    def clear(self) -> None:
        with self._lock:
            self._spec = None

    @property
    def active(self) -> bool:
        with self._lock:
            return self._spec is not None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "injected_total": self._injected,
                "ops": self._ops,
                "spec": (dataclasses.asdict(self._spec)
                         if self._spec is not None else None),
            }

    # Sampled per FS op by FaultyFS ------------------------------------

    def on_op(self) -> None:
        """Count one durability-relevant op; crash if the spec says so."""
        with self._lock:
            self._ops += 1
            spec = self._spec
            if spec is not None and spec.crash_at_op \
                    and self._ops >= spec.crash_at_op:
                self._injected += 1
                raise SimulatedCrash(f"injected crash at disk op {self._ops}")

    def plan_write(self, nbytes: int) -> Tuple[Optional[int], Optional[int]]:
        """(short_write_len | None, flip_byte_index | None) for one write."""
        with self._lock:
            spec = self._spec
            if spec is None:
                return None, None
            short = flip = None
            if spec.write_error and self._rng.random() < spec.write_error:
                short = self._rng.randrange(nbytes + 1) if nbytes else 0
                self._injected += 1
            if spec.bit_flip and nbytes \
                    and self._rng.random() < spec.bit_flip:
                flip = self._rng.randrange(nbytes)
                self._injected += 1
            return short, flip

    def plan_fsync(self) -> bool:
        with self._lock:
            spec = self._spec
            if spec is not None and spec.fsync_error \
                    and self._rng.random() < spec.fsync_error:
                self._injected += 1
                return True
            return False


class FaultyFS(FileSystem):
    """A FileSystem with injected disk faults, mirroring FaultyTransport:
    real IO underneath, a seeded injector deciding per op whether this
    write comes up short (ENOSPC), this fsync fails (EIO), or a byte got
    flipped on its way to the platter."""

    def __init__(self, inner: FileSystem, injector: DiskFaultInjector):
        self.inner = inner
        self.injector = injector

    def open(self, path, mode="r", encoding=None):
        self.injector.on_op()
        return self.inner.open(path, mode, encoding=encoding)

    def create_temp(self, dir_, prefix, text=False):
        self.injector.on_op()
        return self.inner.create_temp(dir_, prefix, text=text)

    def write(self, f, data) -> int:
        self.injector.on_op()
        raw = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        short, flip = self.injector.plan_write(len(raw))
        if flip is not None and (short is None or flip < short):
            corrupted = bytearray(raw)
            corrupted[flip] ^= 0x01
            raw = bytes(corrupted)
        if short is not None:
            partial = raw[:short]
            if partial:
                self.inner.write(
                    f, partial.decode("utf-8", errors="replace")
                    if isinstance(data, str) else partial
                )
            raise DiskFault(errno.ENOSPC, "injected ENOSPC (short write)")
        return self.inner.write(
            f, raw.decode("utf-8") if isinstance(data, str) else raw
        )

    def fsync(self, f) -> None:
        self.injector.on_op()
        if self.injector.plan_fsync():
            raise DiskFault(errno.EIO, "injected fsync failure")
        self.inner.fsync(f)

    def fsync_dir(self, path) -> None:
        self.injector.on_op()
        if self.injector.plan_fsync():
            raise DiskFault(errno.EIO, "injected dir fsync failure")
        self.inner.fsync_dir(path)

    def replace(self, src, dst) -> None:
        self.injector.on_op()
        self.inner.replace(src, dst)

    def truncate(self, path, size) -> None:
        self.injector.on_op()
        self.inner.truncate(path, size)

    # Read-side / metadata ops pass through uncounted: crashes and faults
    # land on the durability-relevant mutation stream only, keeping
    # crash-at-op-N stable across replay-time reads.
    def exists(self, path):
        return self.inner.exists(path)

    def getsize(self, path):
        return self.inner.getsize(path)

    def remove(self, path):
        self.inner.remove(path)

    def listdir(self, path):
        return self.inner.listdir(path)

    def isdir(self, path):
        return self.inner.isdir(path)

    def makedirs(self, path):
        self.inner.makedirs(path)

    def read_bytes(self, path):
        return self.inner.read_bytes(path)


# ------------------------------------------------- in-memory crash model


class _MemFile:
    """One inode: durable bytes vs the live (pending) view, plus the
    offsets of un-fsynced appends so torn tails can be enumerated."""

    def __init__(self, content: bytes = b""):
        self.content = bytearray(content)  # live view
        self.durable = bytes(content)      # as of the last fsync
        # (start, end) of each write since the last fsync, in op order.
        self.pending_writes: List[Tuple[int, int]] = []

    def clone(self) -> "_MemFile":
        f = _MemFile()
        f.content = bytearray(self.content)
        f.durable = bytes(self.durable)
        f.pending_writes = list(self.pending_writes)
        return f


class _MemHandle:
    """File-object facade over a _MemFile (append or read modes only —
    the storage layer uses nothing else)."""

    def __init__(self, fs: "MemCrashFS", path: str, mem: _MemFile,
                 mode: str):
        self._fs = fs
        self._mem = mem
        self._path = path
        self._mode = mode
        self._text = "b" not in mode
        self._pos = len(mem.content) if ("a" in mode or "w" in mode) else 0
        self.closed = False

    # Reads ------------------------------------------------------------
    def read(self, n: int = -1):
        data = bytes(self._mem.content[self._pos:])
        if n >= 0:
            data = data[:n]
        self._pos += len(data)
        return data.decode("utf-8", errors="replace") if self._text else data

    # Writes -----------------------------------------------------------
    def write(self, data) -> int:
        raw = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        start = len(self._mem.content)
        self._mem.content.extend(raw)
        self._mem.pending_writes.append((start, start + len(raw)))
        self._pos = len(self._mem.content)
        return len(raw)

    def flush(self) -> None:  # flush ≠ durable; only fs.fsync persists
        pass

    def tell(self) -> int:
        return self._pos

    def truncate(self, size: int) -> None:
        del self._mem.content[size:]
        self._mem.pending_writes = [
            (s, min(e, size)) for s, e in self._mem.pending_writes if s < size
        ]
        self._pos = min(self._pos, size)

    def fileno(self) -> int:  # storage never calls os.fsync directly now
        return -1

    def close(self) -> None:
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


CrashMode = Union[str, Tuple[str, int]]


class MemCrashFS(FileSystem):
    """In-memory filesystem with an explicit durable/pending split.

    The live namespace (`files`) reflects every op issued; the durable
    namespace (`durable_ns`) advances only on `fsync_dir`. File *content*
    durability advances per file on `fsync`. `crash_at_op` aborts the
    op stream with SimulatedCrash; `crashed_view(mode)` then builds the
    directory state a restart would observe under the chosen adversarial
    persistence mode (see module docstring).
    """

    def __init__(self, crash_at_op: int = 0):
        self.files: Dict[str, _MemFile] = {}       # live namespace
        self.durable_ns: Dict[str, _MemFile] = {}  # as of last fsync_dir
        self.dirs: set = set()
        self.ops = 0
        self.crash_at_op = crash_at_op
        self.crashed = False
        self._tmp_seq = 0
        # Ordered log of (op_index, kind, path) for checker diagnostics.
        self.op_log: List[Tuple[int, str, str]] = []

    # -------------------------------------------------------- op stream

    def _op(self, kind: str, path: str) -> None:
        if self.crashed:
            raise SimulatedCrash("filesystem already crashed")
        self.ops += 1
        self.op_log.append((self.ops, kind, path))
        if self.crash_at_op and self.ops >= self.crash_at_op:
            self.crashed = True
            raise SimulatedCrash(f"simulated crash at op {self.ops} "
                                 f"({kind} {path})")

    @staticmethod
    def _norm(path: str) -> str:
        return os.path.normpath(os.path.abspath(path))

    # ------------------------------------------------------------- ops

    def open(self, path, mode="r", encoding=None):
        path = self._norm(path)
        writing = any(c in mode for c in "wa+")
        if writing:
            self._op("open", path)
        if path not in self.files:
            if not writing:
                raise FileNotFoundError(path)
            self.files[path] = _MemFile()
            # A newly created name is a pending namespace op: it only
            # survives a crash once its parent directory is fsynced.
        mem = self.files[path]
        if "w" in mode:
            mem.content = bytearray()
            mem.pending_writes = []
        return _MemHandle(self, path, mem, mode)

    def create_temp(self, dir_, prefix, text=False):
        dir_ = self._norm(dir_)
        self._tmp_seq += 1
        path = os.path.join(dir_, f"{prefix}{self._tmp_seq:06d}")
        self._op("create", path)
        self.files[path] = _MemFile()
        return _MemHandle(self, path, self.files[path],
                          "w" if text else "wb"), path

    def write(self, f, data) -> int:
        self._op("write", f._path)
        return f.write(data)

    def fsync(self, f) -> None:
        self._op("fsync", f._path)
        f._mem.durable = bytes(f._mem.content)
        f._mem.pending_writes = []

    def fsync_dir(self, path) -> None:
        path = self._norm(path)
        self._op("fsync_dir", path)
        # Namespace entries under `path` become durable (renames, creates,
        # unlinks); file contents stay governed by their own fsync.
        for name in list(self.durable_ns):
            if os.path.dirname(name) == path and name not in self.files:
                del self.durable_ns[name]
        for name, mem in self.files.items():
            if os.path.dirname(name) == path:
                self.durable_ns[name] = mem

    def replace(self, src, dst) -> None:
        src, dst = self._norm(src), self._norm(dst)
        self._op("rename", dst)
        if src not in self.files:
            raise FileNotFoundError(src)
        self.files[dst] = self.files.pop(src)

    def truncate(self, path, size) -> None:
        path = self._norm(path)
        self._op("truncate", path)
        mem = self.files[path]
        del mem.content[size:]
        mem.pending_writes = [
            (s, min(e, size)) for s, e in mem.pending_writes if s < size
        ]

    def exists(self, path) -> bool:
        return self._norm(path) in self.files

    def getsize(self, path) -> int:
        return len(self.files[self._norm(path)].content)

    def remove(self, path) -> None:
        path = self._norm(path)
        self._op("unlink", path)
        self.files.pop(path, None)

    def listdir(self, path) -> List[str]:
        path = self._norm(path)
        return sorted({
            os.path.relpath(name, path).split(os.sep)[0]
            for name in self.files
            if name.startswith(path + os.sep)
        } | {
            os.path.relpath(d, path).split(os.sep)[0]
            for d in self.dirs
            if d.startswith(path + os.sep)
        })

    def isdir(self, path) -> bool:
        path = self._norm(path)
        return path in self.dirs or any(
            n.startswith(path + os.sep) for n in self.files
        )

    def makedirs(self, path) -> None:
        self.dirs.add(self._norm(path))

    def read_bytes(self, path) -> bytes:
        path = self._norm(path)
        if path not in self.files:
            raise FileNotFoundError(path)
        return bytes(self.files[path].content)

    # ----------------------------------------------------- crash views

    def crashed_view(self, mode: CrashMode) -> "MemCrashFS":
        """The filesystem a restart would observe after the crash, under
        adversarial persistence `mode` ("none" | "all" | "meta" |
        ("tail", n))."""
        post = MemCrashFS()
        post.dirs = set(self.dirs)
        tail_n: Optional[int] = None
        if isinstance(mode, tuple):
            mode, tail_n = mode
        if mode == "none":
            namespace = self.durable_ns
        elif mode in ("all", "meta", "tail"):
            namespace = self.files
        else:
            raise ValueError(f"unknown crash mode {mode!r}")
        # The last pending (un-fsynced) write across all files, for "tail".
        tail_file: Optional[str] = None
        if mode == "tail":
            for op_i, kind, path in reversed(self.op_log):
                if kind == "write" and path in self.files \
                        and self.files[path].pending_writes:
                    tail_file = path
                    break
        for name, mem in namespace.items():
            if mode == "all":
                content = bytes(mem.content)
            elif mode == "meta":
                content = bytes(mem.durable)
            elif mode == "none":
                content = bytes(mem.durable)
            else:  # tail
                if name == tail_file and mem.pending_writes:
                    start, end = mem.pending_writes[-1]
                    n = tail_n if tail_n is not None else end - start
                    if n < 0:
                        n = max(0, (end - start) + n)
                    content = bytes(mem.content[:min(start + n, end)])
                else:
                    content = bytes(mem.content)
            f = _MemFile(content)
            post.files[name] = f
            post.durable_ns[name] = f
        return post
