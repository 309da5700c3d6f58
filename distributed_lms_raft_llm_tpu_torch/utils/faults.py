"""Seeded fault injection for the real gRPC paths.

The port's copy of `distributed_lms_raft_llm_tpu/utils/faults.py`,
its logic as it is.

The chaos tests used to live exclusively on `raft.node.MemNetwork` — an
in-process transport whose drop/partition hooks never exercise the actual
sockets, codecs, or timeout plumbing. `FaultInjector` moves the same
fault surface onto the wire: a seeded RNG decides, per *target* (a Raft
peer, or the LMS→tutoring hop), whether a send is dropped, delayed,
errored after delivery (response lost), or duplicated.

Targets are plain strings — `"raft:3"` for Raft traffic to peer 3,
`"tutoring"` for the LMS→tutoring forward, `"*"` as a wildcard fallback —
so one injector instance can shape an entire node's egress. Every sampled
fault is applied on every target: Raft duplicates re-send through
`FaultyTransport`, and tutoring duplicates re-send the forward in
`lms.service.GetLLMAnswer` (it used to be a silent no-op there while
`injected_total` still counted it). Specs are
mutable at runtime: the LMS admin endpoint (`POST /admin/faults`) toggles
them over HTTP, which is how the chaos-over-real-gRPC soak drives a live
cluster.

Determinism: one `random.Random(seed)` per injector; with a fixed seed and
a fixed call sequence the same faults fire, so soak failures replay.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import threading
from typing import Dict, List, Optional

from ..raft.node import Transport
from . import metrics_registry as metric

log = logging.getLogger(__name__)


class FaultInjected(ConnectionError):
    """An injected transport failure (callers treat it like a network
    error: retry/degrade, never crash)."""


@dataclasses.dataclass
class FaultSpec:
    """Per-target fault probabilities (all default to 'no fault')."""

    drop: float = 0.0        # P(request lost before delivery)
    error: float = 0.0       # P(response lost after delivery)
    delay_s: float = 0.0     # fixed added latency
    delay_jitter_s: float = 0.0  # + uniform[0, jitter)
    duplicate: float = 0.0   # P(request delivered twice)

    def clamped(self) -> "FaultSpec":
        return FaultSpec(
            drop=min(1.0, max(0.0, self.drop)),
            error=min(1.0, max(0.0, self.error)),
            delay_s=max(0.0, self.delay_s),
            delay_jitter_s=max(0.0, self.delay_jitter_s),
            duplicate=min(1.0, max(0.0, self.duplicate)),
        )


@dataclasses.dataclass
class FaultPlan:
    """The sampled decisions for one send."""

    drop: bool = False
    error: bool = False
    delay_s: float = 0.0
    duplicate: bool = False

    @property
    def any(self) -> bool:
        return self.drop or self.error or self.duplicate or self.delay_s > 0


class FaultInjector:
    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)            # guarded-by: _lock
        self._specs: Dict[str, FaultSpec] = {}     # guarded-by: _lock
        self._lock = threading.Lock()
        self._injected = 0                         # guarded-by: _lock

    @property
    def active(self) -> bool:
        with self._lock:
            return bool(self._specs)

    def configure(self, target: str, **kwargs) -> FaultSpec:
        """Set (replace) the spec for `target`; unknown keys raise so admin
        typos surface as HTTP 400 rather than silent no-ops."""
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"unknown fault field(s) {sorted(bad)} "
                             f"(known: {sorted(known)})")
        spec = FaultSpec(**{k: float(v) for k, v in kwargs.items()}).clamped()
        with self._lock:
            self._specs[target] = spec
        return spec

    def clear(self, target: Optional[str] = None) -> None:
        with self._lock:
            if target is None:
                self._specs.clear()
            else:
                self._specs.pop(target, None)

    def spec_for(self, target: str) -> Optional[FaultSpec]:
        """Most-specific spec for `target`, with hierarchical fallback
        walked one `:` segment at a time: `raft:2:4` (group 2's hop to
        peer 4) falls back to `raft:2` (all of group 2's traffic), then
        `raft` (every group), then the `*` wildcard — so per-group chaos
        (`raft:<gid>`) composes with per-peer and whole-tier targets the
        way `tutoring:<i>`/`tutoring` already do, and one spec can still
        blanket a node's entire egress."""
        with self._lock:
            key = target
            while True:
                spec = self._specs.get(key)
                if spec is not None or ":" not in key:
                    break
                key = key.rsplit(":", 1)[0]
            return spec or self._specs.get("*")

    def plan(self, target: str) -> FaultPlan:
        """Sample this send's faults (single RNG; lock keeps the stream
        coherent under concurrent sends)."""
        spec = self.spec_for(target)
        if spec is None:
            return FaultPlan()
        with self._lock:
            plan = FaultPlan(
                drop=self._rng.random() < spec.drop,
                error=self._rng.random() < spec.error,
                delay_s=spec.delay_s
                + (self._rng.random() * spec.delay_jitter_s
                   if spec.delay_jitter_s else 0.0),
                duplicate=self._rng.random() < spec.duplicate,
            )
            if plan.drop or plan.error or plan.duplicate:
                self._injected += 1
            return plan

    async def apply_pre(self, target: str) -> FaultPlan:
        """Sample + apply the pre-delivery faults (delay, drop); returns
        the plan so the caller can apply post-delivery faults too."""
        plan = self.plan(target)
        if plan.delay_s > 0:
            await asyncio.sleep(plan.delay_s)
        if plan.drop:
            raise FaultInjected(f"injected drop -> {target}")
        return plan

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "injected_total": self._injected,
                "targets": {
                    t: dataclasses.asdict(s) for t, s in self._specs.items()
                },
            }


@dataclasses.dataclass(frozen=True)
class CampaignPhase:
    """One timed step of a chaos campaign: install `spec` on `target` for
    `duration_s`, then clear it. `target` routes like the one-shot admin
    plane: `"disk"` goes to the disk injector, anything else (including
    the `"*"` wildcard) to the network injector."""

    target: str
    duration_s: float
    spec: Dict[str, float]

    @staticmethod
    def from_json(raw: dict) -> "CampaignPhase":
        if "target" not in raw:
            raise ValueError("campaign phase needs a 'target'")
        duration = float(raw.get("duration_s", 0.0))
        if duration <= 0.0:
            raise ValueError("campaign phase needs duration_s > 0")
        spec = {k: v for k, v in raw.items()
                if k not in ("target", "duration_s")}
        return CampaignPhase(target=str(raw["target"]), duration_s=duration,
                             spec=spec)


class CampaignRunner:
    """Timed fault campaigns over one node's injectors.

    A campaign is a named sequence of `CampaignPhase`s the admin plane
    schedules in one POST instead of an operator hand-driving configure/
    clear pairs: each phase installs its spec, holds it for its duration,
    then clears that target before the next phase. `GET /admin/faults`
    reports the live phase so the semester simulator (and operators) can
    assert exactly what is injected mid-run.

    Runs on the node's event loop (started from the admin handler); all
    state is loop-confined. Cancellation — explicit or via a replacing
    campaign — clears every target the campaign touched, so a cancelled
    campaign can never strand a fault spec.
    """

    def __init__(self, faults: FaultInjector, disk_faults=None, metrics=None):
        self.faults = faults
        self.disk_faults = disk_faults
        self.metrics = metrics
        self._task: Optional[asyncio.Task] = None  # guarded-by: event-loop
        self._name: Optional[str] = None           # guarded-by: event-loop
        self._phases: List[CampaignPhase] = []     # guarded-by: event-loop
        self._phase_index: int = -1                # guarded-by: event-loop
        self._completed: int = 0                   # guarded-by: event-loop

    @property
    def active(self) -> bool:
        return self._task is not None and not self._task.done()

    def start(self, name: str, phases: List[dict]) -> dict:
        """Parse + validate every phase up front (a typo'd field must fail
        the POST, not abort the campaign mid-run), then schedule."""
        parsed = [CampaignPhase.from_json(p) for p in phases]
        if not parsed:
            raise ValueError("campaign needs at least one phase")
        for p in parsed:  # validate spec fields without touching live specs
            if p.target == "disk":
                if self.disk_faults is None:
                    raise ValueError("no disk injector on this node")
                from .diskfaults import DiskFaultSpec

                known = {f.name for f in dataclasses.fields(DiskFaultSpec)}
            else:
                known = {f.name for f in dataclasses.fields(FaultSpec)}
            bad = set(p.spec) - known
            if bad:
                raise ValueError(
                    f"unknown fault field(s) {sorted(bad)} for target "
                    f"{p.target!r} (known: {sorted(known)})"
                )
        prior = self._task
        self.cancel()
        self._name, self._phases, self._phase_index = name, parsed, -1
        self._task = asyncio.ensure_future(self._run(parsed, prior=prior))
        self._task.add_done_callback(self._on_done)
        return self.snapshot()

    def cancel(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None
        self._phase_index = -1

    async def stop(self) -> None:
        """`cancel`, then wait for the teardown to land: by return, every
        spec the campaign installed has been cleared. The admin plane's
        cancel paths use this so the POST *response* snapshot never shows
        the cancelled campaign's spec as still installed (cancel() alone
        only schedules the task's finally-clear)."""
        task = self._task
        self.cancel()
        if task is not None and not task.done():
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:  # already logged by its done callback
                pass

    def snapshot(self) -> dict:
        phase = None
        if self.active and 0 <= self._phase_index < len(self._phases):
            p = self._phases[self._phase_index]
            phase = {"target": p.target, "duration_s": p.duration_s,
                     **p.spec}
        return {
            "active": self.active,
            "name": self._name,
            "phase_index": self._phase_index if self.active else None,
            "phases_total": len(self._phases),
            "phases_completed_total": self._completed,
            "phase": phase,
        }

    # ------------------------------------------------------------ internals

    async def _run(self, phases: List[CampaignPhase],
                   prior: Optional[asyncio.Task] = None) -> None:
        if prior is not None and not prior.done():
            # Serialize the handoff: the replaced campaign's finally-clear
            # must land BEFORE this campaign installs a spec on the same
            # target, or the old teardown would wipe the new phase.
            try:
                await prior
            except asyncio.CancelledError:
                if not prior.cancelled():
                    raise  # our own cancellation, not the predecessor's
            except Exception:  # already logged by its done callback
                pass
        for i, phase in enumerate(phases):
            if self._task is not asyncio.current_task():
                return  # superseded while waiting on the predecessor
            self._phase_index = i
            try:
                if phase.target == "disk":
                    self.disk_faults.configure(**phase.spec)
                else:
                    self.faults.configure(phase.target, **phase.spec)
                if self.metrics is not None:
                    self.metrics.inc(metric.FAULT_CAMPAIGN_PHASES)
                self._completed += 1
                await asyncio.sleep(phase.duration_s)
            finally:
                # Clear even on cancellation: a campaign must never strand
                # its spec past its lifetime.
                if phase.target == "disk":
                    self.disk_faults.clear()
                else:
                    self.faults.clear(phase.target)

    def _on_done(self, task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            log.warning("fault campaign %r failed: %s", self._name, exc)


class FaultyTransport(Transport):
    """Wraps a real transport (normally `raft.grpc_transport.GrpcTransport`)
    with the injector. Target keys are `"<prefix>:<peer_id>"` so Raft
    traffic to individual peers can be shaped independently."""

    def __init__(self, inner: Transport, injector: FaultInjector,
                 prefix: str = "raft"):
        self.inner = inner
        self.injector = injector
        self.prefix = prefix

    @property
    def addresses(self):
        # RaftNode syncs membership addresses into `transport.addresses`;
        # forward to the wrapped transport's live map.
        return getattr(self.inner, "addresses", None)

    async def send(self, peer: int, message):
        plan = await self.injector.apply_pre(f"{self.prefix}:{peer}")
        resp = await self.inner.send(peer, message)
        if plan.duplicate:
            # The peer processes the message twice (Raft RPCs are
            # idempotent by design — this verifies it over real sockets).
            resp = await self.inner.send(peer, message)
        if plan.error:
            raise FaultInjected(f"injected response loss <- {self.prefix}:{peer}")
        return resp

    async def close(self) -> None:
        await self.inner.close()
