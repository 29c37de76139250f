"""Fault-tolerant multi-tenant streaming front end over the fused
tracking frame.

Many independent tenants (scenes/sensors) submit frames asynchronously
at different rates, shards die, sensors go dark, and payloads arrive
corrupt, late or duplicated; the front end keeps every tenant's closed
loop running through all of it:

* **Dynamic batch forming** — a ``SlotAllocator`` packs tenants onto
  the sensor lanes of ``make_multi_sensor_step`` (the step
  ``ShardedBankEngine`` serves): each tenant owns one lane of a shard's
  stacked bank, so ONE fused frame call per shard (one ``katana_frame``
  / ``katana_imm_frame`` launch over the shard's ``lanes_per_shard``
  lanes) serves every tenant that has a frame pending, and slots on the
  C axis are never shared between tenants. Track ids live in per-tenant
  namespaces (``ns_base + local id``). Lanes whose tenant has nothing
  pending are *frozen* (``torch.where`` on each leaf's sensor axis
  keeps their bank state): a tenant's stream is frame-indexed, so an
  idle pump must not age its tracks.
* **Admission control + backpressure** — bounded per-tenant queues
  with explicit decisions (``Admission``): accept, duplicate-drop,
  deadline-expired shed, drop-oldest replacement, queue-full reject,
  overload reject. Overload walks the **degradation ladder**
  (``ServiceTier``): FULL -> WIDE_GATE (the tracker's ``gate_scale``)
  -> COAST_ONLY (frames served through the ``valid`` mask with the
  measurements shed) -> REJECT (admission closed), monotone in load. A
  ``CircuitBreaker`` guards the dispatch path: repeated failures open
  it (forced REJECT tier) and a half-open probe re-closes it.
* **Checkpointed failover** — every tenant lane is periodically
  snapshotted (``checkpoint.ckpt``: atomic, keep-N, validated restore)
  together with a write-ahead log (WAL) of the frames applied since.
  When a shard dies (heartbeat timeout via
  ``runtime.ft.HeartbeatMonitor``, or repeated dispatch failures), its
  tenants are restored onto surviving shards: the checkpoint seeds the
  lane's mode-conditioned (x, P, mu) bit for bit, the WAL replays
  through the surviving shard's own fused step in a scratch stack whose
  other lanes are empty, and the resumed stream is bit for bit an
  uninterrupted run's, track ids preserved. That rests on the fused
  frame giving one lane the same bits whatever its neighbour lanes hold.
* **Degraded-input robustness** — NaN/inf payloads coast through the
  tracker's ``nan_guard``; a dark sensor submits empty frames (tracks
  coast, then prune); duplicates and stale frames are dropped at
  admission by sequence number.

Shards run on ``devices`` (shard s on ``devices[s % len(devices)]``;
one card may hold several shards), the card unless the caller names
"cpu". ``serving/faults.py`` injects every fault deterministically.
"""
from __future__ import annotations

import tempfile
import time
import warnings
from collections import deque
from dataclasses import dataclass, field, replace
from enum import Enum, IntEnum
from typing import (Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.core import bank as bank_lib
from repro_torch.core.filters import IMMModel
from repro_torch.core.tracker import (FrameResult, TrackerConfig,
                                      make_multi_sensor_step)
from repro_torch.runtime.ft import HeartbeatMonitor, StragglerDetector
from repro_torch.serving.engine import TrackSnapshot, _on, _wait

# Per-tenant track-id namespace stride: global id = ns_base + local id.
# 2^20 local ids per tenant epoch is far beyond any bank capacity.
NS_STRIDE = 1 << 20


class ServiceTier(IntEnum):
    """The degradation ladder, ordered: a HIGHER tier is strictly less
    service. More load can only move the tier up (monotone)."""

    FULL = 0        # measurements served, nominal gate
    WIDE_GATE = 1   # measurements served, gate widened (gate_scale)
    COAST_ONLY = 2  # frames consumed but measurements shed: coast via
                    # the valid mask — cadence kept, quality degraded
    REJECT = 3      # admission closed; queued frames coast-drain


class Admission(Enum):
    """Explicit per-submit decision — backpressure is a return value,
    never an exception and never a silent drop."""

    ACCEPTED = "accepted"
    REPLACED_OLDEST = "replaced-oldest"     # accepted; oldest was shed
    REJECTED_QUEUE_FULL = "rejected-queue-full"
    REJECTED_OVERLOAD = "rejected-overload"  # ladder/breaker at REJECT
    REJECTED_NO_CAPACITY = "rejected-no-capacity"  # no free lane
    DUPLICATE = "duplicate"                 # seq already consumed


@dataclass(frozen=True)
class StreamConfig:
    n_shards: int = 2
    lanes_per_shard: int = 4      # tenant lanes per shard
    queue_depth: int = 4          # bounded per-tenant queue
    checkpoint_every: int = 8     # tenant frames between snapshots
    # degradation-ladder thresholds on the load factor (queued frames /
    # total queue capacity, in [0, 1]); must be sorted ascending
    degrade_at: float = 0.375
    coast_at: float = 0.625
    reject_at: float = 0.875
    wide_gate_scale: float = 2.5  # gate multiplier at WIDE_GATE
    drop_oldest: bool = True      # queue-full: shed oldest, accept new
    # anti-starvation floor: after this many CONSECUTIVE ladder-shed
    # frames a tenant's next frame is served regardless of tier, so a
    # sustained overload degrades everyone instead of starving anyone
    starve_limit: int = 4
    heartbeat_timeout_s: float = 1.0
    breaker_failures: int = 3     # consecutive failures to open
    breaker_cooldown_s: float = 5.0

    def __post_init__(self):
        if not (0.0 < self.degrade_at <= self.coast_at <= self.reject_at):
            raise ValueError("ladder thresholds must be sorted: "
                             f"{self.degrade_at}, {self.coast_at}, "
                             f"{self.reject_at}")


@dataclass(frozen=True)
class DegradationLadder:
    """load in [0, inf) -> ServiceTier; monotone non-decreasing."""

    degrade_at: float
    coast_at: float
    reject_at: float

    def tier_for(self, load: float) -> ServiceTier:
        if load >= self.reject_at:
            return ServiceTier.REJECT
        if load >= self.coast_at:
            return ServiceTier.COAST_ONLY
        if load >= self.degrade_at:
            return ServiceTier.WIDE_GATE
        return ServiceTier.FULL


class CircuitBreaker:
    """Classic three-state breaker around the dispatch path.

    CLOSED: traffic flows, consecutive failures count up. At
    ``failure_threshold`` the breaker OPENs: ``allow()`` is False until
    ``cooldown_s`` elapses, after which it is HALF_OPEN — one probe is
    allowed; its success re-CLOSEs, its failure re-OPENs (fresh
    cooldown). The clock is injectable so chaos tests drive it
    deterministically."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.failures = 0
        self.trips = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return self.CLOSED
        if self.clock() - self._opened_at >= self.cooldown_s:
            return self.HALF_OPEN
        return self.OPEN

    def allow(self) -> bool:
        return self.state != self.OPEN

    def record_success(self) -> None:
        self.failures = 0
        self._opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN or \
                self.failures >= self.failure_threshold:
            self._opened_at = self.clock()  # (re)open, fresh cooldown
            self.trips += 1


class SlotAllocator:
    """Maps tenants onto (shard, lane) slots of the serving fleet.

    Invariants: no two tenants ever hold the same (shard, lane); the
    tenant count never exceeds the live lane pool; released lanes are
    reusable; lanes of a dropped (dead) shard are never handed out
    again. Also owns the per-tenant track-id namespace counter — a
    namespace is never reissued, so ids from an evicted tenant can never
    collide with a later one's."""

    def __init__(self, n_shards: int, lanes_per_shard: int):
        self.lanes_per_shard = lanes_per_shard
        # pop() hands out the lowest free lane — deterministic packing
        self.free: Dict[int, List[int]] = {
            s: list(range(lanes_per_shard - 1, -1, -1))
            for s in range(n_shards)}
        self.where: Dict[str, Tuple[int, int]] = {}
        self._next_ns = 0

    def capacity(self) -> int:
        return len(self.where) + sum(len(f) for f in self.free.values())

    def acquire(self, tenant: str,
                prefer: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """Claim a lane for ``tenant`` (must not hold one). Picks the
        shard with the most free lanes (balance), lowest index on
        ties; ``prefer`` pins a shard when it has room. None = full."""
        if tenant in self.where:
            raise ValueError(f"tenant {tenant!r} already holds "
                             f"{self.where[tenant]}")
        if prefer is not None and self.free.get(prefer):
            s = prefer
        else:
            with_room = [(len(f), -s) for s, f in self.free.items() if f]
            if not with_room:
                return None
            s = -max(with_room)[1]
        lane = self.free[s].pop()
        self.where[tenant] = (s, lane)
        return s, lane

    def release(self, tenant: str) -> Tuple[int, int]:
        s, lane = self.where.pop(tenant)
        if s in self.free:  # dead shards are out of the pool
            self.free[s].append(lane)
            self.free[s].sort(reverse=True)
        return s, lane

    def drop_shard(self, shard: int) -> None:
        """A dead shard's lanes leave the pool forever (its tenants
        must be released/re-acquired by the failover path first)."""
        self.free.pop(shard, None)

    def tenants_on(self, shard: int) -> List[str]:
        return sorted(t for t, (s, _) in self.where.items() if s == shard)

    def next_namespace(self) -> int:
        ns = self._next_ns
        self._next_ns += 1
        return ns * NS_STRIDE


@dataclass
class FrameRequest:
    seq: int
    z: np.ndarray               # (k, m), k may be 0 (dark sensor tick)
    t_submit: float
    deadline: Optional[float]   # absolute, front-end clock domain


@dataclass
class TenantUpdate:
    """One applied frame of one tenant's stream."""

    tenant: str
    frame: int                  # tenant-stream frame index (0-based)
    seq: int
    tier: ServiceTier
    kind: str                   # "served" | "coast" | "shed"
    shard: str
    snapshots: List[TrackSnapshot] = field(default_factory=list)


@dataclass
class StreamStats:
    submitted: int = 0
    accepted: int = 0
    duplicates: int = 0
    replaced_oldest: int = 0
    rejected_queue_full: int = 0
    rejected_overload: int = 0
    rejected_no_capacity: int = 0
    expired: int = 0            # deadline-shed before dispatch
    served: int = 0             # frames applied with measurements
    coasted: int = 0            # empty frames applied (dark sensor)
    shed: int = 0               # frames applied coast-only by the ladder
    dispatches: int = 0         # fused step calls
    dispatch_errors: int = 0
    failovers: int = 0          # tenants migrated off dead shards
    shards_lost: int = 0
    checkpoints: int = 0
    parked: int = 0             # tenants with no surviving lane

    @property
    def applied(self) -> int:
        return self.served + self.coasted + self.shed


@dataclass
class _Tenant:
    name: str
    shard: int
    lane: int
    ns_base: int
    ckpt: CheckpointManager
    queue: Deque[FrameRequest] = field(default_factory=deque)
    next_seq: int = 0
    frames_applied: int = 0
    ckpt_frame: int = 0         # frames_applied at the last snapshot
    # write-ahead log since the last checkpoint: (tier, z_row, v_row)
    wal: List[Tuple[int, np.ndarray, np.ndarray]] = field(
        default_factory=list)
    sheds_in_row: int = 0       # consecutive ladder-shed frames
    parked: bool = False


@dataclass
class _Shard:
    name: str
    idx: int
    banks: object               # stacked BankState/IMMBankState, or None
    device: Optional[torch.device] = None
    alive: bool = True          # False once failed over
    killed: bool = False        # fault-injection: silent death
    consecutive_failures: int = 0


# one multi-sensor step per (model, cfg, lane count, device), shared by
# every shard and every front end (the value keeps ``model`` alive, so
# id() keys are stable)
_STEP_CACHE: Dict[Tuple, Tuple] = {}


def _multi_step(model, cfg: TrackerConfig, lanes: int, device):
    key = (id(model), cfg, lanes, device)
    if key not in _STEP_CACHE:
        one, axes, step = make_multi_sensor_step(model, cfg, device)
        _STEP_CACHE[key] = (one, axes, step, model)
    return _STEP_CACHE[key][:3]


def _select_lanes(mask: np.ndarray, new, old, axes):
    """Per-lane select over a stacked bank: lane i takes ``new`` where
    mask[i], else keeps ``old`` — how idle tenants' lanes are frozen
    while the dispatch still runs as one fused call. The mask is copied
    to the banks' device once."""
    m = torch.from_numpy(np.ascontiguousarray(mask)).to(new.x.device)

    def sel(n, o, a):
        shape = (1,) * a + (m.shape[0],) + (1,) * (n.dim() - a - 1)
        return torch.where(m.reshape(shape), n, o)

    return type(new)(*(sel(n, o, a) for n, o, a in zip(new, old, axes)))


class StreamFrontEnd:
    """The multi-tenant streaming facade over the fused frame step.

    ``attach`` a tenant, ``submit`` its frames (any rate, any order —
    admission answers with an explicit decision), ``pump`` once per
    serving cycle: one fused multi-sensor dispatch per live shard serves
    every tenant with a frame pending and returns the per-tenant
    ``TenantUpdate``s. ``kill_shard`` is the fault-injection surface;
    recovery (checkpoint restore + WAL replay onto a surviving shard)
    happens inside ``pump`` once the heartbeat monitor declares the
    shard dead.

    The ``clock`` is injectable (deadlines, heartbeats and the circuit
    breaker all read it) so every failure path is deterministic under
    test; wall-time dispatch statistics always use
    ``time.perf_counter``. Shard s runs on ``devices[s % len(devices)]``
    (each through ``resolve_device``: "cuda" unless the caller names
    "cpu").
    """

    def __init__(self, model, cfg: Optional[StreamConfig] = None,
                 tracker: Optional[TrackerConfig] = None,
                 ckpt_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 devices: Sequence = ("cuda",)):
        self.model = model
        self.cfg = cfg or StreamConfig()
        self.tracker = tracker or TrackerConfig(capacity=64, max_meas=32)
        self.is_imm = isinstance(model, IMMModel)
        self.clock = clock
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        self.ckpt_root = ckpt_dir or tempfile.mkdtemp(
            prefix="katana_stream_ckpt_")
        self.ladder = DegradationLadder(self.cfg.degrade_at,
                                        self.cfg.coast_at,
                                        self.cfg.reject_at)
        self.breaker = CircuitBreaker(self.cfg.breaker_failures,
                                      self.cfg.breaker_cooldown_s, clock)
        self.alloc = SlotAllocator(self.cfg.n_shards,
                                   self.cfg.lanes_per_shard)
        self.stats = StreamStats()
        self.tenants: Dict[str, _Tenant] = {}
        self._tier_cfg = {
            ServiceTier.FULL: self.tracker,
            ServiceTier.WIDE_GATE: replace(
                self.tracker,
                gate_scale=self.tracker.gate_scale
                * self.cfg.wide_gate_scale),
        }
        L = self.cfg.lanes_per_shard
        # one empty single-lane bank per device: the attach and restore
        # template
        self._ones = {}
        self.shards: List[_Shard] = []
        for s in range(self.cfg.n_shards):
            dev = devs[s % len(devs)]
            one, self._axes, _ = _multi_step(model, self.tracker, L, dev)
            self._ones[dev] = one
            self.shards.append(_Shard(
                f"shard{s}", s, bank_lib.stack_sensor_banks(one, L),
                device=dev))
        self.monitor = HeartbeatMonitor([sh.name for sh in self.shards],
                                        self.cfg.heartbeat_timeout_s,
                                        clock)
        self.stragglers = StragglerDetector([sh.name for sh in self.shards])

    # ------------------------------------------------------------ admission
    def attach(self, tenant: str) -> Admission:
        """Admit a tenant: claim a lane, reset it to an empty bank, and
        write its frame-0 checkpoint (failover must always have a
        snapshot to restore from)."""
        if tenant in self.tenants:
            raise ValueError(f"tenant {tenant!r} already attached")
        alive = {sh.idx for sh in self.shards if sh.alive}
        while True:
            loc = self.alloc.acquire(tenant)
            if loc is None or loc[0] in alive:
                break
            # allocator still had room only on a dead shard
            self.alloc.release(tenant)
            self.alloc.drop_shard(loc[0])
        if loc is None:
            self.stats.rejected_no_capacity += 1
            return Admission.REJECTED_NO_CAPACITY
        s, lane = loc
        shard = self.shards[s]
        shard.banks = bank_lib.place_sensor_bank(shard.banks, lane,
                                                 self._ones[shard.device])
        t = _Tenant(tenant, s, lane, self.alloc.next_namespace(),
                    CheckpointManager(f"{self.ckpt_root}/{tenant}",
                                      keep_n=2))
        self.tenants[tenant] = t
        self._checkpoint(t)
        return Admission.ACCEPTED

    def detach(self, tenant: str) -> None:
        t = self.tenants.pop(tenant)
        if not t.parked:
            self.alloc.release(tenant)

    def submit(self, tenant: str, z, seq: Optional[int] = None,
               deadline: Optional[float] = None) -> Admission:
        """Queue one frame for ``tenant``. z: (k, m) measurements (k=0
        = dark-sensor tick: the frame coasts). ``seq`` defaults to the
        next expected; anything already consumed is a DUPLICATE (late
        and re-sent frames alike). ``deadline`` is absolute on the
        front-end clock; expired frames are shed before dispatch."""
        t = self.tenants[tenant]
        self.stats.submitted += 1
        z = np.asarray(z, np.float32).reshape(-1, self.model.m)
        seq = t.next_seq if seq is None else int(seq)
        if seq < t.next_seq:
            self.stats.duplicates += 1
            return Admission.DUPLICATE
        if self.effective_tier() >= ServiceTier.REJECT:
            self.stats.rejected_overload += 1
            return Admission.REJECTED_OVERLOAD
        req = FrameRequest(seq, z, self.clock(), deadline)
        decision = Admission.ACCEPTED
        if len(t.queue) >= self.cfg.queue_depth:
            if not self.cfg.drop_oldest:
                self.stats.rejected_queue_full += 1
                return Admission.REJECTED_QUEUE_FULL
            t.queue.popleft()  # stalest frame is the cheapest to lose
            self.stats.replaced_oldest += 1
            decision = Admission.REPLACED_OLDEST
        t.queue.append(req)
        t.next_seq = seq + 1
        self.stats.accepted += 1
        return decision

    # ------------------------------------------------------------- telemetry
    def pending(self) -> int:
        return sum(len(t.queue) for t in self.tenants.values())

    def load(self) -> float:
        cap = max(1, len(self.tenants)) * self.cfg.queue_depth
        return self.pending() / cap

    def effective_tier(self) -> ServiceTier:
        """Ladder tier from the current load, forced to REJECT while
        the circuit breaker is open."""
        tier = self.ladder.tier_for(self.load())
        if not self.breaker.allow():
            return ServiceTier.REJECT
        return tier

    def shards_alive(self) -> List[str]:
        return [sh.name for sh in self.shards if sh.alive]

    # ------------------------------------------------------------ fault hook
    def kill_shard(self, shard) -> None:
        """Fault injection: the shard dies silently — it stops serving
        and stops heartbeating, but the front end only learns of it
        when the heartbeat times out (or dispatches keep failing)."""
        sh = self._shard(shard)
        sh.killed = True
        sh.banks = None  # the state is gone with the host

    def _shard(self, shard) -> _Shard:
        if isinstance(shard, _Shard):
            return shard
        for sh in self.shards:
            if sh.idx == shard or sh.name == shard:
                return sh
        raise KeyError(shard)

    # ---------------------------------------------------------------- pump
    def pump(self) -> Dict[str, TenantUpdate]:
        """One serving cycle: detect/recover dead shards, then one
        fused dispatch per live shard over every tenant with a pending
        frame. Returns the applied updates keyed by tenant. Never
        raises on shard failure — errors feed the breaker and the
        failover path."""
        now = self.clock()
        # a reachable shard beats once per pump; a killed one goes
        # silent and crosses the timeout after enough clock passes
        for sh in self.shards:
            if sh.alive and not sh.killed:
                self.monitor.beat(sh.name)
        self._recover_dead(now)
        tier = self.effective_tier()
        updates: Dict[str, TenantUpdate] = {}
        for sh in self.shards:
            if not sh.alive:
                continue
            self._pump_shard(sh, tier, now, updates)
        return updates

    def _pump_shard(self, sh: _Shard, tier: ServiceTier, now: float,
                    updates: Dict[str, TenantUpdate]) -> None:
        L, M, m = (self.cfg.lanes_per_shard, self.tracker.max_meas,
                   self.model.m)
        zb = np.zeros((L, M, m), np.float32)
        vb = np.zeros((L, M), bool)
        participate = np.zeros((L,), bool)
        plan: List[Tuple[_Tenant, FrameRequest, str]] = []
        for name in self.alloc.tenants_on(sh.idx):
            t = self.tenants[name]
            while t.queue and t.queue[0].deadline is not None \
                    and t.queue[0].deadline < now:
                t.queue.popleft()
                self.stats.expired += 1
            if not t.queue:
                continue  # lane frozen this pump
            req = t.queue[0]  # peek — committed only if dispatch lands
            k = min(len(req.z), M)
            starving = t.sheds_in_row >= self.cfg.starve_limit - 1
            if tier >= ServiceTier.COAST_ONLY and k and not starving:
                kind = "shed"  # ladder sheds the measurements, keeps
                # the cadence: the lane coasts via the valid mask
            elif k == 0:
                kind = "coast"
            else:
                # nominal service — or the anti-starvation floor firing
                # under a coasting tier
                kind = "served"
                zb[t.lane, :k] = req.z[:k]
                vb[t.lane, :k] = True
            participate[t.lane] = True
            plan.append((t, req, kind))
        if sh.killed or not plan:
            return  # dead: no result, queues intact; idle: lanes frozen
        step_tier = (ServiceTier.WIDE_GATE if tier == ServiceTier.WIDE_GATE
                     else ServiceTier.FULL)
        t0 = time.perf_counter()
        try:
            res = self._dispatch(sh.device, step_tier, sh.banks, zb, vb)
            _wait([sh.device])  # the clock stops with the shard's stream
        except Exception:  # noqa: BLE001 — the loop must keep closing
            self.stats.dispatch_errors += 1
            self.breaker.record_failure()
            sh.consecutive_failures += 1
            if sh.consecutive_failures >= self.cfg.breaker_failures:
                sh.killed = True  # persistent failure == dead shard
                sh.banks = None
            return
        dt = time.perf_counter() - t0
        sh.consecutive_failures = 0
        self.breaker.record_success()
        self.stragglers.record(sh.name, dt)
        self.stats.dispatches += 1
        sh.banks = _select_lanes(participate, res.bank, sh.banks,
                                 self._axes)
        host = self._host_fields(res, participate)
        counters = {"served": "served", "coast": "coasted", "shed": "shed"}
        for t, req, kind in plan:
            t.queue.popleft()  # commit
            # the WAL records the step tier that actually dispatched —
            # replay re-runs exactly that step, which is what makes the
            # resumed stream bitwise
            t.wal.append((int(step_tier), zb[t.lane].copy(),
                          vb[t.lane].copy()))
            frame = t.frames_applied
            t.frames_applied += 1
            t.sheds_in_row = t.sheds_in_row + 1 if kind == "shed" else 0
            field_name = counters[kind]
            setattr(self.stats, field_name,
                    getattr(self.stats, field_name) + 1)
            updates[t.name] = TenantUpdate(
                t.name, frame, req.seq, tier, kind, sh.name,
                self._lane_snapshots(host, t.lane, t.ns_base))
            if t.frames_applied - t.ckpt_frame >= self.cfg.checkpoint_every:
                self._checkpoint(t)

    def _dispatch(self, device, tier: ServiceTier, banks, zb: np.ndarray,
                  vb: np.ndarray) -> FrameResult:
        """One fused step of ``tier`` over a shard's stacked banks: zb
        and vb copied to ``device`` once, the step launched there."""
        zt = torch.from_numpy(zb).to(device)
        vt = torch.from_numpy(vb).to(device)
        with _on(device):
            return self._step_for(tier, device)(banks, zt, vt)

    def _step_for(self, tier: ServiceTier, device):
        cfg = self._tier_cfg[tier]
        _, _, step = _multi_step(self.model, cfg,
                                 self.cfg.lanes_per_shard, device)
        return step

    def _host_fields(self, res: FrameResult, lanes: np.ndarray):
        """The snapshot fields of a shard's result on the host, each
        copied once for the whole shard: (confirmed, and None when no
        lane in ``lanes`` has a confirmed track, else (ids, hits, age,
        states, mode probabilities or None))."""
        conf = res.confirmed.cpu().numpy()
        if not conf[lanes].any():
            return conf, None
        bank = res.bank
        xs = res.x_est if self.is_imm else bank.x
        return conf, (bank.track_id.cpu().numpy(), bank.hits.cpu().numpy(),
                      bank.age.cpu().numpy(), xs.cpu().numpy(),
                      res.mode_probs.cpu().numpy() if self.is_imm
                      else None)

    def _lane_snapshots(self, host, lane: int,
                        ns_base: int) -> List[TrackSnapshot]:
        conf, fields = host
        idx = np.nonzero(conf[lane])[0]
        if not len(idx):
            return []
        ids, hits, age, xs, mus = (None if f is None else f[lane]
                                   for f in fields)
        return [TrackSnapshot(ns_base + int(ids[i]), xs[i].copy(),
                              int(hits[i]), int(age[i]),
                              mus[i].copy() if mus is not None else None)
                for i in idx]

    # ----------------------------------------------------------- checkpoint
    def _checkpoint(self, t: _Tenant) -> None:
        sh = self.shards[t.shard]
        lane_bank = bank_lib.slice_sensor_bank(sh.banks, t.lane)
        try:
            t.ckpt.save(t.frames_applied, lane_bank,
                        extra=dict(tenant=t.name, frame=t.frames_applied,
                                   ns_base=t.ns_base,
                                   next_seq=t.next_seq),
                        blocking=True)
        except OSError as e:
            # keep the WAL — failover replays from the older snapshot
            warnings.warn(f"checkpoint for tenant {t.name!r} at frame "
                          f"{t.frames_applied} failed ({e!r}); WAL "
                          f"retained back to frame {t.ckpt_frame}",
                          RuntimeWarning, stacklevel=2)
            return
        t.ckpt_frame = t.frames_applied
        t.wal.clear()
        self.stats.checkpoints += 1

    # ------------------------------------------------------------- failover
    def _recover_dead(self, now: float) -> None:
        for name in self.monitor.dead_hosts():
            self._failover(self._shard(name))

    def _failover(self, sh: _Shard) -> None:
        """The dead shard's tenants restore onto survivors: checkpoint
        seeds the lane bitwise (mode-conditioned x/P/mu, lifecycle,
        ids), the WAL replays the frames applied since through the
        SURVIVING shard's own fused step (lanes are independent, so a
        scratch dispatch reproduces the lane bit for bit), and the
        tenant resumes where it left off — same track ids, same
        stream."""
        sh.alive = False
        self.stats.shards_lost += 1
        moved = self.alloc.tenants_on(sh.idx)
        for name in moved:
            self.alloc.release(name)
        self.alloc.drop_shard(sh.idx)
        self.monitor.remove(sh.name)
        self.stragglers.remove(sh.name)
        sh.banks = None
        for name in moved:
            t = self.tenants[name]
            loc = None
            alive = {s.idx for s in self.shards if s.alive}
            while True:
                loc = self.alloc.acquire(name)
                if loc is None or loc[0] in alive:
                    break
                self.alloc.release(name)
                self.alloc.drop_shard(loc[0])
            if loc is None:
                t.parked = True
                self.stats.parked += 1
                warnings.warn(f"tenant {name!r} parked: no surviving "
                              f"lane to restore onto", RuntimeWarning,
                              stacklevel=2)
                continue
            self._restore_tenant(t, *loc)
            self.stats.failovers += 1

    def _restore_tenant(self, t: _Tenant, s: int, lane: int) -> None:
        target = self.shards[s]
        dev = target.device
        one = self._ones[dev]
        state, extra = t.ckpt.restore_latest(like=one)
        if extra["frame"] + len(t.wal) != t.frames_applied:
            warnings.warn(
                f"tenant {t.name!r}: WAL covers frames "
                f"{extra['frame']}..{extra['frame'] + len(t.wal)} but "
                f"{t.frames_applied} were applied — resuming from the "
                f"checkpoint loses the difference", RuntimeWarning,
                stacklevel=2)
        L = self.cfg.lanes_per_shard
        scratch = bank_lib.place_sensor_bank(
            bank_lib.stack_sensor_banks(one, L), lane, state)
        M, m = self.tracker.max_meas, self.model.m
        for tier_i, z_row, v_row in t.wal:
            zb = np.zeros((L, M, m), np.float32)
            vb = np.zeros((L, M), bool)
            zb[lane], vb[lane] = z_row, v_row
            scratch = self._dispatch(dev, ServiceTier(tier_i), scratch, zb,
                                     vb).bank
        target.banks = bank_lib.place_sensor_bank(
            target.banks, lane, bank_lib.slice_sensor_bank(scratch, lane))
        t.shard, t.lane, t.parked = s, lane, False
        # re-snapshot on the new shard so the next failover doesn't
        # replay this WAL again on top of the old checkpoint
        self._checkpoint(t)
