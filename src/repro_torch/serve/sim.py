"""Open-loop multi-tenant LLM serving on the system model.

This is the paper's case-study methodology (drive a realistic workload
through the simulator, read end-to-end latency under contention) pointed
at the serving workload the ROADMAP names: open-loop arrival traces feed
per-tenant continuous-batching servers whose prefill/decode compute runs
on :class:`~repro.core.chip.TensorCore` components and whose per-layer
collectives go through the pluggable fabric — so two tenants sharing a
pod contend on real links under ``fabric="event"``, and fault plans from
``docs/faults.md`` degrade tail latency observably.

Nothing here calls JAX: `repro.serve.engine` is the *functional* model
(real decode steps, exactness oracle); this module is the *timing* model
(simulator events sized from the model config).  Both implement Orca
continuous batching: admission waits on free KV-cache slots, iterations
batch every active request, slots release on completion.

Determinism: arrival traces, prompt/decode lengths and all component
logic are seeded and integer-timed, so ``ServeReport.summary()`` is
bit-identical across every scheduler x executor combination — the same
contract the rest of the engine holds (`tests/test_executor.py`).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import typing

import numpy as np

from ..core.chip import ComputeJob, HbmController, TensorCore
from ..core.component import Component
from ..core.connection import Connection, Request
from ..core.engine import Engine
from ..core.event import Event
from ..core.hooks import FaultInjector, MetricsHook
from ..core.hw import SystemSpec, ps_to_s, s_to_ps
from ..core.system import CollectiveCoordinator, StarConnection
from ..models.base import ModelConfig


# ---------------------------------------------------------------------------
# Arrival-trace generators (open loop: arrivals don't wait for completions)
# ---------------------------------------------------------------------------

def poisson_trace(rate_rps: float, duration_s: float, seed: int) -> np.ndarray:
    """Homogeneous Poisson arrivals: exponential inter-arrival times."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate_rps)
        if t >= duration_s:
            return np.asarray(out)
        out.append(t)


def bursty_trace(rate_rps: float, duration_s: float, seed: int,
                 burst_factor: float = 4.0, dwell_s: float = None) -> np.ndarray:
    """Two-state MMPP: a calm state at ``rate/burst_factor`` and a burst
    state at ``rate*burst_factor``, with exponential dwell times.  Mean
    rate stays near ``rate_rps`` (equal expected dwell in each state)."""
    rng = np.random.default_rng(seed)
    dwell = dwell_s if dwell_s is not None else max(duration_s / 8.0, 1e-6)
    rates = (rate_rps / burst_factor, rate_rps * burst_factor)
    state, t, next_switch = 0, 0.0, rng.exponential(dwell)
    out = []
    while t < duration_s:
        dt = rng.exponential(1.0 / rates[state])
        if t + dt >= next_switch:
            t = next_switch
            next_switch = t + rng.exponential(dwell)
            state = 1 - state
            continue
        t += dt
        if t >= duration_s:
            break
        out.append(t)
    return np.asarray(out)


def diurnal_trace(rate_rps: float, duration_s: float, seed: int,
                  depth: float = 0.8, period_s: float = None) -> np.ndarray:
    """Sinusoidally modulated Poisson process via thinning: instantaneous
    rate ``rate*(1 + depth*sin)``, peak-rate candidates kept with
    probability lambda(t)/lambda_max.  Models the day/night swing of an
    open user population."""
    rng = np.random.default_rng(seed)
    period = period_s if period_s is not None else duration_s
    lam_max = rate_rps * (1.0 + depth)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= duration_s:
            return np.asarray(out)
        lam = rate_rps * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.uniform() * lam_max < lam:
            out.append(t)


GENERATORS: typing.Dict[str, typing.Callable] = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
}


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One user request: arrival stamp plus pre-drawn lengths (the eos
    position is drawn up front so timing never depends on token values)."""
    uid: int
    arrival_ps: int
    prompt_len: int
    decode_len: int          # decode iterations until eos/completion (>= 1)


def make_requests(times_s: np.ndarray, seed: int,
                  prompt_range: typing.Tuple[int, int] = (16, 64),
                  decode_range: typing.Tuple[int, int] = (4, 12),
                  ) -> typing.Tuple[ServeRequest, ...]:
    """Attach seeded prompt/decode lengths to an arrival trace."""
    rng = np.random.default_rng(seed)
    n = len(times_s)
    prompts = rng.integers(prompt_range[0], prompt_range[1] + 1, size=n)
    decodes = rng.integers(decode_range[0], decode_range[1] + 1, size=n)
    return tuple(
        ServeRequest(uid=i, arrival_ps=s_to_ps(float(t)),
                     prompt_len=int(p), decode_len=int(d))
        for i, (t, p, d) in enumerate(zip(times_s, prompts, decodes)))


# ---------------------------------------------------------------------------
# Scenario description + collective/compute sizing from the model config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a model served tensor-parallel over ``devices`` with
    ``slots`` KV-cache slots and an open-loop request trace."""
    name: str
    devices: typing.Tuple[int, ...]
    model: ModelConfig
    slots: int
    requests: typing.Tuple[ServeRequest, ...]
    coll_ops: int = 4        # decode allreduces per iteration (layer groups)


@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """``spares``: reserved chips owned by no tenant.  They idle in the
    HealthMonitor's shared pool; on a ``chip_dead`` verdict the lowest
    free spare is claimed for the victim's tenant, and a rejoin of the
    original chip returns it."""
    name: str
    tenants: typing.Tuple[TenantSpec, ...]
    spares: typing.Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Failure-detection and recovery knobs for :func:`run_serving`.

    * ``max_retries`` -- recovery requeues a request may survive before
      it is dropped (SLO miss);
    * ``backoff_base_s`` -- requeue delay after an abort, doubled per
      retry (exponential backoff gives the detector time to fence the
      dead chip before the retry lands on it again);
    * ``backoff_max_s`` -- cap on the exponential backoff.  Without it
      ``backoff_base_s * 2**(n-1)`` is unbounded and a handful of
      strikes push a retry past any plausible trace horizon; the cap
      keeps high-retry requests landing (``None`` disables);
    * ``heartbeat_s`` -- gossip heartbeat period for chips and their
      tenant server (0 disables gossip; detection then rides
      collective timeouts alone, so a tenant with no collectives in
      flight has no detector);
    * ``suspect_threshold`` -- consecutive missed heartbeat rounds
      before a peer files a strike against the silent chip;
    * ``quorum`` -- distinct accusers required before the
      :class:`HealthMonitor` declares a suspect dead.  ``None`` derives
      a majority of the suspect's live same-tenant peers (minimum 1).
      Raising it above the reachable accuser count makes a
      partitioned-but-alive chip explicitly representable: one
      accuser's evidence is never enough to fence it;
    * ``migrate_chunk_bytes`` -- per-chip payload of one KV-migration
      all-to-all (fixed so migration plans are enumerable up front for
      the bounded scheduler's strict-window guard).
    """
    max_retries: int = 3
    backoff_base_s: float = 3e-4
    backoff_max_s: typing.Optional[float] = 2e-3
    heartbeat_s: float = 5e-4
    suspect_threshold: int = 3
    quorum: typing.Optional[int] = None
    migrate_chunk_bytes: int = 1 << 20

    def backoff_ps(self, n: int) -> int:
        """Requeue delay (integer ps) for the ``n``-th retry: capped
        exponential ``backoff_base_s * 2**(n-1)``."""
        delay = self.backoff_base_s * (2 ** (max(1, n) - 1))
        if self.backoff_max_s is not None:
            delay = min(delay, self.backoff_max_s)
        return s_to_ps(delay)


class ServeSizing:
    """Deterministic op sizing for one tenant.  Flops/bytes are roofline
    inputs for :class:`TensorCore`; collective payloads are exact ints so
    the byte counts noted to the fabric up front match the issued joins
    bit-for-bit (the event fabric's planned-edge guard requires it).

    ``tp`` overrides the tensor-parallel degree (default: the tenant's
    full device count) -- a re-meshed degraded group serves with ``tp``
    equal to the surviving member count, so per-chip flops/bytes grow
    while the collective payloads (activation rows, tp-independent) stay
    bit-equal to the plans noted up front."""

    def __init__(self, tenant: TenantSpec, tp: int = None) -> None:
        m = tenant.model
        self.tp = max(1, len(tenant.devices) if tp is None else tp)
        d_ff = m.d_ff if m.d_ff else 4 * m.d_model
        layers = max(1, m.num_layers)
        self.params = (layers * (4 * m.d_model * m.d_model
                                 + 2 * m.d_model * d_ff)
                       + m.vocab_size * m.d_model)
        self.param_bytes = 2.0 * self.params          # bf16 weights
        self.d_model = m.d_model
        self.layers = layers
        # K + V, bf16, per committed context token, whole model (the
        # mesh-wide footprint; a tp shard holds 1/tp of it)
        self.kv_token_bytes = 2 * 2 * m.d_model * layers
        self.coll_ops = max(1, min(tenant.coll_ops, layers))
        self.layers_per_op = max(1, layers // self.coll_ops)
        self.moe = m.family == "moe" and m.num_experts > 1
        self.ept = max(1, m.experts_per_token)

    # compute (per device; tensor-parallel shards weights 1/tp)
    def prefill_flops(self, prompt_len: int) -> float:
        return 2.0 * self.params * prompt_len / self.tp

    def prefill_hbm(self, prompt_len: int) -> float:
        return self.param_bytes / self.tp

    def decode_flops(self, batch: int) -> float:
        return 2.0 * self.params * batch / self.tp

    def decode_hbm(self, batch: int) -> float:
        # weight-streaming bound + a token of KV per active request
        return self.param_bytes / self.tp + 2.0 * batch * self.d_model

    # collectives (exact ints; one activation row per active request)
    def ar_bytes(self, batch: int) -> int:
        return int(batch) * self.d_model * 2 * self.layers_per_op

    def a2a_bytes(self, batch: int) -> int:
        return int(batch) * self.d_model * 2 * self.ept

    def kv_bytes(self, tokens: int) -> int:
        """Mesh-wide KV-cache footprint of ``tokens`` committed context
        tokens (exact int: migration transfers are sized from it)."""
        return int(tokens) * self.kv_token_bytes


# ---------------------------------------------------------------------------
# Slot ledger: KV-cache capacity as pure, property-testable accounting
# ---------------------------------------------------------------------------

class SlotLedger:
    """KV-cache slots as schedulable capacity.  Pure bookkeeping (no
    engine dependency) so hypothesis can drive random admit/release
    interleavings against the invariants: occupancy never exceeds
    capacity, no uid is lost or double-completed, lowest free slot wins
    (deterministic placement)."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.free: typing.List[int] = list(range(capacity))
        self.active: typing.Dict[int, int] = {}      # slot -> uid
        self.seated: typing.Dict[int, int] = {}      # uid -> slot
        self.completed: set = set()
        self.peak = 0

    @property
    def in_use(self) -> int:
        return len(self.active)

    def has_free(self) -> bool:
        return bool(self.free)

    def admit(self, uid: int) -> int:
        if uid in self.seated:
            raise ValueError(f"uid {uid} already seated")
        if uid in self.completed:
            raise ValueError(f"uid {uid} already completed")
        if not self.free:
            raise RuntimeError("admit with no free slot")
        slot = self.free.pop(0)                       # lowest slot first
        self.active[slot] = uid
        self.seated[uid] = slot
        self.peak = max(self.peak, len(self.active))
        return slot

    def release(self, uid: int) -> int:
        if uid in self.completed:
            raise ValueError(f"uid {uid} double-completed")
        slot = self.seated.pop(uid, None)
        if slot is None:
            raise ValueError(f"uid {uid} not seated")
        del self.active[slot]
        self.completed.add(uid)
        bisect.insort(self.free, slot)
        return slot

    def evict(self, uid: int) -> int:
        """Reclaim a seat *without* retiring the uid: the request's KV
        state is lost (its mesh died mid-iteration) but the request is
        not done -- unlike :meth:`release` it may be admitted again
        later (the recovery requeue path)."""
        if uid in self.completed:
            raise ValueError(f"uid {uid} already completed")
        slot = self.seated.pop(uid, None)
        if slot is None:
            raise ValueError(f"uid {uid} not seated")
        del self.active[slot]
        bisect.insort(self.free, slot)
        return slot


class _ReqLog:
    """Mutable per-request timing record (all integer picoseconds, so
    queue + prefill + decode == end-to-end exactly, no float residue).
    ``retries`` counts recovery requeues; ``ckpt_tokens`` is the
    committed context whose KV survives on (or was migrated to) the
    mesh named by ``ckpt_group`` -- a re-admitted request only
    recomputes prefill for the context beyond its checkpoint and
    resumes decode at ``remaining``; the group lets a later membership
    loss reconcile checkpoints of requests that are *not seated* at
    verdict time (queued or in backoff); ``dropped_ps`` stamps the SLO
    drop when ``max_retries`` is exceeded."""
    __slots__ = ("uid", "arrival_ps", "prompt_len", "decode_len",
                 "admit_ps", "first_ps", "done_ps", "remaining",
                 "retries", "dropped_ps", "ckpt_tokens", "ckpt_group")

    def __init__(self, req: ServeRequest) -> None:
        self.uid = req.uid
        self.arrival_ps = req.arrival_ps
        self.prompt_len = req.prompt_len
        self.decode_len = req.decode_len
        self.admit_ps = None
        self.first_ps = None
        self.done_ps = None
        self.remaining = req.decode_len
        self.retries = 0
        self.dropped_ps = None
        self.ckpt_tokens = 0
        self.ckpt_group: tuple = ()   # mesh the checkpoint is sharded over

    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        for k, v in state.items():
            setattr(self, k, v)


# ---------------------------------------------------------------------------
# Components: per-chip serving program + per-tenant batching server
# ---------------------------------------------------------------------------

class ServeProgram(Component):
    """One chip's slice of a tenant: executes the iteration's op list
    (prefill/decode compute on its TensorCore, collective joins through
    the coordinator star) and reports phase completion to its tenant
    server.  Mirrors DeviceProgram's issue/wait loop, but the "trace" is
    re-sent every iteration by the server (DP-3: only connections carry
    cross-component traffic).

    With a recovery policy the program also gossips: every
    ``heartbeat_ps`` it announces a ``beat`` on its control star (the
    server relays it to the other members as ``peer_beat``), judges its
    peers' beats, and files a ``strike`` with the HealthMonitor against
    any peer silent for ``suspect_threshold`` consecutive rounds --
    peer-reported evidence, not an omniscient observer.  A program built
    with ``spare=True`` starts idle in the shared spare pool: it
    registers with the monitor only, and joins a tenant's mesh when the
    monitor sends ``claim`` (a ``release`` from the server returns it to
    the pool)."""

    def __init__(self, name: str, device: int,
                 group: typing.Tuple[int, ...], spare: bool = False,
                 heartbeat_ps: int = 0, suspect_threshold: int = 3) -> None:
        super().__init__(name)
        self.device = device
        self.group = tuple(group)      # current serving mesh (re-formed
                                       # by each phase under recovery)
        self.spare = spare
        self.heartbeat_ps = heartbeat_ps
        self.suspect_threshold = suspect_threshold
        self.ops: tuple = ()
        self.pc = 0
        self.iter_id = -1
        self.phases_done = 0
        # gossip state: which control port talks to my server (spares
        # have one per tenant, "ctrl0".."ctrlN", bound at claim time)
        self._ctrl: typing.Optional[str] = None if spare else "ctrl"
        self._beat_gen = 0             # invalidates stale beat timers
        self._heard: set = set()       # peers heard since my last round
        self._miss: typing.Dict[int, int] = {}
        self._accused: set = set()

    def start(self) -> None:
        self.schedule("hello")

    def handle(self, event: Event) -> None:
        if event.kind == "hello":
            if self.spare:
                self._enlist("register_spare")
            else:
                self._register()
            return
        if event.kind == "fault_wake":
            # The FaultInjector's scheduled wake.  A "fail" froze this
            # program before handle ran; reaching here means the action
            # just applied was a recover -- drop any pre-failure phase
            # state and announce ourselves again (rolling-restart
            # rejoin: the server re-admits the device into its mesh; a
            # recovered spare returns to the pool).
            self.ops = ()
            self.pc = 0
            if self.spare and self._ctrl is None:
                self._enlist("register_spare")
            elif self._ctrl is not None:
                self._register()
            return
        if event.kind == "beat":
            if event.payload == self._beat_gen:
                self._beat_round()
            return
        if event.kind != "request":
            return
        req = event.payload
        if req.kind == "phase":
            self.iter_id, self.ops, self.group = req.payload
            self.pc = 0
            # mesh re-formed: judge only current peers, fresh slate
            self._miss = {d: 0 for d in self.group if d != self.device}
            self._accused &= set(self._miss)
            self._issue()
        elif req.kind == "compute_done":
            if req.payload != (self.iter_id, self.pc):
                return      # job from an aborted iteration; core time
                            # was burned but the phase moved on
            self.pc += 1
            self._issue()
        elif req.kind == "collective_done":
            if not self._expects_coll(req.payload):
                return      # completion of a pre-abort collective
            self.pc += 1
            self._issue()
        elif req.kind == "collective_timeout":
            if not self._expects_coll(req.payload):
                return      # a pre-abort collective timing out late
            self.ops = ()
            self.pc = 0
            self._ctrl_port().send(Request(
                src=self._ctrl_port(), dst=None, kind="phase_failed",
                payload=self.iter_id))
        elif req.kind == "peer_beat":
            self._heard.add(req.payload)
            self._miss[req.payload] = 0
            self._accused.discard(req.payload)
        elif req.kind == "stop_beat":
            self._beat_gen += 1        # tenant drained: stop gossiping
        elif req.kind == "claim":
            # the monitor re-places a dead chip's capacity onto me
            self._ctrl = f"ctrl{req.payload}"
            self.group = ()
            self.iter_id = -1      # stale completions must mismatch
            self._register()
        elif req.kind == "release":
            # rolled back to the pool (the original chip rejoined)
            self._beat_gen += 1
            self._ctrl = None
            self.ops = ()
            self.pc = 0
            self.group = ()
            self.iter_id = -1      # drop any in-flight phase's tokens
            self._enlist("spare_free")

    def _ctrl_port(self):
        return self.port(self._ctrl)

    def _enlist(self, kind: str) -> None:
        health = self.ports.get("health")
        if health is not None and health.connection is not None:
            health.send(Request(
                src=health, dst=None, kind=kind,
                payload=(self.device, self)))

    def _register(self) -> None:
        # Register with the tenant server (spoke->hub auto-routes); the
        # reference rides the payload like coordinator joins do,
        # surviving the procs executor as a rank.  With a HealthMonitor
        # wired, also enlist with the failure detector and start the
        # gossip heartbeat.
        self._ctrl_port().send(Request(
            src=self._ctrl_port(), dst=None, kind="register",
            payload=(self.device, self)))
        self._enlist("register_chip")
        self._miss = {}
        self._heard = set()
        self._accused = set()
        if self.heartbeat_ps:
            self._beat_gen += 1
            self.schedule("beat", self.heartbeat_ps,
                          payload=self._beat_gen)

    def _beat_round(self) -> None:
        """One gossip round: judge the peers of my current mesh against
        the beats heard since the last round, strike the silent ones,
        announce my own beat, rearm."""
        health = self.ports.get("health")
        for peer in self.group:
            if peer == self.device:
                continue
            if peer in self._heard:
                continue
            misses = self._miss.get(peer, 0) + 1
            self._miss[peer] = misses
            if (misses >= self.suspect_threshold
                    and peer not in self._accused
                    and health is not None
                    and health.connection is not None):
                self._accused.add(peer)
                health.send(Request(
                    src=health, dst=None, kind="strike",
                    payload=(peer, self.device)))
        self._heard = set()
        self._ctrl_port().send(Request(
            src=self._ctrl_port(), dst=None, kind="beat",
            payload=self.device))
        self.schedule("beat", self.heartbeat_ps, payload=self._beat_gen)

    def _expects_coll(self, key) -> bool:
        """Is this coordinator notification for the collective the
        current op list is waiting on?  Collective names embed the
        server's monotone iteration id, so any notification for an
        aborted iteration's ops mismatches."""
        if self.pc >= len(self.ops):
            return False
        op = self.ops[self.pc]
        return op[0] == "coll" and key is not None and key[0] == op[1]

    def _issue(self) -> None:
        if self.pc >= len(self.ops):
            self.phases_done += 1
            self._ctrl_port().send(Request(
                src=self._ctrl_port(), dst=None, kind="phase_done",
                payload=self.iter_id))
            return
        op = self.ops[self.pc]
        if op[0] == "compute":
            _, tag, flops, hbm_bytes = op
            self.port("core").send(Request(
                src=self.port("core"), dst=None, kind="job",
                payload=ComputeJob(flops=flops, hbm_bytes=hbm_bytes,
                                   tag=tag, reply_to=self,
                                   token=(self.iter_id, self.pc))))
        else:  # ("coll", name, kind, nbytes)
            _, name, kind, nbytes = op
            self.port("coll").send(Request(
                src=self.port("coll"), dst=None, kind="join",
                size_bytes=int(nbytes),
                payload=(name, 0, kind, float(nbytes), self.group,
                         self.device, self)))


class HealthMonitor(Component):
    """Quorum aggregator for peer-reported failure evidence, plus the
    spare-pool arbiter.  Unlike the PR-9 monitor it never probes: it
    only *counts accusers*.

    Evidence arrives as:

    * ``strike`` -- gossip verdicts from chips (accuser = device id) and
      tenant servers (accuser = ``-1 - tid``; the server's own judgment
      is what detects deaths on single-chip tenants, where no peer
      exists to gossip);
    * ``timeout_report`` from the coordinator (key + joined roster):
      every member that *did* join a timed-out collective is treated as
      an accuser of every member that did not -- the roster is exactly
      the peers' testimony.

    A suspect is declared dead only when its distinct accusers reach the
    quorum (``RecoveryPolicy.quorum``, default: majority of its live
    same-tenant peers, minimum 1).  Below quorum the suspect keeps its
    seat -- a partitioned-but-alive chip is representable: one accuser's
    evidence never fences it.  A fully-joined timed-out collective has
    no suspects at all and is reported to the owning server as
    ``coll_failed`` (a fabric stall: retry, blame no chip).

    On a death verdict the monitor also arbitrates the shared spare
    pool: the lowest free spare is claimed for the victim's tenant (the
    ``chip_dead`` verdict carries it), and a ``spare_free`` from a
    released spare returns it.  Everything is ordinary events on the
    health star, so detection latency is simulated and the protocol
    stays bit-identical across schedulers and executors."""

    def __init__(self, name: str,
                 tenants: typing.Tuple[typing.Tuple[int, typing.Tuple[int, ...]], ...],
                 policy: RecoveryPolicy,
                 spares: typing.Tuple[int, ...] = ()) -> None:
        super().__init__(name)
        self.policy = policy
        self.tenant_of = {d: tid for tid, devs in tenants for d in devs}
        self.chips: typing.Dict[int, object] = {}      # device -> program
        self.servers: typing.Dict[int, object] = {}    # tenant id -> server
        self.spares: typing.Dict[int, object] = {}     # spare id -> program
        self.pool: typing.List[int] = []               # free spares (sorted)
        self.expected_spares = tuple(spares)
        self.dead: set = set()
        self.deaths = 0                                # monotone (rejoins
                                                       # shrink ``dead``)
        self.accusers: typing.Dict[int, set] = {}      # suspect -> accusers
        self.quiesced: set = set()                     # tenant ids drained

    def handle(self, event: Event) -> None:
        if event.kind != "request":
            return
        req = event.payload
        if req.kind == "register_chip":
            device, prog = req.payload
            self.chips[device] = prog
            self.dead.discard(device)        # rolling-restart rejoin
            self.accusers.pop(device, None)  # old evidence is stale
        elif req.kind == "register_spare":
            device, prog = req.payload
            self.spares[device] = prog
            self.dead.discard(device)
            self.accusers.pop(device, None)
            if device not in self.pool and device not in self.tenant_of:
                bisect.insort(self.pool, device)
        elif req.kind == "register_server":
            tid, server = req.payload
            self.servers[tid] = server
        elif req.kind == "strike":
            suspect, accuser = req.payload
            self._accuse(suspect, (accuser,))
        elif req.kind == "timeout_report":
            key, joined = req.payload
            self._on_timeout(key, joined)
        elif req.kind == "spare_free":
            device, _prog = req.payload
            self.tenant_of.pop(device, None)
            self.accusers.pop(device, None)
            if device not in self.pool and device not in self.dead:
                bisect.insort(self.pool, device)
        elif req.kind == "quiesce":
            self.quiesced.add(req.payload)

    # -- evidence aggregation ----------------------------------------------
    def _quorum_for(self, suspect: int) -> int:
        if self.policy.quorum is not None:
            return max(1, self.policy.quorum)
        tid = self.tenant_of.get(suspect)
        peers = sum(1 for d, t in self.tenant_of.items()
                    if t == tid and d != suspect and d not in self.dead
                    and d in self.chips)
        return max(1, (peers + 1) // 2)

    def _accuse(self, suspect: int, accusers) -> None:
        if suspect in self.dead or suspect not in self.tenant_of:
            return
        acc = self.accusers.setdefault(suspect, set())
        acc.update(accusers)
        if len(acc) >= self._quorum_for(suspect):
            self._declare_dead(suspect)

    def _on_timeout(self, key, joined) -> None:
        group = key[2]
        joined_set = set(joined)
        suspects = [d for d in group
                    if d not in joined_set and d not in self.dead]
        if not suspects:
            # Fully joined but the transfer never completed: a fabric
            # stall, not a chip death.  Nobody to fence; the owning
            # server aborts and retries through backoff.
            tid = self.tenant_of.get(group[0])
            server = self.servers.get(tid)
            if server is not None:
                hub = self.port("hub")
                hub.send(Request(src=hub, dst=server, kind="coll_failed",
                                 payload=key))
            return
        witnesses = sorted(joined_set)
        for device in suspects:
            self._accuse(device, witnesses)

    def _declare_dead(self, device: int) -> None:
        if device in self.dead:
            return
        self.dead.add(device)
        self.deaths += 1
        self.accusers.pop(device, None)
        tid = self.tenant_of.get(device)
        server = self.servers.get(tid)
        spare = None
        if self.pool:
            # re-place the lost capacity: claim the lowest free spare
            # for the victim's tenant
            spare = self.pool.pop(0)
            self.tenant_of[spare] = tid
            self.chips[spare] = self.spares[spare]
            hub = self.port("hub")
            hub.send(Request(src=hub, dst=self.spares[spare],
                             kind="claim", payload=tid))
        if server is not None:
            hub = self.port("hub")
            hub.send(Request(src=hub, dst=server, kind="chip_dead",
                             payload=(device, spare)))


class TenantServer(Component):
    """Per-tenant continuous-batching scheduler (the Orca loop as
    simulator events).  Each iteration: admit queued requests into free
    KV slots, broadcast one op list (new prefills + one batched decode +
    its collectives) to every member chip, wait for all phase_done
    replies, then retire finished requests and start the next iteration.
    Open loop: arrivals are pre-scheduled self-events from the trace and
    never wait on completions.

    With a :class:`RecoveryPolicy` the server also *serves through*
    faults: a ``chip_dead`` verdict (or a ``phase_failed`` from its own
    chips) aborts the in-flight iteration, evicts every seated request,
    migrates the KV shards that survive on live chips to the re-formed
    mesh (a priced fabric transfer; only shards lost with the dead chip
    are recomputed at re-admission), requeues each with capped
    exponential backoff -- or drops it past ``max_retries`` -- and
    re-forms the serving group from the surviving members plus any
    spare the monitor claimed for it.  A dead device registering again
    rejoins the mesh (returning a claimed spare to the pool); seated
    requests are resharded (evicted + immediately requeued, no retry
    penalty, full KV migrated) before the first iteration on the new
    group.  The server also takes part in gossip detection: it relays
    member beats and files its own strikes (the only accuser a
    single-chip tenant has)."""

    def __init__(self, name: str, tenant: TenantSpec, tid: int = 0,
                 policy: RecoveryPolicy = None) -> None:
        super().__init__(name)
        self.tenant = tenant
        self.tid = tid
        self.policy = policy
        self.sizing = ServeSizing(tenant)
        self._sizings: typing.Dict[int, ServeSizing] = {
            len(tenant.devices): self.sizing}
        self.ledger = SlotLedger(tenant.slots)
        self.members: typing.Dict[int, object] = {}    # device -> program
        self.queue: typing.List[int] = []              # waiting uids (FIFO)
        self.recs: typing.Dict[int, _ReqLog] = {
            r.uid: _ReqLog(r) for r in tenant.requests}
        self.completed_order: typing.List[int] = []
        self.iter_id = -1
        self.iterations = 0
        self._phase_replies = 0
        self._newly: typing.List[int] = []
        # -- recovery state -------------------------------------------------
        self.dead: set = set()               # fenced original devices
        self.retries = 0                     # recovery requeues issued
        self.drops: typing.List[int] = []    # uids dropped past max_retries
        self.recoveries = 0                  # outage windows closed
        self.rejoins = 0                     # dead devices re-registered
        self.outages: typing.List[typing.Tuple[int, int]] = []
        self._outage_start: typing.Optional[int] = None
        self._serving_group: tuple = ()      # mesh the seated KV lives on
        self._resolved = 0                   # done + dropped requests
        self._quiesced = False
        self._abort_stamp: typing.Optional[int] = None
        # -- spare pool -----------------------------------------------------
        self.claimed: set = set()            # spares serving this tenant
        self._pending_spare: set = set()     # claimed, not yet registered
        self._release_on_register: set = set()
        self._release_pending = False
        self.spare_claims = 0
        self.spare_returns = 0
        # -- KV migration ---------------------------------------------------
        self.migrated_bytes = 0
        self.prefill_saved_tokens = 0
        self.prefill_recompute_tokens = 0
        self._mig_pending = 0                # KV bytes awaiting transfer
        # -- gossip (server-side judge + relay) -----------------------------
        self._beat_heard: set = set()
        self._beat_miss: typing.Dict[int, int] = {}
        self._beat_accused: set = set()
        self._ticking = False
        # -- capacity trace for effective availability ----------------------
        # armed once the mesh first fills: startup registration latency
        # is not a capacity dip
        self._cap_log: typing.List[typing.Tuple[int, int]] = [
            (0, len(tenant.devices))]
        self._cap_armed = False

    def start(self) -> None:
        for r in self.tenant.requests:
            self.schedule("arrival", r.arrival_ps, payload=r.uid)
        health = self.ports.get("health")
        if health is not None and health.connection is not None:
            health.send(Request(
                src=health, dst=None, kind="register_server",
                payload=(self.tid, self)))
        self._maybe_start_tick()
        self._maybe_quiesce()   # a tenant with an empty trace is done

    def handle(self, event: Event) -> None:
        if event.kind == "arrival":
            self.queue.append(event.payload)
            self._maybe_iterate()
        elif event.kind == "requeue":
            uid = event.payload
            rec = self.recs[uid]
            if (rec.done_ps is None and rec.dropped_ps is None
                    and uid not in self.ledger.seated):
                self.queue.append(uid)
            self._maybe_iterate()
        elif event.kind == "beat_tick":
            self._beat_tick()
        elif event.kind == "request":
            req = event.payload
            if req.kind == "register":
                self._on_register(*req.payload)
            elif req.kind == "beat":
                self._on_beat(req.payload)
            elif req.kind == "phase_done":
                if req.payload != self.iter_id or not self._phase_replies:
                    return                       # reply from an aborted phase
                self._phase_replies -= 1
                if self._phase_replies == 0:
                    self._finish_iteration()
            elif req.kind == "phase_failed":
                if (self.policy is None or req.payload != self.iter_id
                        or not self._phase_replies):
                    return
                self._abort_iteration()
            elif req.kind == "coll_failed":
                # fully-joined collective died in the fabric: retry
                if self.policy is not None and self._phase_replies:
                    self._abort_iteration()
            elif req.kind == "chip_dead":
                self._on_chip_dead(*req.payload)

    # -- membership --------------------------------------------------------
    def _on_register(self, device: int, prog) -> None:
        if device in self._release_on_register:
            # claimed while its original was already rejoining: bounce
            # the spare straight back to the pool, never a member
            self._release_on_register.discard(device)
            self.spare_returns += 1
            self.port("ctrl").send(Request(
                src=self.port("ctrl"), dst=prog, kind="release"))
            return
        if device in self.dead:                  # rolling-restart rejoin
            self.dead.discard(device)
            self.rejoins += 1
            # capacity is back: return a spare -- but never mid-phase
            # (the in-flight phase still needs its phase_done)
            if self._phase_replies:
                self._release_pending = True
            else:
                self._release_one_spare()
        elif device in self._pending_spare:
            self._pending_spare.discard(device)
            self.claimed.add(device)
        elif (device not in self.tenant.devices
              and device not in self.claimed):
            self.claimed.add(device)             # recovered spare rejoining
        self.members[device] = prog
        self._beat_miss[device] = 0
        self._beat_accused.discard(device)
        self._log_cap()
        self._maybe_start_tick()
        self._maybe_iterate()

    def _release_one_spare(self) -> None:
        """The original chip rejoined: hand the highest claimed spare
        back to the shared pool (lowest spares stay claimed longest, the
        mirror image of the claim order)."""
        if self.claimed:
            sp = max(self.claimed)
            self.claimed.discard(sp)
            prog = self.members.pop(sp, None)
            self._beat_miss.pop(sp, None)
            self._beat_accused.discard(sp)
            self.spare_returns += 1
            if prog is not None:
                self.port("ctrl").send(Request(
                    src=self.port("ctrl"), dst=prog, kind="release"))
            self._log_cap()
        elif self._pending_spare:
            sp = max(self._pending_spare)
            self._pending_spare.discard(sp)
            self._release_on_register.add(sp)

    # -- recovery ----------------------------------------------------------
    def _on_chip_dead(self, device: int, spare=None) -> None:
        if self.policy is None or device in self.dead:
            return
        if device in self.claimed:
            self.claimed.discard(device)         # a claimed spare died
        elif device in self._pending_spare:
            self._pending_spare.discard(device)
        elif device in self.tenant.devices:
            self.dead.add(device)
        else:
            return                               # stale / unknown verdict
        self.members.pop(device, None)
        self._beat_miss.pop(device, None)
        self._beat_accused.discard(device)
        if spare is not None:
            self._pending_spare.add(spare)
            self.spare_claims += 1
        self._log_cap()
        self._reconcile_unseated()
        if self._phase_replies or self.ledger.in_use:
            # in-flight iteration and/or seated KV sharded over a mesh
            # that just lost a member: abort, reclaim, requeue
            self._abort_iteration()
        else:
            self._maybe_iterate()

    # -- gossip relay + server-side judge ----------------------------------
    def _on_beat(self, device: int) -> None:
        self._beat_heard.add(device)
        self._beat_miss[device] = 0
        self._beat_accused.discard(device)
        ctrl = self.port("ctrl")
        for other, prog in sorted(self.members.items()):
            if other != device:
                ctrl.send(Request(src=ctrl, dst=prog, kind="peer_beat",
                                  payload=device))

    def _maybe_start_tick(self) -> None:
        if (self._ticking or self._quiesced or not self.members
                or self.policy is None or not self.policy.heartbeat_s):
            return
        self._ticking = True
        self.schedule("beat_tick", s_to_ps(self.policy.heartbeat_s))

    def _beat_tick(self) -> None:
        if self._quiesced or not self.members:
            self._ticking = False      # drained or fully fenced: stop
            return
        health = self.ports.get("health")
        for d in sorted(set(self.members) | self._pending_spare):
            if d in self._beat_heard:
                continue
            misses = self._beat_miss.get(d, 0) + 1
            self._beat_miss[d] = misses
            if (misses >= self.policy.suspect_threshold
                    and d not in self._beat_accused
                    and health is not None
                    and health.connection is not None):
                self._beat_accused.add(d)
                health.send(Request(
                    src=health, dst=None, kind="strike",
                    payload=(d, -1 - self.tid)))
        self._beat_heard = set()
        self.schedule("beat_tick", s_to_ps(self.policy.heartbeat_s))

    def _log_cap(self) -> None:
        if not self._cap_armed:
            if len(self.members) >= len(self.tenant.devices):
                self._cap_armed = True   # seed entry already says full
            return
        self._cap_log.append((self.engine.now, len(self.members)))

    def _abort_iteration(self) -> None:
        now = self.engine.now
        if self._outage_start is None:
            self._outage_start = now
        self._phase_replies = 0
        self._newly = []
        # Idempotence: a second chip_dead verdict landing at the same
        # instant re-aborts seats the first abort's _maybe_iterate just
        # re-admitted -- those must not take a second retry penalty.
        penalize = self._abort_stamp != now
        if self._release_pending:
            self._release_pending = False
            self._release_one_spare()
        tp_old = max(1, len(self._serving_group))
        lost_devs = len(set(self._serving_group) - set(self.members))
        survivors = tuple(sorted(set(self._serving_group)
                                 & set(self.members)))
        front = []
        for uid in sorted(self.ledger.seated):
            self.ledger.evict(uid)
            rec = self.recs[uid]
            rec.admit_ps = None
            rec.first_ps = None
            # KV migration: shards on surviving chips move to the new
            # mesh; only the dead chip's shard of the committed context
            # is recomputed (ceil of the lost fraction).
            resident = rec.ckpt_tokens
            lost_tokens = (-(-resident * lost_devs // tp_old)
                           if resident else 0)
            saved = resident - lost_tokens
            dropped = False
            if penalize:
                rec.retries += 1
                if rec.retries > self.policy.max_retries:
                    rec.dropped_ps = now             # SLO drop
                    rec.ckpt_tokens = 0
                    dropped = True
                    self.drops.append(uid)
                    self._resolved += 1
                else:
                    self.retries += 1
                    self.schedule("requeue",
                                  self.policy.backoff_ps(rec.retries),
                                  payload=uid)
            else:
                front.append(uid)                    # no double penalty
            if dropped:
                continue             # a dropped seat's KV never moves
            rec.ckpt_tokens = saved
            rec.ckpt_group = survivors if saved > 0 else ()
            if saved > 0:
                self.prefill_saved_tokens += saved
                if lost_devs > 0:
                    self._mig_pending += (
                        self.sizing.kv_bytes(resident)
                        * (tp_old - lost_devs) // tp_old)
            if lost_tokens > 0:
                self.prefill_recompute_tokens += lost_tokens
        if front:
            self.queue[:0] = front
        if penalize:
            self._abort_stamp = now
        self._maybe_iterate()
        self._maybe_quiesce()

    def _reshard(self, group: tuple) -> None:
        """Membership changed under seated requests (a rejoin): their KV
        shards live on the old mesh, so evict and requeue them ahead of
        the FIFO queue -- no retry penalty, the reshard is planned and
        every shard survives, so the whole committed context migrates."""
        front = []
        for uid in sorted(self.ledger.seated):
            self.ledger.evict(uid)
            rec = self.recs[uid]
            rec.admit_ps = None
            rec.first_ps = None
            if rec.ckpt_tokens > 0:
                self.prefill_saved_tokens += rec.ckpt_tokens
                self._mig_pending += self.sizing.kv_bytes(rec.ckpt_tokens)
                rec.ckpt_group = group
            front.append(uid)
        self.queue[:0] = front

    def _reconcile_unseated(self) -> None:
        """Membership just shrank: requests holding a checkpoint while
        *not seated* (queued, or waiting out a requeue backoff) lose the
        dead chip's shard of it too.  Recompute the lost fraction, keep
        the survivors' share (priced as migration onto the next mesh),
        exactly as :meth:`_abort_iteration` does for seated requests --
        without this, a request aborted by ``coll_failed`` before the
        quorum verdict lands would resume on the new mesh with its full
        checkpoint for free."""
        members = set(self.members)
        for uid in sorted(self.recs):
            rec = self.recs[uid]
            if (rec.ckpt_tokens <= 0 or not rec.ckpt_group
                    or rec.done_ps is not None or rec.dropped_ps is not None
                    or uid in self.ledger.seated):
                continue
            grp = rec.ckpt_group
            lost = len(set(grp) - members)
            if lost == 0:
                continue
            tp, resident = len(grp), rec.ckpt_tokens
            lost_tokens = -(-resident * lost // tp)
            saved = resident - lost_tokens
            rec.ckpt_tokens = saved
            rec.ckpt_group = (tuple(sorted(set(grp) & members))
                              if saved > 0 else ())
            self.prefill_recompute_tokens += lost_tokens
            if saved > 0:
                self.prefill_saved_tokens += saved
                self._mig_pending += (
                    self.sizing.kv_bytes(resident) * (tp - lost) // tp)

    def _maybe_quiesce(self) -> None:
        if self._quiesced or self._resolved < len(self.recs):
            return
        health = self.ports.get("health")
        if health is not None and health.connection is not None:
            self._quiesced = True
            health.send(Request(
                src=health, dst=None, kind="quiesce", payload=self.tid))
            ctrl = self.port("ctrl")
            for d, prog in sorted(self.members.items()):
                ctrl.send(Request(src=ctrl, dst=prog, kind="stop_beat"))

    def _sizing_for(self, n: int) -> ServeSizing:
        s = self._sizings.get(n)
        if s is None:
            s = self._sizings[n] = ServeSizing(self.tenant, tp=n)
        return s

    # -- the Orca iteration ------------------------------------------------
    def _maybe_iterate(self) -> None:
        if self._phase_replies:                  # iteration in flight
            return
        expected = (len(self.tenant.devices) - len(self.dead)
                    + len(self.claimed) + len(self._pending_spare))
        if len(self.members) < expected or not self.members:
            return              # chips still registering, or all fenced
        group = tuple(sorted(self.members))
        if self.ledger.in_use and group != self._serving_group:
            self._reshard(group)
        admitted = []
        while self.queue and self.ledger.has_free():
            uid = self.queue.pop(0)
            self.ledger.admit(uid)
            rec = self.recs[uid]
            rec.admit_ps = self.engine.now
            if rec.ckpt_tokens:
                # any surviving shards were priced onto this mesh at
                # eviction/reconcile time; the checkpoint now lives here
                rec.ckpt_group = group
            admitted.append(uid)
        self._serving_group = group
        if not self.ledger.in_use:
            return                               # idle until next arrival
        self.iter_id += 1
        self.iterations += 1
        self._newly = admitted
        ops = self._build_ops(admitted, group)
        self._phase_replies = len(group)
        for d in group:
            self.port("ctrl").send(Request(
                src=self.port("ctrl"), dst=self.members[d], kind="phase",
                payload=(self.iter_id, ops, group)))

    def _build_ops(self, admitted: typing.List[int], group: tuple) -> tuple:
        s = self._sizing_for(len(group))
        it = self.iter_id
        ops = []
        if self._mig_pending:
            if len(group) > 1:
                # KV migration rides the serving fabric: fixed-size
                # all-to-all chunks (plan keys enumerable for bounded)
                chunk = self.policy.migrate_chunk_bytes
                nops = -(-self._mig_pending // (chunk * len(group)))
                for k in range(nops):
                    ops.append(("coll", f"{self.name}.i{it}.mig{k}",
                                "all-to-all", chunk))
                self.migrated_bytes += self._mig_pending
            # single survivor: shards are already local, nothing moves
            self._mig_pending = 0
        for uid in admitted:
            rec = self.recs[uid]
            # checkpointed prefill: only the context beyond the migrated
            # checkpoint is (re)computed; fresh requests have ckpt 0
            done = rec.decode_len - rec.remaining
            need = rec.prompt_len + done - rec.ckpt_tokens
            if need > 0:
                ops.append(("compute", f"{self.name}.i{it}.prefill{uid}",
                            s.prefill_flops(need), s.prefill_hbm(need)))
        batch = self.ledger.in_use
        ops.append(("compute", f"{self.name}.i{it}.decode",
                    s.decode_flops(batch), s.decode_hbm(batch)))
        if len(group) > 1:
            for k in range(s.coll_ops):
                ops.append(("coll", f"{self.name}.i{it}.ar{k}",
                            "all-reduce", s.ar_bytes(batch)))
            if s.moe:
                # MoE dispatch + combine: two a2a per iteration
                ops.append(("coll", f"{self.name}.i{it}.a2a0",
                            "all-to-all", s.a2a_bytes(batch)))
                ops.append(("coll", f"{self.name}.i{it}.a2a1",
                            "all-to-all", s.a2a_bytes(batch)))
        return tuple(ops)

    def _finish_iteration(self) -> None:
        now = self.engine.now
        for uid in self._newly:
            self.recs[uid].first_ps = now        # first token this iteration
        self._newly = []
        for slot, uid in sorted(self.ledger.active.items()):
            rec = self.recs[uid]
            rec.remaining -= 1
            if rec.remaining <= 0:               # pre-drawn eos reached
                rec.done_ps = now
                self.ledger.release(uid)
                self.completed_order.append(uid)
                self._resolved += 1
            else:
                # commit: this iteration's KV writes are durable shards
                rec.ckpt_tokens = (rec.prompt_len
                                   + (rec.decode_len - rec.remaining))
                rec.ckpt_group = self._serving_group
        if self._outage_start is not None:
            # a completed iteration on the re-formed mesh closes the
            # outage window -- the tenant is serving again
            self.outages.append((self._outage_start, now))
            self._outage_start = None
            self.recoveries += 1
        if self._release_pending:
            self._release_pending = False
            self._release_one_spare()
        self._maybe_iterate()
        self._maybe_quiesce()


# ---------------------------------------------------------------------------
# System assembly
# ---------------------------------------------------------------------------

class ServingSystem:
    """A machine wired for serving: shared coordinator + fabric, plus per
    tenant a :class:`TenantServer` on its own control star and per device
    a fresh TensorCore/HbmController/ServeProgram triple.  Chips are
    wired exactly like :class:`repro.core.system.System` (2-endpoint
    buses so request auto-routing holds); tenants share the fabric, which
    is where multi-tenant link contention comes from."""

    def __init__(self, scenario: ServingScenario, spec: SystemSpec,
                 scheduler=None, max_workers: int = 4, fabric=None,
                 executor=None, deadline_s: float = None,
                 recovery: RecoveryPolicy = None) -> None:
        from ..fabric import make_fabric   # late: fabric imports core modules
        seen: set = set()
        for t in scenario.tenants:
            if not t.devices:
                raise ValueError(f"tenant {t.name!r} has no devices")
            for d in t.devices:
                if not 0 <= d < spec.total_chips:
                    raise ValueError(
                        f"tenant {t.name!r} device {d} outside "
                        f"topology with {spec.total_chips} chips")
                if d in seen:
                    raise ValueError(
                        f"device {d} assigned to two tenants; tenant "
                        f"placements must be disjoint")
                seen.add(d)
        for d in scenario.spares:
            if not 0 <= d < spec.total_chips:
                raise ValueError(
                    f"spare device {d} outside topology with "
                    f"{spec.total_chips} chips")
            if d in seen:
                raise ValueError(
                    f"spare device {d} already assigned to a tenant")
            seen.add(d)
        if scenario.spares and recovery is None:
            raise ValueError("spares need a recovery policy (the "
                             "HealthMonitor arbitrates the pool)")
        self.scenario = scenario
        self.spec = spec
        self.policy = recovery
        self.engine = Engine(scheduler=scheduler, max_workers=max_workers,
                             executor=executor)
        self.fabric = make_fabric(fabric or spec.fabric, spec)
        self.coordinator = self.engine.register(
            CollectiveCoordinator("coordinator", deadline_s=deadline_s))
        self.fabric.install(self.engine, self.coordinator)
        coll_conn = self.engine.register(
            StarConnection("coll_fabric", self.coordinator.port("coll"),
                           latency_s=spec.ctrl_latency_s))
        self.monitor: typing.Optional[HealthMonitor] = None
        health_conn = None
        if recovery is not None:
            # Failure detector on its own control star; the coordinator
            # reports collective timeouts into it (key + joined roster).
            self.monitor = self.engine.register(HealthMonitor(
                "health.monitor",
                tenants=tuple((tid, t.devices)
                              for tid, t in enumerate(scenario.tenants)),
                policy=recovery,
                spares=scenario.spares))
            health_conn = self.engine.register(
                StarConnection("health.star", self.monitor.port("hub"),
                               latency_s=spec.ctrl_latency_s))
            health_conn.plug(self.coordinator.port("health"))
        self.servers: typing.List[TenantServer] = []
        self.programs: typing.List[ServeProgram] = []
        self.cores: typing.List[TensorCore] = []
        self.hbms: typing.List[HbmController] = []
        heartbeat_ps = (s_to_ps(recovery.heartbeat_s)
                        if recovery is not None and recovery.heartbeat_s
                        else 0)
        suspect = recovery.suspect_threshold if recovery is not None else 3
        ctrl_conns: typing.List[StarConnection] = []
        for tid, tenant in enumerate(scenario.tenants):
            server = self.engine.register(
                TenantServer(f"tenant{tid}.server", tenant, tid=tid,
                             policy=recovery))
            ctrl = self.engine.register(
                StarConnection(f"tenant{tid}.ctrl", server.port("ctrl"),
                               latency_s=spec.ctrl_latency_s))
            ctrl_conns.append(ctrl)
            if health_conn is not None:
                health_conn.plug(server.port("health"))
            for d in tenant.devices:
                core = self.engine.register(
                    TensorCore(f"chip{d}.core", spec.chip))
                hbm = self.engine.register(
                    HbmController(f"chip{d}.hbm", spec.chip))
                prog = self.engine.register(
                    ServeProgram(f"chip{d}.prog", d, tenant.devices,
                                 heartbeat_ps=heartbeat_ps,
                                 suspect_threshold=suspect))
                self.engine.register(Connection(f"chip{d}.bus")).plug(
                    prog.port("core")).plug(core.port("prog"))
                self.engine.register(Connection(f"chip{d}.membus")).plug(
                    core.port("hbm")).plug(hbm.port("cpu"))
                coll_conn.plug(prog.port("coll"))
                ctrl.plug(prog.port("ctrl"))
                if health_conn is not None:
                    health_conn.plug(prog.port("health"))
                self.programs.append(prog)
                self.cores.append(core)
                self.hbms.append(hbm)
            self.servers.append(server)
            # Advance notice of every collective this tenant can issue
            # (batch sizes 1..slots): the event fabric refines bounded-lag
            # edges from these exact (kind, bytes, group) triples, and its
            # strict-window guard fails loudly on an un-noted collective.
            if len(tenant.devices) > 1:
                s = ServeSizing(tenant)
                for b in range(1, tenant.slots + 1):
                    self.fabric.note_plan("all-reduce", float(s.ar_bytes(b)),
                                          tuple(tenant.devices))
                    if s.moe:
                        self.fabric.note_plan("all-to-all",
                                              float(s.a2a_bytes(b)),
                                              tuple(tenant.devices))
                if recovery is not None:
                    # rejoin reshard migrates KV on the nominal group
                    self.fabric.note_plan(
                        "all-to-all", float(recovery.migrate_chunk_bytes),
                        tuple(tenant.devices))
        for d in scenario.spares:
            # A spare chip: full compute stack, one control port per
            # tenant star (bound at claim time), idle until claimed.
            core = self.engine.register(
                TensorCore(f"chip{d}.core", spec.chip))
            hbm = self.engine.register(
                HbmController(f"chip{d}.hbm", spec.chip))
            prog = self.engine.register(
                ServeProgram(f"chip{d}.prog", d, (), spare=True,
                             heartbeat_ps=heartbeat_ps,
                             suspect_threshold=suspect))
            self.engine.register(Connection(f"chip{d}.bus")).plug(
                prog.port("core")).plug(core.port("prog"))
            self.engine.register(Connection(f"chip{d}.membus")).plug(
                core.port("hbm")).plug(hbm.port("cpu"))
            coll_conn.plug(prog.port("coll"))
            for tid, ctrl in enumerate(ctrl_conns):
                ctrl.plug(prog.port(f"ctrl{tid}"))
            if health_conn is not None:
                health_conn.plug(prog.port("health"))
            self.programs.append(prog)
            self.cores.append(core)
            self.hbms.append(hbm)

    def note_failover_plans(self, candidates: typing.Iterable[int]) -> None:
        """Note the collective plans of every group a recovery could
        re-mesh to: for each tenant, its device group minus every
        non-empty subset of ``candidates`` (the chips the fault plan can
        kill), each optionally extended by claimed spares (at most one
        spare per lost chip -- the monitor never over-claims).  Plans are
        consumed at run start -- the bounded scheduler derives its
        strict-window edges from them -- so every group that might form
        mid-run must be noted before ``engine.run()``.  Collective
        payloads are activation rows (tp-independent), so the noted
        bytes match the re-meshed iterations bit-for-bit; each group
        also gets the fixed-size KV-migration all-to-all chunk."""
        import itertools
        spares = tuple(sorted(self.scenario.spares))
        chunk = (float(self.policy.migrate_chunk_bytes)
                 if self.policy is not None else None)
        for tenant in self.scenario.tenants:
            cand = sorted((set(tenant.devices) | set(spares))
                          & set(candidates))
            lost_orig = [d for d in cand if d in tenant.devices]
            for r in range(1, len(lost_orig) + 1):
                for gone in itertools.combinations(lost_orig, r):
                    survivors = tuple(d for d in tenant.devices
                                      if d not in gone)
                    for ns in range(0, min(r, len(spares)) + 1):
                        for claim in itertools.combinations(spares, ns):
                            group = tuple(sorted(survivors + claim))
                            if len(group) < 2:
                                continue
                            s = ServeSizing(tenant, tp=len(group))
                            for b in range(1, tenant.slots + 1):
                                self.fabric.note_plan(
                                    "all-reduce", float(s.ar_bytes(b)),
                                    group)
                                if s.moe:
                                    self.fabric.note_plan(
                                        "all-to-all",
                                        float(s.a2a_bytes(b)), group)
                            if chunk is not None:
                                self.fabric.note_plan("all-to-all",
                                                      chunk, group)

    def run(self, until_s: float = None) -> int:
        for prog in self.programs:
            prog.start()
        for server in self.servers:
            server.start()
        return self.engine.run(s_to_ps(until_s) if until_s else None)


# ---------------------------------------------------------------------------
# Report + driver
# ---------------------------------------------------------------------------

def _pctile_ps(values_ps: typing.List[int], q: float) -> float:
    """Nearest-rank percentile in seconds (deterministic, no interpolation)."""
    if not values_ps:
        return 0.0
    v = sorted(values_ps)
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return ps_to_s(v[k])


@dataclasses.dataclass
class ServeReport:
    """One serving run.  ``summary()`` excludes execution artifacts so it
    is bit-identical across schedulers and executors, same as SimReport."""
    time_s: float                  # makespan (last event)
    events: int
    devices: int
    tenants: int
    offered: int                   # requests in the arrival traces
    completed: int
    in_flight: int                 # admitted but unfinished at horizon
    queued: int                    # never admitted by the horizon
    offered_rps: float
    goodput_rps: float             # completed / makespan
    p50_s: float
    p99_s: float
    mean_s: float
    max_s: float
    queue_mean_s: float            # arrival -> admission
    prefill_mean_s: float          # admission -> first token
    decode_mean_s: float           # first token -> completion
    iterations: int
    peak_slots: typing.List[int]   # per tenant
    collectives_completed: int
    compute_busy_s: float
    compute_util: float
    link_report: dict
    fabric: str = "analytic"
    link_utilization: dict = dataclasses.field(default_factory=dict)
    # per-tenant SLO view: a fault on one tenant's links must show up in
    # that tenant's tail even when another tenant owns the global max
    tenant_p50_s: typing.List[float] = dataclasses.field(default_factory=list)
    tenant_p99_s: typing.List[float] = dataclasses.field(default_factory=list)
    per_request: list = dataclasses.field(default_factory=list)
    # -- graceful degradation (recovery layer; zeros without a policy) ----
    collective_timeouts: int = 0
    retries: int = 0               # recovery requeues across tenants
    dropped: int = 0               # requests dropped past max_retries
    recoveries: int = 0            # outage windows closed by a completion
    rejoins: int = 0               # dead chips that re-registered
    chip_deaths: int = 0           # HealthMonitor verdicts (monotone)
    tenant_outage_s: typing.List[float] = dataclasses.field(
        default_factory=list)
    tenant_availability: typing.List[float] = dataclasses.field(
        default_factory=list)
    outage_windows: typing.List[list] = dataclasses.field(
        default_factory=list)     # per tenant: [start_s, end_s] pairs
    goodput_in_outage_rps: float = 0.0    # completions per tenant-second
    goodput_outside_outage_rps: float = 0.0
    # -- stateful failover (spare pool + KV migration) --------------------
    spare_claims: int = 0          # spares claimed for dead chips
    spare_returns: int = 0         # spares handed back to the pool
    migrated_bytes: int = 0        # KV shards moved over the fabric
    prefill_saved_tokens: int = 0  # context resumed from migrated KV
    prefill_recompute_tokens: int = 0   # context lost with dead shards
    # capacity-weighted availability: min(1, members/nominal) integrated
    # over the serving span, 0 inside outage windows -- a tenant held at
    # 3/4 capacity scores 0.75 even while "available"
    tenant_effective_availability: typing.List[float] = dataclasses.field(
        default_factory=list)
    fabric_traffic: dict = dataclasses.field(default_factory=dict)
    scheduler: str = "serial"
    executor: str = "none"

    _EXECUTION_FIELDS = ("scheduler", "executor")

    def summary(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if k not in self._EXECUTION_FIELDS}


def resolve_recovery(recovery, deadline_s: float = None):
    """Resolve the ``recovery`` argument of :func:`run_serving`:
    ``None`` enables a default :class:`RecoveryPolicy` iff ``deadline_s``
    is set (detection without recovery must be asked for explicitly with
    ``recovery=False``); ``True`` enables defaults; ``False`` disables;
    a :class:`RecoveryPolicy` instance is used as-is."""
    if recovery is False:
        return None
    if recovery is True:
        return RecoveryPolicy()
    if recovery is None:
        return RecoveryPolicy() if deadline_s else None
    return recovery


def _effective_availability(cap_log, windows, nominal: int,
                            span_ps: int) -> float:
    """Integrate ``min(1, members/nominal)`` over ``[0, span_ps]``,
    forcing 0 inside outage windows.  All-int accumulation (numerator
    areas in device·ps) so the result is bit-identical regardless of
    event-processing order."""
    if not span_ps or nominal <= 0:
        return 1.0
    steps: typing.Dict[int, int] = {}
    for t, n in cap_log:
        steps[t] = n                         # same-stamp: last wins
    stamps = sorted(steps)
    area = 0
    for i, t in enumerate(stamps):
        if t >= span_ps:
            break
        end = stamps[i + 1] if i + 1 < len(stamps) else span_ps
        end = min(end, span_ps)
        if end <= t:
            continue
        seg = end - t
        out = 0
        for s, e in windows:
            lo, hi = max(t, s), min(end, e)
            if hi > lo:
                out += hi - lo
        area += min(nominal, steps[t]) * (seg - out)
    return area / (nominal * span_ps)


def _fault_candidates(faults: dict) -> set:
    """Chip indices a fault plan can plausibly remove from a mesh (any
    chipN.* target -- even a straggler can be fenced by strike count)."""
    out = set()
    for name in faults or ():
        if name.startswith("chip"):
            head = name[4:].split(".", 1)[0]
            if head.isdigit():
                out.add(int(head))
    return out


def run_serving(scenario: ServingScenario, spec: SystemSpec = None,
                scheduler: str = None, max_workers: int = 4,
                fabric: str = None, executor: str = None,
                faults: dict = None, until_s: float = None,
                deadline_s: float = None,
                recovery=None) -> ServeReport:
    """Run one open-loop serving scenario and report the latency curve
    inputs.  Mirrors :func:`repro.core.simulate.simulate`'s fault-plan
    handling: same grammar, same validation, ``fabric.*`` targets need
    the event fabric.

    ``deadline_s`` threads through to the shared
    :class:`~repro.core.system.CollectiveCoordinator`: a collective that
    has not completed within the deadline of its first join times out
    (the failure-detection signal).  ``recovery`` selects the policy
    (see :func:`resolve_recovery`); with one, a :class:`HealthMonitor`
    turns timeouts + heartbeats into ``chip_dead`` verdicts and tenants
    serve *through* the fault (see docs/faults.md, Detection & recovery).
    """
    spec = spec or SystemSpec()
    policy = resolve_recovery(recovery, deadline_s)
    system = ServingSystem(scenario, spec, scheduler=scheduler,
                           max_workers=max_workers, fabric=fabric,
                           executor=executor, deadline_s=deadline_s,
                           recovery=policy)
    metrics = MetricsHook()
    system.engine.accept_hook(metrics)   # engine-level only (no fusing)
    if faults:
        plan = {name: [(s_to_ps(t), a,
                        s_to_ps(arg) if a == "transient" else arg)
                       for (t, a, arg) in acts]
                for name, acts in faults.items()}
        targets = (system.cores + system.programs + system.servers
                   + system.fabric.fault_targets())
        unknown = set(plan) - {c.name for c in targets}
        if unknown:
            raise ValueError(
                f"fault plan targets unknown components "
                f"{sorted(unknown)}; serving targets are chipN.core / "
                f"chipN.prog / tenantN.server, and fabric.* link/DMA "
                f"targets require fabric='event' (this run uses "
                f"{system.fabric.name!r})")
        inj = FaultInjector(plan)
        for comp in targets:
            comp.accept_hook(inj)
        inj.arm(targets)   # actions apply on schedule even on idle targets
        if policy is not None:
            system.note_failover_plans(_fault_candidates(faults))

    end_ps = system.run(until_s=until_s)
    time_s = ps_to_s(end_ps)

    per_request = []
    e2e, queue_t, prefill_t, decode_t = [], [], [], []
    tenant_e2e: typing.List[list] = [[] for _ in system.servers]
    offered = completed = in_flight = queued = dropped = 0
    for tid, server in enumerate(system.servers):
        for uid in sorted(server.recs):
            rec = server.recs[uid]
            offered += 1
            if rec.dropped_ps is not None:
                dropped += 1
                continue
            if rec.done_ps is None:
                if rec.admit_ps is None:
                    queued += 1
                else:
                    in_flight += 1
                continue
            completed += 1
            q = rec.admit_ps - rec.arrival_ps
            p = rec.first_ps - rec.admit_ps
            d = rec.done_ps - rec.first_ps
            e2e.append(rec.done_ps - rec.arrival_ps)
            tenant_e2e[tid].append(rec.done_ps - rec.arrival_ps)
            queue_t.append(q)
            prefill_t.append(p)
            decode_t.append(d)
            per_request.append({
                "tenant": tid, "uid": uid,
                "arrival_s": ps_to_s(rec.arrival_ps),
                "queue_s": ps_to_s(q), "prefill_s": ps_to_s(p),
                "decode_s": ps_to_s(d),
                "e2e_s": ps_to_s(rec.done_ps - rec.arrival_ps),
                "prompt_len": rec.prompt_len,
                "decode_len": rec.decode_len,
            })

    busy = max((metrics.busy_ps[c.name] for c in system.cores), default=0)
    span_s = max((float(r.arrival_ps) for t in scenario.tenants
                  for r in t.requests), default=0.0) / 1e12

    # Availability accounting: an outage window opens at an abort and
    # closes at the next completed iteration (still open at the end of
    # serving counts in full).  The serving span is per tenant, last
    # request stamp (done / dropped / arrival) -- trailing deadline
    # no-op events must not dilute availability.
    tenant_outage_s, tenant_avail, outage_windows = [], [], []
    tenant_eff_avail = []
    in_out_done = out_done = 0
    in_out_span_ps = out_span_ps = 0
    for server in system.servers:
        span_ps = max((max(rec.done_ps or 0, rec.dropped_ps or 0,
                           rec.arrival_ps)
                       for rec in server.recs.values()), default=0)
        windows = list(server.outages)
        if server._outage_start is not None:
            windows.append((server._outage_start, max(span_ps,
                                                      server._outage_start)))
        outage_ps = sum(e - s for s, e in windows)
        tenant_outage_s.append(ps_to_s(outage_ps))
        tenant_avail.append(1.0 - outage_ps / span_ps if span_ps else 1.0)
        outage_windows.append([[ps_to_s(s), ps_to_s(e)] for s, e in windows])
        tenant_eff_avail.append(_effective_availability(
            server._cap_log, windows, len(server.tenant.devices), span_ps))
        in_out_span_ps += outage_ps
        out_span_ps += span_ps - outage_ps
        for rec in server.recs.values():
            if rec.done_ps is None:
                continue
            # half-open [start, end): the completion that closes an
            # outage window is the restore moment, counted outside
            if any(s <= rec.done_ps < e for s, e in windows):
                in_out_done += 1
            else:
                out_done += 1

    return ServeReport(
        time_s=time_s,
        events=system.engine.events_processed,
        devices=len(system.programs),
        tenants=len(system.servers),
        offered=offered,
        completed=completed,
        in_flight=in_flight,
        queued=queued,
        offered_rps=offered / span_s if span_s else 0.0,
        goodput_rps=completed / time_s if time_s else 0.0,
        p50_s=_pctile_ps(e2e, 50.0),
        p99_s=_pctile_ps(e2e, 99.0),
        mean_s=ps_to_s(int(sum(e2e) / len(e2e))) if e2e else 0.0,
        max_s=ps_to_s(max(e2e)) if e2e else 0.0,
        queue_mean_s=ps_to_s(int(sum(queue_t) / len(queue_t))) if queue_t else 0.0,
        prefill_mean_s=ps_to_s(int(sum(prefill_t) / len(prefill_t))) if prefill_t else 0.0,
        decode_mean_s=ps_to_s(int(sum(decode_t) / len(decode_t))) if decode_t else 0.0,
        iterations=sum(s.iterations for s in system.servers),
        peak_slots=[s.ledger.peak for s in system.servers],
        tenant_p50_s=[_pctile_ps(v, 50.0) for v in tenant_e2e],
        tenant_p99_s=[_pctile_ps(v, 99.0) for v in tenant_e2e],
        collectives_completed=system.coordinator.completed,
        compute_busy_s=busy / 1e12,
        compute_util=(busy / 1e12) / time_s if time_s else 0.0,
        link_report=system.fabric.link_report(),
        fabric=system.fabric.name,
        link_utilization=system.fabric.link_utilization(end_ps or None),
        per_request=per_request,
        collective_timeouts=len(system.coordinator.timed_out),
        retries=sum(s.retries for s in system.servers),
        dropped=dropped,
        recoveries=sum(s.recoveries for s in system.servers),
        rejoins=sum(s.rejoins for s in system.servers),
        chip_deaths=system.monitor.deaths if system.monitor else 0,
        tenant_outage_s=tenant_outage_s,
        tenant_availability=tenant_avail,
        outage_windows=outage_windows,
        goodput_in_outage_rps=(in_out_done / ps_to_s(in_out_span_ps)
                               if in_out_span_ps else 0.0),
        goodput_outside_outage_rps=(out_done / ps_to_s(out_span_ps)
                                    if out_span_ps else 0.0),
        spare_claims=sum(s.spare_claims for s in system.servers),
        spare_returns=sum(s.spare_returns for s in system.servers),
        migrated_bytes=sum(s.migrated_bytes for s in system.servers),
        prefill_saved_tokens=sum(s.prefill_saved_tokens
                                 for s in system.servers),
        prefill_recompute_tokens=sum(s.prefill_recompute_tokens
                                     for s in system.servers),
        tenant_effective_availability=tenant_eff_avail,
        fabric_traffic=system.fabric.traffic_report(),
        scheduler=system.engine.scheduler.name,
        executor=(system.engine.scheduler.executor.name
                  if getattr(system.engine.scheduler, "executor", None)
                  is not None else "none"),
    )


# ---------------------------------------------------------------------------
# Scenario builders (sweepable: return None when the topology can't host)
# ---------------------------------------------------------------------------

def _dense_model(d_model: int = 1024, layers: int = 8) -> ModelConfig:
    return ModelConfig(name="serve-dense", family="dense",
                       num_layers=layers, d_model=d_model,
                       num_heads=max(1, d_model // 128), d_ff=4 * d_model,
                       vocab_size=32000)


def _moe_model(d_model: int = 1024, layers: int = 8) -> ModelConfig:
    return ModelConfig(name="serve-moe", family="moe",
                       num_layers=layers, d_model=d_model,
                       num_heads=max(1, d_model // 128), d_ff=4 * d_model,
                       vocab_size=32000, num_experts=8, experts_per_token=2)


def build_scenario(spec: SystemSpec, name: str = "serving",
                   arrival: str = "poisson", rate_rps: float = 500.0,
                   duration_s: float = 0.02, seed: int = 0,
                   tenants: int = 2, slots: int = 4,
                   prompt_range: typing.Tuple[int, int] = (16, 64),
                   decode_range: typing.Tuple[int, int] = (4, 12),
                   moe: bool = False,
                   model: ModelConfig = None,
                   spares: int = 0) -> typing.Optional[ServingScenario]:
    """Place ``tenants`` tenants on contiguous row-blocks of pod 0 and
    attach seeded open-loop traces.  ``spares`` reserves that many chips
    (the ones right after the tenant blocks, spilling into further pods)
    for the HealthMonitor's shared failover pool.  Returns None when pod
    0 hasn't a row per tenant, or the topology hasn't enough chips left
    over for the spares (sweep grids skip the combo, same contract as
    the collective scenario builders in tools/sweep.py)."""
    if arrival not in GENERATORS:
        raise ValueError(f"unknown arrival generator {arrival!r}; "
                         f"have {sorted(GENERATORS)}")
    y, x = spec.pod_shape[0], spec.pod_shape[1]
    rows_per = y // tenants
    if rows_per < 1:
        return None
    first_free = tenants * rows_per * x
    if spares and first_free + spares > spec.total_chips:
        return None
    spare_devs = tuple(range(first_free, first_free + spares))
    model = model or (_moe_model() if moe else _dense_model())
    specs = []
    for tid in range(tenants):
        devices = tuple(range(tid * rows_per * x, (tid + 1) * rows_per * x))
        times = GENERATORS[arrival](rate_rps, duration_s,
                                    seed=seed * 1000 + tid)
        reqs = make_requests(times, seed=seed * 1000 + tid + 500,
                             prompt_range=prompt_range,
                             decode_range=decode_range)
        specs.append(TenantSpec(name=f"{name}.t{tid}", devices=devices,
                                model=model, slots=slots, requests=reqs))
    return ServingScenario(name=name, tenants=tuple(specs),
                           spares=spare_devs)
