"""Seeded fault injection and the resilient round planner (port of
``repro.fed.faults``; host numpy, the reference's draws).

Everything that can go wrong between a client being sampled and its
update being admitted, as a pure function of ``(seed, round, attempt,
client)``:

* **crash** — the client dies mid-round; no upload.
* **transient network failure** — a send fails; the client retries with
  exponential backoff (``net_backoff_s · 2^i``) up to ``net_retries``
  times, then the upload is lost.  The delay adds to the client's
  latency, so under the clock a retried upload can miss the deadline.
* **duplicate** — the sealed payload is replayed; the server's
  (client, round) nonce dedup rejects the copy.
* **bitflip** — one wire bit flips *after* sealing; the CRC-32 fails.
* **nan / poison** — the client produces a NaN or a norm-inflated update
  *before* sealing (valid checksum); the nonfinite and norm gates
  reject it.

``Resilience`` is the planner both loop shapes of ``run_federated`` share
(``core.scbf``): plan → fault outcomes → deadline recheck → round
quorum with bounded retry and backoff.  Every outcome is decided here,
on the host, at plan time, so the fused loop folds the verdicts into a
per-slot admit mask; with everything off the planner passes
``scheduler.plan`` through unchanged.  The stream tags, draw order and
byte-level corruption are the reference's, so a seed injects the
reference's faults into the same payload bytes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm import wire
from repro_torch.config import FaultConfig, FedConfig
from repro_torch.fed.scheduler import RoundPlan
from repro_torch.obs import trace as obstrace

# hashed-RNG stream tags (see fed.clock: call-order-free draws)
_TAG_FAULTS = 0xFA17
_TAG_CORRUPT = 0xC0FF

# corruption codes, mutually exclusive per client per round
CORRUPT_NONE = 0
CORRUPT_BITFLIP = 1                  # post-seal wire corruption
CORRUPT_NAN = 2                      # client-side nonfinite update
CORRUPT_POISON = 3                   # client-side norm-inflated update
_CORRUPT_KIND = {CORRUPT_BITFLIP: "bitflip", CORRUPT_NAN: "nan",
                 CORRUPT_POISON: "poison"}


@dataclass
class RoundFaults:
    """One (round, attempt)'s fault outcomes, aligned to the sampled
    participants (pre-removal)."""

    participants: np.ndarray         # client ids the outcomes align to
    crashed: np.ndarray              # (P,) bool — died mid-round
    net_lost: np.ndarray             # (P,) bool — every send attempt failed
    net_tries: np.ndarray            # (P,) int — send attempts used (>=1)
    net_delay_s: np.ndarray          # (P,) float — backoff added to latency
    duplicated: np.ndarray           # (P,) bool — payload replayed
    corrupt: np.ndarray              # (P,) int8 CORRUPT_* code

    @property
    def lost(self) -> np.ndarray:
        """(P,) bool — upload never reaches the server."""
        return self.crashed | self.net_lost

    def events(self) -> List[dict]:
        """One dict per injected fault, for ``fault_injected`` events."""
        out = []
        for i, k in enumerate(np.asarray(self.participants)):
            k = int(k)
            if self.crashed[i]:
                out.append({"client": k, "kind": "crash"})
            elif self.net_lost[i]:
                out.append({"client": k, "kind": "net_drop",
                            "tries": int(self.net_tries[i])})
            elif self.net_tries[i] > 1:
                out.append({"client": k, "kind": "net_retry",
                            "tries": int(self.net_tries[i]),
                            "delay_s": round(float(self.net_delay_s[i]), 6)})
            if self.duplicated[i] and not self.lost[i]:
                out.append({"client": k, "kind": "duplicate"})
            code = int(self.corrupt[i])
            if code != CORRUPT_NONE and not self.lost[i]:
                out.append({"client": k, "kind": _CORRUPT_KIND[code]})
        return out


class FaultInjector:
    """Draws per-round fault outcomes from a hashed, seeded RNG."""

    def __init__(self, num_clients: int, cfg: FaultConfig):
        for name in ("crash_rate", "net_fail_rate", "duplicate_rate",
                     "bitflip_rate", "nan_rate", "poison_rate"):
            v = getattr(cfg, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if cfg.bitflip_rate + cfg.nan_rate + cfg.poison_rate > 1.0 + 1e-12:
            raise ValueError(
                "bitflip_rate + nan_rate + poison_rate must be <= 1 "
                "(corruption kinds are mutually exclusive per client)")
        if cfg.net_retries < 0:
            raise ValueError(f"net_retries must be >= 0, got "
                             f"{cfg.net_retries}")
        if cfg.poison_scale <= 1.0:
            raise ValueError(
                f"poison_scale must be > 1 so a poisoned update always "
                f"exceeds the norm bound, got {cfg.poison_scale}")
        self.num_clients = int(num_clients)
        self.cfg = cfg

    def round_faults(self, round_index: int, participants: np.ndarray,
                     attempt: int = 0) -> RoundFaults:
        """Fault outcomes for one (round, attempt) — pure in (seed,
        config, round, attempt, participants); other rounds' draws share
        no state with this one."""
        cfg = self.cfg
        part = np.asarray(participants)
        P = int(part.size)
        r = np.random.default_rng(
            [cfg.seed, _TAG_FAULTS, int(round_index), int(attempt)])
        # one (K,) draw per fault axis, indexed by client id: outcomes
        # depend on WHO was sampled, not on cohort size or order
        crash_u = r.random(self.num_clients)
        net_u = r.random((self.num_clients, cfg.net_retries + 1))
        dup_u = r.random(self.num_clients)
        cor_u = r.random(self.num_clients)

        crashed = crash_u[part] < cfg.crash_rate
        fails = net_u[part] < cfg.net_fail_rate
        net_lost = fails.all(axis=1) if P else np.zeros(0, bool)
        # attempts used = index of first success + 1 (all = retries+1)
        first_ok = np.where(net_lost, fails.shape[1] - 1,
                            np.argmin(fails, axis=1)) if P \
            else np.zeros(0, np.int64)
        net_tries = first_ok + 1
        # exponential backoff before each retry: sum_{i<k} base * 2^i
        net_delay = cfg.net_backoff_s * (2.0 ** first_ok - 1.0) \
            if P else np.zeros(0)
        duplicated = dup_u[part] < cfg.duplicate_rate
        u = cor_u[part]
        corrupt = np.zeros(P, np.int8)
        b, n = cfg.bitflip_rate, cfg.nan_rate
        corrupt[u < b] = CORRUPT_BITFLIP
        corrupt[(u >= b) & (u < b + n)] = CORRUPT_NAN
        corrupt[(u >= b + n) & (u < b + n + cfg.poison_rate)] = \
            CORRUPT_POISON
        return RoundFaults(participants=part, crashed=crashed,
                           net_lost=net_lost, net_tries=net_tries,
                           net_delay_s=net_delay, duplicated=duplicated,
                           corrupt=corrupt)


# ---------------------------------------------------------------------------
# Payload corruption — host-side mutation of the wire artifacts
# ---------------------------------------------------------------------------

def _slot_rng(seed: int, round_index: int, attempt: int, slot: int
              ) -> np.random.Generator:
    return np.random.default_rng(
        [seed, _TAG_CORRUPT, int(round_index), int(attempt), int(slot)])


def _force_malformed(payload: wire.Payload) -> wire.Payload:
    """Fallback corruption for a payload with no value bytes to touch:
    bump a declared nnz so structural validation rejects it."""
    lp = payload.layers[0]
    layers = (dataclasses.replace(lp, nnz=lp.size + 1),) \
        + payload.layers[1:]
    return dataclasses.replace(payload, layers=layers)


def _replace_values(payload: wire.Payload, new_values: List[np.ndarray]
                    ) -> wire.Payload:
    layers = tuple(dataclasses.replace(lp, values=v)
                   for lp, v in zip(payload.layers, new_values))
    return dataclasses.replace(payload, layers=layers)


def corrupt_client_payload(payload: wire.Payload, code: int,
                           rng: np.random.Generator, norm_bound: float,
                           poison_scale: float) -> wire.Payload:
    """Apply a *client-side* fault (pre-seal: checksum will be valid).

    nan: one transmitted value becomes NaN — the server's nonfinite
    gate must catch it.  poison: values are rescaled so the update's
    L2 norm is ``poison_scale`` times the norm bound (or the raw scale
    when no bound is configured) — guaranteed to exceed an active
    reject-mode norm gate, which is what lets the fused path decide
    the admit mask at plan time.
    """
    values = [np.asarray(lp.values) for lp in payload.layers]
    total = sum(v.size for v in values)
    if total == 0:
        return _force_malformed(payload)
    if code == CORRUPT_NAN:
        pos = int(rng.integers(total))
        out = []
        for v in values:
            if 0 <= pos < v.size:
                v = v.copy()
                v[pos] = np.nan
            pos -= v.size
            out.append(v)
        return _replace_values(payload, out)
    if code == CORRUPT_POISON:
        target = poison_scale * (norm_bound if norm_bound > 0 else 1.0)
        cur = float(np.sqrt(sum(
            float(np.sum(np.square(v, dtype=np.float64))) for v in values)))
        if cur > 0:
            s = target / cur
            return _replace_values(
                payload, [(v * s).astype(v.dtype) for v in values])
        c = target / np.sqrt(total)
        return _replace_values(
            payload, [np.full_like(v, c) for v in values])
    raise ValueError(f"not a client-side corruption code: {code}")


def corrupt_wire_payload(payload: wire.Payload,
                         rng: np.random.Generator) -> wire.Payload:
    """Flip one random bit of the sealed payload's buffers (values,
    indices or bitmap) — the CRC-32 checksum catches any single-bit
    flip, so the server must reject this payload."""
    bufs = []                        # (layer_i, field, nbytes)
    for i, lp in enumerate(payload.layers):
        if lp.values is not None and np.asarray(lp.values).nbytes:
            bufs.append((i, "values", np.asarray(lp.values).nbytes))
        if lp.idx is not None and np.asarray(lp.idx).nbytes:
            bufs.append((i, "idx", np.asarray(lp.idx).nbytes))
        if lp.bitmap is not None and np.asarray(lp.bitmap).nbytes:
            bufs.append((i, "bitmap", np.asarray(lp.bitmap).nbytes))
    total = sum(b for _, _, b in bufs)
    if total == 0:
        return _force_malformed(payload)
    pos = int(rng.integers(total))
    bit = int(rng.integers(8))
    for i, fld, nbytes in bufs:
        if pos < nbytes:
            lp = payload.layers[i]
            buf = np.asarray(getattr(lp, fld)).copy()
            raw = buf.view(np.uint8).reshape(-1)
            raw[pos] ^= np.uint8(1 << bit)
            layers = payload.layers[:i] \
                + (dataclasses.replace(lp, **{fld: buf}),) \
                + payload.layers[i + 1:]
            return dataclasses.replace(payload, layers=layers)
        pos -= nbytes
    raise AssertionError("unreachable: position within total bytes")


def apply_payload_faults(payloads: Sequence[wire.Payload],
                         participants: np.ndarray,
                         corrupt: np.ndarray, duplicated: np.ndarray,
                         round_index: int, attempt: int, cfg: FaultConfig,
                         norm_bound: float
                         ) -> Tuple[List[wire.Payload], List[int]]:
    """The full client→wire fault pipeline for one round's uploads.

    Per slot: client-side corruption (nan/poison) BEFORE sealing, then
    seal with the (client, round) nonce + checksum, then wire-level
    corruption (bitflip) AFTER sealing, then replay (duplicates append
    the same sealed bytes again).  Returns the wire payload list and
    ``dup_src`` — for each appended duplicate, the slot it replays
    (so the caller can extend per-payload metadata arrays to match).
    """
    out: List[wire.Payload] = []
    dup_src: List[int] = []
    for i, p in enumerate(payloads):
        code = int(corrupt[i]) if i < len(corrupt) else CORRUPT_NONE
        rng = _slot_rng(cfg.seed, round_index, attempt, i)
        if code in (CORRUPT_NAN, CORRUPT_POISON):
            p = corrupt_client_payload(p, code, rng, norm_bound,
                                       cfg.poison_scale)
        p = wire.seal(p, int(participants[i]), round_index)
        if code == CORRUPT_BITFLIP:
            p = corrupt_wire_payload(p, rng)
        out.append(p)
    for i in range(len(payloads)):
        if i < len(duplicated) and duplicated[i]:
            out.append(out[i])
            dup_src.append(i)
    return out, dup_src


# ---------------------------------------------------------------------------
# The resilient round planner — shared by both loop shapes
# ---------------------------------------------------------------------------

@dataclass
class AdmittedRound:
    """One round's plan after faults, deadline recheck and quorum.

    ``plan.participants`` are the clients whose uploads ARRIVE (crash /
    net-loss / deadline casualties already removed); ``corrupt`` /
    ``duplicated`` / ``will_reject`` align to them.  ``will_reject`` is
    the plan-time admission prediction the fused path turns into its
    per-slot admit mask — sound because every payload-level fault is
    constructed to fail its server-side gate (see
    ``corrupt_client_payload``).
    """

    plan: RoundPlan
    corrupt: np.ndarray              # (P,) int8 CORRUPT_* per arriver
    duplicated: np.ndarray           # (P,) bool per arriver
    will_reject: np.ndarray          # (P,) bool — planned admission outcome
    quorum_ok: bool = True
    attempts: int = 1                # plan attempts consumed (1 = no retry)
    # arrivers of aborted quorum attempts: they trained and uploaded
    # before the server discarded the round, so their DP releases are
    # real spend the federated loop must still count
    aborted_arrivers: List[np.ndarray] = field(default_factory=list)

    @property
    def expected_valid(self) -> int:
        return int(np.count_nonzero(~self.will_reject))

    def admit_mask(self) -> np.ndarray:
        """(P,) bool — slots the server will fold into the model."""
        if not self.quorum_ok:
            return np.zeros(self.plan.participants.size, dtype=bool)
        return ~self.will_reject


def _restrict_plan(plan: RoundPlan, keep: np.ndarray,
                   to_dropped: bool) -> RoundPlan:
    """Remove participants where ``~keep``; casualties are folded into
    the plan's dropped (crash/net loss) or stragglers (deadline miss)
    telemetry."""
    removed = plan.participants[~keep]
    kw = dict(participants=plan.participants[keep],
              staleness=plan.staleness[keep])
    if plan.latency_s is not None:
        kw["latency_s"] = plan.latency_s[keep]
    if to_dropped:
        kw["dropped"] = np.sort(np.concatenate([plan.dropped, removed]))
    else:
        kw["stragglers"] = np.sort(np.concatenate([plan.stragglers,
                                                   removed]))
    return dataclasses.replace(plan, **kw)


class Resilience:
    """plan → faults → deadline recheck → quorum retry, in one place.

    With the clock, injector and quorum all off this is a strict
    pass-through of ``scheduler.plan(loop, version)`` — the fault-free
    trace is bit-identical by construction.  Both the per-round loop
    and the fused pre-planner call ``plan_round`` in the same sequence,
    so the two paths see identical participation, faults and clock
    state however rounds are chunked.
    """

    def __init__(self, scheduler, clock, injector: Optional[FaultInjector],
                 fed: FedConfig):
        self.scheduler = scheduler
        self.clock = clock
        self.injector = injector
        self.fed = fed
        self.norm_rejects = (fed.max_update_norm > 0
                             and fed.norm_action == "reject")

    @property
    def active(self) -> bool:
        return (self.injector is not None or self.clock is not None
                or self.fed.min_valid_participants > 0)

    def _will_reject(self, corrupt: np.ndarray) -> np.ndarray:
        wr = (corrupt == CORRUPT_BITFLIP) | (corrupt == CORRUPT_NAN)
        if self.norm_rejects:
            wr |= corrupt == CORRUPT_POISON
        return wr

    def _attempt(self, loop: int, version: int, attempt: int
                 ) -> Tuple[RoundPlan, np.ndarray, np.ndarray]:
        plan = self.scheduler.plan(loop, version, attempt=attempt)
        P = plan.participants.size
        if self.injector is None:
            return plan, np.zeros(P, np.int8), np.zeros(P, bool)
        rf = self.injector.round_faults(loop, plan.participants, attempt)
        for ev in rf.events():
            fault = ev.pop("kind")
            obstrace.event("fault_injected", loop=loop, attempt=attempt,
                           fault=fault, **ev)
        keep = ~rf.lost
        corrupt, dup, delay = rf.corrupt[keep], rf.duplicated[keep], \
            rf.net_delay_s[keep]
        plan = _restrict_plan(plan, keep, to_dropped=True)
        if plan.deadline_s is not None and plan.latency_s is not None \
                and self.fed.clock.deadline_action == "drop":
            # network-retry backoff delays the upload past the cohort
            # deadline: those clients become deadline casualties too
            # (spill mode instead carries the delay into staleness
            # bookkeeping at the scheduler level and is not re-cut here)
            on_time = (plan.latency_s + delay) <= plan.deadline_s
            if not on_time.all():
                corrupt, dup = corrupt[on_time], dup[on_time]
                plan = _restrict_plan(plan, on_time, to_dropped=False)
        return plan, corrupt, dup

    def plan_round(self, loop: int, version: int) -> AdmittedRound:
        quorum = int(self.fed.min_valid_participants)
        max_attempts = (int(self.fed.round_retries) + 1) if quorum > 0 \
            else 1
        aborted: List[np.ndarray] = []
        for attempt in range(max_attempts):
            plan, corrupt, dup = self._attempt(loop, version, attempt)
            wr = self._will_reject(corrupt)
            valid = int(np.count_nonzero(~wr))
            if quorum <= 0 or valid >= quorum:
                return AdmittedRound(plan=plan, corrupt=corrupt,
                                     duplicated=dup, will_reject=wr,
                                     quorum_ok=True, attempts=attempt + 1,
                                     aborted_arrivers=aborted)
            if attempt < max_attempts - 1:
                obstrace.event("round_retried", loop=loop, attempt=attempt,
                               expected_valid=valid, needed=quorum,
                               backoff_s=float(self.fed.retry_backoff_s))
                obstrace.count("rounds_retried")
                # the aborted cohort trained and uploaded before the
                # server gave up on the attempt — privacy spend is real
                aborted.append(np.asarray(plan.participants).copy())
                if self.clock is not None:
                    self.clock.advance(self.fed.retry_backoff_s)
        obstrace.event("quorum_miss", loop=loop, attempts=max_attempts,
                       expected_valid=valid, needed=quorum)
        obstrace.count("quorum_misses")
        return AdmittedRound(plan=plan, corrupt=corrupt, duplicated=dup,
                             will_reject=wr, quorum_ok=False,
                             attempts=max_attempts,
                             aborted_arrivers=aborted)


# ---------------------------------------------------------------------------
# CLI spec parsing (launch/train.py --fault-trace)
# ---------------------------------------------------------------------------

_TRACE_KEYS = {
    "seed": ("seed", int),
    "crash": ("crash_rate", float),
    "net_fail": ("net_fail_rate", float),
    "retries": ("net_retries", int),
    "backoff": ("net_backoff_s", float),
    "duplicate": ("duplicate_rate", float),
    "bitflip": ("bitflip_rate", float),
    "nan": ("nan_rate", float),
    "poison": ("poison_rate", float),
    "poison_scale": ("poison_scale", float),
}


def parse_fault_trace(spec: str) -> FaultConfig:
    """Parse ``"crash=0.1,bitflip=0.05,seed=7"`` into a ``FaultConfig``.

    Keys: seed, crash, net_fail, retries, backoff, duplicate, bitflip,
    nan, poison, poison_scale.  The returned config has ``enabled=True``
    — passing a trace spec IS opting into injection.
    """
    kw = {"enabled": True}
    for part in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"--fault-trace entry {part!r} is not "
                             f"key=value")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in _TRACE_KEYS:
            raise ValueError(f"unknown --fault-trace key {k!r}; one of "
                             f"{sorted(_TRACE_KEYS)}")
        name, cast = _TRACE_KEYS[k]
        kw[name] = cast(v)
    return FaultConfig(**kw)
