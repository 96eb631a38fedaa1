"""Run reports — an events.jsonl rendered as tables and summaries (port
of ``repro.obs.report``).

The flight recorder (``repro_torch.obs.trace``) writes one JSONL event
stream a run, in the reference's schema.  This module reads it, with no
JAX on the machine:

    PYTHONPATH=src python -m repro_torch.obs.report events.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report events.jsonl \
        --json-out report.json --trace-out trace.json

* the per-round table (loss, participants, bytes, ε trajectory, prune
  timeline) prints to stdout;
* ``--json-out`` writes ``summarize()``'s machine-readable summary, the
  reference's structure;
* ``--trace-out`` writes the Chrome/Perfetto trace-event export (load at
  ui.perfetto.dev or chrome://tracing).

``read_events`` refuses a stream whose leading ``meta`` event carries
another schema version than this reader understands, and a file that is
not an event log.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import EMITTER, EVENT_SCHEMA, to_chrome_trace


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load an events.jsonl, validating the schema handshake."""
    events = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSONL ({e})") from e
    if not events or events[0].get("ev") != "meta":
        raise ValueError(
            f"{path}: not a repro.obs event log — the first line must be "
            "the 'meta' event (was the file produced by obs.trace?)")
    schema = events[0].get("schema")
    if schema != EVENT_SCHEMA:
        raise ValueError(
            f"{path}: event schema {schema!r} != supported {EVENT_SCHEMA} "
            f"(emitter {events[0].get('emitter')!r}, reader {EMITTER}); "
            "re-record with a matching repro.obs version instead of "
            "guessing at field meanings")
    return events


def _span_summary(events: List[Dict[str, Any]]) -> Dict[str, Dict]:
    spans: Dict[str, Dict] = {}
    for e in events:
        if e.get("ev") != "span":
            continue
        s = spans.setdefault(e.get("name", "?"),
                             {"count": 0, "total_s": 0.0, "max_s": 0.0})
        d = float(e.get("dur", 0.0))
        s["count"] += 1
        s["total_s"] = round(s["total_s"] + d, 6)
        s["max_s"] = round(max(s["max_s"], d), 6)
    return spans


def _chaos_summary(events: List[Dict[str, Any]]) -> Optional[Dict]:
    """Fault-model aggregates, or None on a fault-free stream
    (``fault_injected``, ``payload_rejected``, ``round_retried`` and
    ``quorum_miss`` events)."""
    faults: Dict[str, int] = {}
    rejects: Dict[str, int] = {}
    retries = quorum_misses = 0
    for e in events:
        ev = e.get("ev")
        if ev == "fault_injected":
            k = e.get("fault", "?")
            faults[k] = faults.get(k, 0) + 1
        elif ev == "payload_rejected":
            r = e.get("reason", "?")
            rejects[r] = rejects.get(r, 0) + 1
        elif ev == "round_retried":
            retries += 1
        elif ev == "quorum_miss":
            quorum_misses += 1
    if not (faults or rejects or retries or quorum_misses):
        return None
    return {"faults_injected": faults, "payloads_rejected": rejects,
            "rounds_retried": retries, "quorum_misses": quorum_misses}


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Machine-readable run summary, the reference's structure.

    Totals come from the ``round`` events, span aggregates from the
    ``span`` events, counters from ``run_end`` (a port log has no compile
    counters: ``compiles`` is empty).  A stream without ``round`` events
    gives zero totals and its spans.
    """
    meta = events[0] if events and events[0].get("ev") == "meta" else {}
    rounds = [e for e in events if e.get("ev") == "round"]
    prunes = [e for e in events if e.get("ev") == "prune"]
    run_end = next((e for e in reversed(events)
                    if e.get("ev") == "run_end"), {})

    total_sparse = sum(int(e.get("sparse_bytes", 0)) for e in rounds)
    total_dense = sum(int(e.get("dense_bytes", 0)) for e in rounds)
    codec: Dict[str, int] = {}
    losses = []
    eps = None
    for e in rounds:
        for c, b in (e.get("codec_bytes") or {}).items():
            codec[c] = codec.get(c, 0) + int(b)
        if e.get("train_loss") is not None and e.get("participants"):
            losses.append(float(e["train_loss"]))
        if e.get("epsilon") is not None:
            eps = float(e["epsilon"])
    wall = sum(float(e.get("wall", 0.0)) for e in rounds)
    return {
        "schema": meta.get("schema", EVENT_SCHEMA),
        "emitter": meta.get("emitter", EMITTER),
        "rounds": len(rounds),
        "total_sparse_bytes": total_sparse,
        "total_dense_bytes": total_dense,
        "codec_bytes": codec,
        "mean_train_loss": (sum(losses) / len(losses)) if losses else None,
        "final_train_loss": losses[-1] if losses else None,
        "final_epsilon": eps,
        "round_wall_s": round(wall, 6),
        "rounds_per_s": round(len(rounds) / wall, 3) if wall > 0 else None,
        "wall_is_amortized": any(e.get("wall_is_amortized")
                                 for e in rounds),
        "prune_steps": len(prunes),
        "hidden_final": rounds[-1].get("hidden") if rounds else None,
        "compiles": {k: run_end[k] for k in ("scbf_compiles",
                                             "fused_compiles")
                     if k in run_end},
        "host_offloads": run_end.get("host_offloads"),
        "spans": _span_summary(events),
        "chaos": _chaos_summary(events),
    }


def per_round_table(events: List[Dict[str, Any]]) -> str:
    """The human-facing per-round table."""
    rounds = [e for e in events if e.get("ev") == "round"]
    if not rounds:
        return "(no round events)"
    hdr = (f"{'loop':>4} {'P':>4} {'loss':>9} {'sel_bytes':>10} "
           f"{'codec':>7} {'eps':>8} {'keep':>5} {'stale':>6} "
           f"{'wall_s':>8}")
    lines = [hdr, "-" * len(hdr)]
    for e in rounds:
        loss = e.get("train_loss")
        cb = e.get("codec_bytes") or {}
        dominant = max(cb, key=cb.get) if any(cb.values()) else "-"
        epsv = e.get("epsilon")
        wall = float(e.get("wall", 0.0))
        lines.append(
            f"{e.get('loop', -1):>4} {e.get('participants', 0):>4} "
            + (f"{loss:>9.4f}" if loss is not None else f"{'-':>9}")
            + f" {e.get('sparse_bytes', 0):>10} {dominant:>7} "
            + (f"{epsv:>8.3f}" if epsv is not None else f"{'-':>8}")
            + f" {e.get('keep_density', 1.0):>5.2f} "
            f"{e.get('staleness_mean', 0.0):>6.2f} "
            + f"{wall:>7.3f}{'~' if e.get('wall_is_amortized') else ' '}")
    lines.append("(wall '~' = chunk-amortized: chunk wall / rounds, "
                 "not a per-round measurement)")
    for e in events:
        if e.get("ev") == "prune":
            lines.append(f"prune @ loop {e.get('loop')}: "
                         f"hidden -> {e.get('hidden')}")
        elif e.get("ev") == "compact":
            lines.append(f"compact @ loop {e.get('loop')}: "
                         f"hidden {e.get('hidden')} now physical")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render an events.jsonl into a per-round "
                    "table, a machine-readable summary, and a "
                    "Chrome/Perfetto trace export.")
    ap.add_argument("events", help="events.jsonl written by obs.trace")
    ap.add_argument("--json-out", default=None,
                    help="write summarize() as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome trace-event export (load at "
                         "ui.perfetto.dev)")
    ap.add_argument("--no-table", action="store_true",
                    help="skip the stdout per-round table")
    args = ap.parse_args(argv)

    try:
        events = read_events(args.events)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if not args.no_table:
        print(per_round_table(events))
    summary = summarize(events)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
        print(f"wrote {args.json_out}")
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump(to_chrome_trace(events), fh)
        print(f"wrote {args.trace_out} (open at ui.perfetto.dev)")
    if not args.no_table:
        sp = summary["spans"]
        if sp:
            print("spans: " + "; ".join(
                f"{k}×{v['count']} {v['total_s']:.3f}s"
                for k, v in sorted(sp.items())))
        ch = summary["chaos"]
        if ch:
            fi = "; ".join(f"{k}×{v}" for k, v in
                           sorted(ch["faults_injected"].items()))
            rj = "; ".join(f"{k}×{v}" for k, v in
                           sorted(ch["payloads_rejected"].items()))
            print(f"chaos: injected [{fi or '-'}] rejected [{rj or '-'}] "
                  f"retries={ch['rounds_retried']} "
                  f"quorum_misses={ch['quorum_misses']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
