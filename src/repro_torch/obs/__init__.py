"""Flight recorder of the port (counterpart of ``repro.obs``).

Three layers, as in the reference:

* ``repro_torch.obs.trace``   — host spans and the JSONL run event log,
  which keeps the reference's ``events.jsonl`` schema; every span is
  also a range of any torch profiler that is running, with or without
  a recorder;
* ``repro_torch.obs.metrics`` — ``MetricsCarry``, the per-round
  telemetry computed on the device (inside the captured round of the
  fused loop) and offloaded in one copy a round or a chunk;
* ``repro_torch.obs.report``  — ``python -m repro_torch.obs.report
  events.jsonl``: per-round tables and the machine-readable summary.

``repro_torch.obs.checks`` holds the host-side checks of
``TrainConfig.debug_checks``.
"""
from repro_torch.obs.trace import (EMITTER, EVENT_SCHEMA, Recorder, count,
                                   event, get_recorder, recording, span,
                                   to_chrome_trace)

__all__ = ["EMITTER", "EVENT_SCHEMA", "Recorder", "count", "event",
           "get_recorder", "recording", "span", "to_chrome_trace"]
