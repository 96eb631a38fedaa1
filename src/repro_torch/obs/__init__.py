"""Flight recorder of the port (counterpart of ``repro.obs``).

``repro_torch.obs.trace`` holds the host spans and the JSONL run event
log, in the reference's ``events.jsonl`` schema, so
``python -m repro.obs.report`` reads a log of the port unchanged.  The
device metrics and the debug checks (``repro.obs.metrics``,
``repro.obs.checks``) are ROADMAP A12 and not ported yet.
"""
from repro_torch.obs.trace import (EMITTER, EVENT_SCHEMA, Recorder, count,
                                   event, get_recorder, recording, span,
                                   to_chrome_trace)

__all__ = ["EMITTER", "EVENT_SCHEMA", "Recorder", "count", "event",
           "get_recorder", "recording", "span", "to_chrome_trace"]
