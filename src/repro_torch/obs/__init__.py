"""repro_torch.obs: the observability layer (flight recorder + logging).

``Tracer`` records typed events from the whole serving stack into a
bounded ring buffer (``repro_torch.obs.tracer``); ``repro_torch.obs.export`` writes
them as Perfetto-loadable Chrome trace JSON; ``repro_torch.obs.timeline``
decomposes per-request end-to-end latency from them; ``repro_torch.obs.log`` is
the CLIs' leveled logger. See docs/observability.md.

Only the tracer core is imported eagerly — it is on the hot serving path
and must stay dependency-free; export/timeline load on demand.
"""
from repro_torch.obs.tracer import (DEFAULT_CAPACITY, EVENT_KINDS, NULL_TRACER,
                              TRACE_LEVELS, Event, Tracer)

__all__ = ["DEFAULT_CAPACITY", "EVENT_KINDS", "Event", "NULL_TRACER",
           "TRACE_LEVELS", "Tracer"]
