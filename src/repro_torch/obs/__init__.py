"""repro_torch.obs - host-side observability: tracing, metrics, energy
telemetry (port of ``repro.obs``).

Everything here observes from the host side, around the device work:
spans and events read the host clock and never synchronize the device.
The records are the reference's, so either package's ``report.render``
renders a run the other dumped.

    from repro_torch import obs

    with obs.collect("serve-run") as tr:
        with obs.span("serve.batch", batch=8):
            ...
        obs.event("drift.probe", lsb=0.3)
    obs.metrics.histogram("serve.decode_us").record(120.0)
    obs.report.dump_run("run.jsonl", tr, obs.metrics.registry())

Render with ``python -m repro_torch.obs run.jsonl``.
"""

from . import energy, metrics, report, trace
from .energy import PAPER_UJ_PER_INFERENCE, PAPER_US_PER_INFERENCE, energy_report
from .metrics import counter, gauge, histogram, registry, reset_metrics
from .trace import Trace, active_trace, collect, event, log, span, time_block, timeit

__all__ = [
    "trace", "metrics", "energy", "report",
    "Trace", "collect", "active_trace", "span", "event", "log",
    "timeit", "time_block",
    "counter", "gauge", "histogram", "registry", "reset_metrics",
    "energy_report", "PAPER_US_PER_INFERENCE", "PAPER_UJ_PER_INFERENCE",
]
