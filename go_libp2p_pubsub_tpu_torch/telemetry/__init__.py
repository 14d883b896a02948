"""Telemetry plane: a per-round time series on the device (the port's copy
of the JAX package's ``telemetry/``).

The v1.1 hardening evaluation (arXiv:2007.02754) argues from delivery
ratio, mesh degree and score trajectories, not end-of-run totals. Every
engine step built with a :class:`TelemetryConfig` writes one
``[N_METRICS]`` float32 row an observation into a ``[rows, N_METRICS]``
panel the state carries: no host read inside a run, so a window captures a
recording step as any other, and the event columns reconcile bit for bit
with the drained counters.

  panel — TelemetryConfig/TelemetryState, the metric catalog, the row
          recorder every engine calls as its step's last operation, the
          sampled per-peer flight recorder, and the host reconciliation
          (summed per-row event deltas == drained counters, exactly)
"""

from .panel import (  # noqa: F401
    EV_METRICS,
    FLIGHT_METRICS,
    METRICS,
    N_FLIGHT,
    N_METRICS,
    RECONCILED,
    STATE_METRICS,
    TelemetryConfig,
    TelemetryConfigError,
    TelemetryState,
    metric_index,
    panel_ev_totals,
    reconcile,
    reconcile_batched,
    record_step,
    rows_used,
    timeline_block,
)
