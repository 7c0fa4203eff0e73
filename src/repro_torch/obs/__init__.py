"""The flight recorder (port of ``repro.obs``), three layers over one run:

  * :mod:`repro_torch.obs.telemetry`: ``RoundStats``, fixed-shape f32
    per-round telemetry (per-stage wire bytes, staleness histogram, buffer
    fill, residual-store counters, selection and availability counts)
    carried next to the ``CommLedger`` in every engine's metrics when
    ``FLConfig.telemetry`` is on;
  * :mod:`repro_torch.obs.trace`: the host-side tracer, a versioned JSONL
    span / event sink (per-round spans, eval, async flushes, checkpoint)
    and the opt-in ``torch.profiler`` hook around ``run_rounds``;
  * :mod:`repro_torch.obs.report`: ``python -m repro_torch.obs.report
    run.jsonl``, the terminal / markdown run summary.

The package import is lazy: ``trace`` and ``report`` import only the
standard library at module level (torch loads inside the tracer's helpers
that need it), and importing :mod:`repro_torch.obs` loads neither
``telemetry`` nor ``trace`` until one of their names is asked for.
"""
_LAZY = {
    "RoundStats": "telemetry", "TelemetrySpec": "telemetry",
    "round_stats": "telemetry", "telemetry_spec": "telemetry",
    "stage_byte_table": "telemetry", "staleness_hist": "telemetry",
    "zero_stats": "telemetry", "STALENESS_EDGES": "telemetry",
    "N_STALENESS_BUCKETS": "telemetry",
    "Tracer": "trace", "SCHEMA_VERSION": "trace",
    "validate_file": "trace", "validate_record": "trace",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.obs.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
