"""Observability for the port: the metrics registry and Stopwatch
(`metrics`), the run-scoped context, canonical run counters and sinks
(`probes`), and the Chrome/Perfetto trace export (`trace_export`)."""
