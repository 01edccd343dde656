"""Observability for the port: the metrics registry and Stopwatch."""
