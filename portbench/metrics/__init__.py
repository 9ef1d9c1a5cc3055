"""Metric readers, one file a metric of BENCHMARK.json, named after it.
Each defines ``read(ctx) -> float | None``; ctx holds the workload, the
driver's readings, the trace summary (traced runs), setup_s, the
window's span and units, and the driver's work counts.  A reader that
finds nothing returns None and the metric is left out of the line."""
