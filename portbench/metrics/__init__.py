"""Per-layer metric readers, one file per metric of BENCHMARK.json's
`per_layer` (`<metric>.py`, loaded by path), each with `read(run) -> float |
None`: None where the run holds nothing to read, and the harness then leaves
the metric out of the line."""
