"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(run) -> float | None`` over ``job.Run``.  A
reader that finds nothing to read returns None, and the metric is left out
of the run's line."""
