"""One reader a metric of BENCHMARK.json, found by the metric's name
(``.`` and ``-`` read as ``_``): ``read(run) -> float | None``, with ``run``
a ``gpubench.core.cell.Run``.  A reader that finds nothing to read returns
None, and the metric is left out of the result line."""
