"""One reader per metric: ``read(run) -> float | None``.

``run`` is ``harness.Run``.  A reader that finds nothing to read returns
``None`` and the metric is left out of the run's line; a share of a
roofline or of a peak is never reported as 0 for want of data.
``kernel_bytes`` holds the kernels' logical byte counts.
"""
