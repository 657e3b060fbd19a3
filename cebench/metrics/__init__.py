"""Per-layer metric readers, one module per metric family: ``read(run,
name)`` returns the metric's number, or None when there is nothing to
read."""
