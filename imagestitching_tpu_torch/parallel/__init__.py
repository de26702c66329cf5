"""Parallel execution of the port: many jobs of one plan in one launch per
placement (``batch``), over a device mesh's ``jobs`` axis, and one job's
canvas in row bands over its ``space`` axis (``mesh``, ``sharding``)."""
