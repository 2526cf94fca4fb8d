"""Metric readers, one file a metric or a quantity (``<name>.py``, or
``<name up to its first dot>.py`` for every cell's variant of it), each a
``read(ctx)`` that returns the number, or None where it finds nothing to
read, in which case the harness leaves the metric out. ``ctx`` is a
``port_bench.run.Reading``: the cell, the window's units, its start on the
host clock, the set-up seconds and, in a traced run, the ``Trace``."""
