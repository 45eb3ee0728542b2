"""One reader a metric, ``<metric name>.py``, each with ``read(run)``:
the metric's value from a run's reading, or None where it finds nothing
to read (then the metric is left out of the line).  ``run`` is
:class:`benchmark.harness.Reading`."""
