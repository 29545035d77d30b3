"""One reader a metric, named by the metric: ``<name>.py`` for an
end-to-end metric, ``<family>.py`` for a per-layer metric
``<family>.<cell>``.  ``read(ctx)`` returns the value, or None where the
run has nothing to read it from.  ``ctx`` holds the run's ``spec`` (the
configuration under ``cfg``) and every rank's record (``ranks``, rank 0
first): what the loop measured (``bench/loops/``), with, traced, what
``trace`` holds: the session's raw counters, each traced call's
``exec_info``, and the profiler's reduction (``bench/trace.py``)."""
