"""One reader per metric of ``BENCHMARK.json``, found by the metric's name:
``<name>.py`` defines ``read(run)``, which returns the metric's value or
None when the run holds nothing to read, and ``DEVICE``, true when the
value is a time or a share of the card (never reported from a CPU run)."""
