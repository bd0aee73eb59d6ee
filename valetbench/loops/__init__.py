"""One serving loop per kind of traffic, found by the traffic file's
``kind``: ``<kind>.py`` defines ``serve(driver, seconds, device, *,
trace_steps, tracer)``, which warms the engine up, serves a window of
``seconds`` and then ``trace_steps`` traced steps, and returns the
``drive.Served`` record."""
import importlib


def of(traffic):
    """The loop module of a traffic file's ``kind``."""
    return importlib.import_module(f"valetbench.loops.{traffic['kind']}")
