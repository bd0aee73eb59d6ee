"""A closed loop: ``clients`` clients, each sending its next request when
its last one finishes."""
from __future__ import annotations

from valetbench.harness.drive import Driver, Served, sync

TRACE_WARM_STEPS = 2    # steps under the readied profiler before its trace starts


def top_up(driver: Driver) -> None:
    """Every client whose request finished sends its next."""
    while len(driver.live) < driver.traffic.concurrency:
        driver.submit()


def serve(driver: Driver, seconds: float, device, *,
          trace_steps: int = 0, tracer=None) -> Served:
    """Warm-up steps, then a window of ``seconds`` that ends with the first
    step that ends past it, then ``trace_steps`` more steps under
    ``tracer`` (a factory of ``trace.Tracer``), after ``TRACE_WARM_STEPS``
    steps in which the readied profiler keeps nothing."""
    spec = driver.traffic.spec
    top_up(driver)
    for _ in range(int(spec["warmup_steps"])):
        driver.step("warmup")
        top_up(driver)
    sync(device)
    w0 = driver.clock()
    while True:
        rec = driver.step("window")
        top_up(driver)
        if rec.t1 - w0 >= seconds:
            break
    w1 = rec.t1
    profiled, trace = [], None
    if trace_steps:
        # trace_steps steps, and more (up to four times as many) until one
        # of them prefills, so that the prefill kernels have launches to read
        scope = tracer()
        with scope:
            for _ in range(TRACE_WARM_STEPS):
                driver.step("after")
                top_up(driver)
            scope.start()
            while len(profiled) < 4 * trace_steps:
                rec = driver.step("after", scope=scope.step())
                profiled.append(rec.index)
                with scope.harness():
                    top_up(driver)
                if len(profiled) >= trace_steps and any(
                        driver.steps[i].prefills for i in profiled):
                    break
        trace = scope.data
    return Served(driver.steps, driver.requests, driver.objects, (w0, w1),
                  profiled, trace)
