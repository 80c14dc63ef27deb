"""xent_ms: device milliseconds a step of the operations launched under
the fused loss's profiler ranges ``linear_xent`` and
``linear_xent_backward`` (``models/xent.py``)."""


def read(ctx):
    t = ctx["trace"]
    busy = t.time_under("linear_xent", "linear_xent_backward")
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e3 * busy / t.steps
