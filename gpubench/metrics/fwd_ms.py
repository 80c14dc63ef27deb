"""fwd_ms: device milliseconds a step of the operations launched under
the program's span ``step.fwd`` (the loss's forward, ``core/overlap.py``
``value_and_grad``; the spans are ``runtime/tracing.py``'s)."""


def read(ctx):
    t = ctx["trace"]
    busy = t.time_under("step.fwd")
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e3 * busy / t.steps
