"""adamw_ms: device milliseconds a step of the operations launched under
the optimizer's profiler range ``adamw_update`` (``optim/adamw.py``)."""


def read(ctx):
    t = ctx["trace"]
    busy = t.time_under("adamw_update")
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e3 * busy / t.steps
