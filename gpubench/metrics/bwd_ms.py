"""bwd_ms: device milliseconds a step of the operations launched under
the program's span ``step.bwd`` (from the start of the loss's backward to
the end of its graph task, on autograd's device thread) and not under
``layer.recompute``."""


def read(ctx):
    t = ctx["trace"]
    busy = sum(o.dur for o in t.ops if "step.bwd" in o.ranges
               and "layer.recompute" not in o.ranges)
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e-3 * busy / t.steps
