"""ssm_proj_ms: device milliseconds a step of the operations of the
Mamba-2 mixer's projections (the program's spans ``ssm.proj`` and
``ssm.proj.bwd``, ``models/ssm.py``: the five input projections with
dt's float64 path, and ``wo``'s) in the forward, the recompute and the
backward.

An operation belongs to the innermost span of the step, a layer or the
mixer that was open when it was launched: the recompute that a layer's
first saved activation starts inside a ``.bwd`` span counts under its own
parts, or under none. ``part_ms`` is shared by the four ``ssm_*_ms``
readers."""

SCOPES = ("step.", "layer.", "ssm.")


def part_ms(t, part):
    names = (part, part + ".bwd")
    busy = 0.0
    for o in t.ops:
        inner = next((r for r in reversed(o.ranges) if r.startswith(SCOPES)),
                     None)
        if inner in names:
            busy += o.dur
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e-3 * busy / t.steps


def read(ctx):
    return part_ms(ctx["trace"], "ssm.proj")
