"""recompute_ms: device milliseconds a step of the operations launched
under the program's span ``layer.recompute`` (a layer's forward run again
inside the backward under remat, ``models/transformer.py``
``stack_apply``)."""


def read(ctx):
    t = ctx["trace"]
    busy = t.time_under("layer.recompute")
    if busy <= 0 or t.steps <= 0:
        return None
    return 1e3 * busy / t.steps
