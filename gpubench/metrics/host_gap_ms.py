"""host_gap_ms: milliseconds a step in which the card is idle outside
every span ``trainer.step`` of the program (``runtime/trainer.py``): the
holes between the device's busy intervals, less their overlap with those
spans. The card waits there for the host's batch placement, read-back and
bookkeeping between steps."""


def read(ctx):
    t = ctx["trace"]
    steps = [(o.start, o.end) for ops in t.host.values() for o in ops
             if o.name == "trainer.step"]
    if not steps or t.steps <= 0:
        return None
    busy = t.busy_intervals()
    idle = 0.0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 > e0:
            idle += (s1 - e0) - sum(max(0.0, min(e, s1) - max(s, e0))
                                    for s, e in steps)
    return 1e-3 * idle / t.steps
