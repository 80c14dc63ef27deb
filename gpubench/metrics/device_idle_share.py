"""device_idle_share: the share of the traced steps' wall time (host
clock, the profiler on) in which no operation runs on the card, in
percent. Every kernel, copy and set counts as busy, NCCL's too."""


def read(ctx):
    t = ctx["trace"]
    if t.wall_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
