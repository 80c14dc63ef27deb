"""train_mfu: the traced steps' model operations (``flops/<family>.py``
``step_flops``: forward and backward, recompute not counted) over the
device's span of those steps (first operation's start to last one's end)
and the card's published bf16 peak, in percent."""


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    span = t.device_span_s()
    if not peaks or span <= 0 or t.steps <= 0:
        return None
    tr = ctx["traffic"]
    flops = ctx["flops"].step_flops(ctx["config"], tr["batch"], tr["seq_len"])
    return 100.0 * flops * t.steps / span / peaks["bf16_flops_per_s"]
