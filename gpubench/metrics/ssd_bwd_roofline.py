"""ssd_bwd_roofline: the least time one call of the SSD backward could
take at the cell's shapes (``flops/<family>.py`` ``ssd_bwd_cost``), over
the device time of one call: every kernel of the backward (namespace
``ssd_bwd``) summed, over the calls the program counted
(``ssd.bwd_launches``), in percent."""

CALLS = "repro_torch.kernels.ssd_scan.ops:ssd.bwd_launches"
COUNTERS = (CALLS,)


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    calls = ctx["counters"].get(CALLS, 0)
    ops = [o for o in t.ops if "ssd_bwd::" in o.name]
    if not ops or not calls or not peaks:
        return None
    tr = ctx["traffic"]
    flops, nbytes = ctx["flops"].ssd_bwd_cost(ctx["config"], tr["batch"],
                                              tr["seq_len"])
    bound = max(flops / peaks["bf16_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    per_call = sum(o.dur for o in ops) / calls / 1e6
    return 100.0 * bound / per_call
