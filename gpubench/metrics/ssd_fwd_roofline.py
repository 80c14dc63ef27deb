"""ssd_fwd_roofline: the least time one call of the SSD forward kernel
could take at the cell's shapes (``flops/<family>.py`` ``ssd_fwd_cost``:
the larger of operations over the bf16 peak and bytes over the HBM
peak), over the mean device time of its launches, found by the kernel's
``__global__`` name, in percent."""

NAMES = ("ssd_chunk_tc", "ssd_chunk_simt")


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    ops = [o for o in t.ops if any(n in o.name for n in NAMES)]
    if not ops or not peaks:
        return None
    tr = ctx["traffic"]
    flops, nbytes = ctx["flops"].ssd_fwd_cost(ctx["config"], tr["batch"],
                                              tr["seq_len"])
    bound = max(flops / peaks["bf16_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    mean = sum(o.dur for o in ops) / len(ops) / 1e6
    return 100.0 * bound / mean
