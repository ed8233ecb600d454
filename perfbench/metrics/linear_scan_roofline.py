"""The scan forward's least time a call (the configuration's model module
counts its FLOPs and bytes at the cell's shapes; the larger of the FLOPs
at the card's bf16 rate and the bytes at its HBM rate) over the device
time a call of ``linear_scan_kernel`` (the 'scan' class of
kernel_classes.json), over the calls that lie whole in the traced
sub-window, in %."""
from bench import count, train


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [e for e in ctx.trace.events if e.cls == "scan" and e.whole]
    busy = sum(e.end - e.start for e in calls) * 1e-6
    if not calls or busy <= 0:
        return None
    tr = ctx.cell.traffic
    flops, nbytes = train.model_module(ctx.config).scan_call_work(
        ctx.config, tr["sequences"], tr["tokens"])
    pk = count.peaks()
    least = max(flops / pk["bf16_flops_per_s"], nbytes / pk["bytes_per_s"])
    return 100.0 * least * len(calls) / busy
