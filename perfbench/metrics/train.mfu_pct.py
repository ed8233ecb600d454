"""The whole training step's share of the card's bf16 peak: the FLOPs a
step needs (the configuration's model module: three times the forward's
products, recomputation not counted) at the measured window's untraced
step rate, over the bf16 dense rate of peaks.json, in %."""
from bench import count, train


def read(ctx):
    if not ctx.window_steps_per_s:
        return None
    tr = ctx.cell.traffic
    flops = train.model_module(ctx.config).flops_per_step(
        ctx.config, tr["sequences"], tr["tokens"])
    return 100.0 * flops * ctx.window_steps_per_s / \
        count.peaks()["bf16_flops_per_s"]
