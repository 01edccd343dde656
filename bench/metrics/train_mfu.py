"""train_mfu: 6 x (non-embedding + head parameters) x the tokens of the
steps after the traced stretch (recompute not counted), over the host
seconds those steps took (ending in a sync), against the card's bf16
peak, in %. The traced stretch itself runs slower under the profiler,
so it is left out."""
from bench import costs


def read(run):
    rest = run.get("after_trace")
    if not run.get("trace") or not rest or not rest["steps"]:
        return None
    flops = costs.train_flops(run["n_body_and_head"],
                              rest["steps"] * run["tokens_per_step"])
    return 100.0 * flops / (rest["seconds"] * costs.PEAK_BF16_FLOPS)
