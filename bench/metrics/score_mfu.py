"""score_mfu: the model FLOPs that the scoring calls after the traced
stretch need (costs.score_flops: 2 x non-embedding parameters a token,
the scans, attention, the head at each row's last position), over the
host seconds those calls took, against the card's bf16 peak, in %. The
traced stretch itself runs slower under the profiler, so it is left
out."""
from bench import costs


def read(run):
    rest = run.get("after_trace")
    if not run.get("trace") or not rest or not rest["calls"]:
        return None
    a = run["arch"]
    flops = run["members"] * sum(costs.score_flops(a, run["n_body"], B, L)
                                 for B, L in rest["calls"])
    return 100.0 * flops / (rest["seconds"] * costs.PEAK_BF16_FLOPS)
