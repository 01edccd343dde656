"""ssd_scan_roofline: the least time of the ssd_scan calls of the traced
scoring calls, over the device time of the kernel's launches (its four
kernels by name), in %. Each launch of `ssd_scan_chunk` is one call,
priced by costs.ssd_bound_s at the (B, L) of the scoring call it ran in,
with the heads, head size and state of the configuration."""
import re

from bench import costs
from bench.trace import kernel_seconds, launch_calls

KERNELS = re.compile(r"\bssd_scan_(cb|state|pass|chunk)\b")
CALLS = re.compile(r"\bssd_scan_chunk\b")


def read(run):
    tr, calls, a = run.get("trace"), run.get("calls"), run["arch"]
    if not tr or not calls or a["equations"] != "zamba2":
        return None
    secs, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    hd = a["ssm_head_dim"]
    nh = a["ssm_expand"] * a["d_model"] // hd
    bound = sum(costs.ssd_bound_s(*calls[j], nh, hd, a["ssm_state"])
                for j in launch_calls(tr, CALLS) if j >= 0)
    return 100.0 * bound / secs
