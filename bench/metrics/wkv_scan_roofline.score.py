"""wkv_scan_roofline.score: the least time of the wkv_scan forward calls
of the traced scoring calls, over the device time of the kernel's
launches (its three kernels by name), in %. Each launch of
`wkv_scan_chunk` is one call, priced by costs.wkv_bound_s at the (B, L)
of the scoring call it ran in, with the heads and head size of the
configuration's family (`wkv`) and its zero initial state; None for a
family without the kernel."""
import re

from bench import costs, families
from bench.trace import kernel_seconds, launch_calls

KERNELS = re.compile(r"\bwkv_scan_(state|pass|chunk)\b")
CALLS = re.compile(r"\bwkv_scan_chunk\b")


def read(run):
    tr, calls, a = run.get("trace"), run.get("calls"), run["arch"]
    shape = families.get(a).wkv(a)
    if not tr or not calls or shape is None:
        return None
    secs, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    bound = sum(costs.wkv_bound_s(*calls[j], *shape)
                for j in launch_calls(tr, CALLS) if j >= 0)
    return 100.0 * bound / secs
