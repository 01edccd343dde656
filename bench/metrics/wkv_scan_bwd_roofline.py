"""wkv_scan_bwd_roofline: the least time of the traced steps' wkv_scan
backward calls, over the device time of its four kernels by name, in %.
Each launch of `wkv_scan_bwd_chunk` is one call (a layer, a
microbatch), priced by costs.wkv_bwd_bound_s at a microbatch's (B, S)
with the heads and head size of the configuration's family (`wkv`);
None for a family without the kernel."""
import re

from bench import costs, families
from bench.trace import kernel_seconds, launch_calls

KERNELS = re.compile(r"\bwkv_scan_bwd_(state|pass|chunk|du)\b")
CALLS = re.compile(r"\bwkv_scan_bwd_chunk\b")


def read(run):
    tr, n, a = run.get("trace"), run.get("steps"), run["arch"]
    shape = families.get(a).wkv(a)
    if not tr or not n or shape is None:
        return None
    secs, launches = kernel_seconds(tr, KERNELS)
    if not launches:
        return None
    B, S = run["microbatch"]
    calls = len(launch_calls(tr, CALLS))
    return 100.0 * calls * costs.wkv_bwd_bound_s(B, S, *shape) / secs
