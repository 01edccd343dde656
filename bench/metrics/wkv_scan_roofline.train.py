"""wkv_scan_roofline.train: the least time of the traced steps' wkv_scan
forward calls, over the device time of the kernel's three forward
kernels by name, in %. Each launch of `wkv_scan_chunk` is one call (a
layer's forward or the checkpoint's recompute of it, a microbatch),
priced by costs.wkv_bound_s at a microbatch's (B, S) with the heads and
head size of the configuration's family (`wkv`) and its zero initial
state; None for a family without the kernel."""
import re

from bench import costs, families
from bench.trace import kernel_seconds, launch_calls

KERNELS = re.compile(r"\bwkv_scan_(state|pass|chunk)\b")
CALLS = re.compile(r"\bwkv_scan_chunk\b")


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
    return 100.0 * calls * costs.wkv_bound_s(B, S, *shape) / secs
