"""flash_attention_roofline.score: the least time of the flash_attention
calls of the traced scoring calls, over the device time of the kernel's
launches, in %. Each launch of `flash_fwd_bf16_wgmma` or `flash_fwd_f32`
is one call, one attention application of one member's prefill, priced
at the (B, L) of the scoring call it ran in: costs.attention_flops over
the applications a member makes (the family's `attention`), at the
card's bf16 peak. That is the operations bound: 0.1217 ms at (4 prompts,
32 heads, 2048, 112), where the bytes bound (q, k, v and the output
once each, 235 MB) is about 0.07 ms. None where the traced calls
launched no flash kernel (a prefill on the plain path) and for a family
without attention."""
import re

from bench import costs, families
from bench.trace import kernel_seconds, launch_calls

KERNELS = re.compile(r"\bflash_fwd_(bf16_wgmma|f32)\b")


def read(run):
    tr, calls, a = run.get("trace"), run.get("calls"), run["arch"]
    att = families.get(a).attention(a)
    if not tr or not calls or att is None:
        return None
    secs, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    uses = att[0]
    flops = sum(costs.attention_flops(a, *calls[j]) / uses
                for j in launch_calls(tr, KERNELS) if j >= 0)
    return 100.0 * flops / (costs.PEAK_BF16_FLOPS * secs)
