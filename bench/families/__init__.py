"""One module a model family, `families/<equations>.py`, found by the
configuration's `as_run["equations"]`. Each holds what the harness knows
of that family and nothing else does:

- `layout(a)`: [(name, shape, kind)] of one member, in draw order
  (`weights.py` draws and scales them);
- `blocks(a)`: [(block function, name prefix)] of its float32 reference
  forward, in the order the equations apply them (`reference/models.py`
  runs them; the shared equations are `reference/layers.py`'s);
- `applied(a)`: the non-embedding, non-head parameters a token passes
  through in one member's forward;
- `scan_flops(a, B, S)`: its scans' least FLOP of one member's forward;
- `attention(a)`: (applications a member, query heads, KV heads,
  head_dim) of its causal self-attention, or None;
- `ssd(a)`: (heads, head size, state, B/C groups) of its ssd_scan calls,
  or None; `wkv(a)`: (heads, head size) of its wkv_scan calls, or None;
- optionally `NORMALS`, its own init kinds as {kind: (mean, std)}.

A new family is a new file here; nothing outside this directory names
one.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parent


def get(arch: dict, root: Path | None = None):
    """The family module of a configuration's `as_run` block, from `root`
    (this directory when None)."""
    name = harness.check_name(arch["equations"], "equations")
    return _load(str(Path(root or ROOT) / f"{name}.py"))


@functools.lru_cache(maxsize=None)
def _load(path: str):
    return harness.load(Path(path), "bench_family_"
                        + re.sub(r"\W", "_", Path(path).stem))
