"""replint: AST-based repo-invariant checker (DESIGN.md §13), the port's
copy (of `repro/analysis`), with torch forms of RNG-DET and JIT-HYGIENE.

A pluggable static-analysis pass with a rule registry mirroring the sim
component registry: rules register by id, lint runs yield
``path:line:col RULE-ID message`` diagnostics, inline comments
(``# replint: ok[RULE-ID] reason``) suppress individual findings, and
``--json`` emits the machine-readable report CI uploads.

Shipped rules — each one machine-checks a contract the repo already
relies on:

  RNG-DET      every RNG derives from an explicit seed expression; in a
               file that imports torch, also no draw from torch's global
               generator (torch.rand*/randn*/randint*/randperm/normal/
               bernoulli/multinomial/poisson, in-place Tensor.uniform_
               and kin, torch.nn.init's random initializers, without
               generator=) and no entropy seeding (torch.seed(),
               torch.cuda.seed(), a generator's .seed())
  WALLCLOCK    virtual-time code is wall-clock pure (obs.Stopwatch is
               the one perf_counter idiom)
  STRICT-JSON  every json.dump(s) is strict (allow_nan=False or
               json_ready-routed)
  REG-STRICT   every sim-registry builder rejects unknown params
  JIT-HYGIENE  no host-sync Python (casts/.item()/np.asarray/RNG/print)
               inside jitted functions or lax.scan bodies, nor (also
               .tolist()/.cpu()/.numpy()) inside torch's compiled or
               captured regions: @torch.compile, torch.compile(fn),
               @torch.jit.script, torch.cuda.make_graphed_callables and
               ``with torch.cuda.graph(...)`` bodies
  SET-ITER     no iteration over set values (insertion-order
               nondeterminism)
  OBS-PARITY   emitted metric names == the DESIGN.md §11 namespace
               table (cross-artifact, both directions)

On files that do not import torch the diagnostics are the reference
replint's (`python -m repro.analysis`), line for line.

Usage: ``python -m repro_torch.analysis [--strict] [--json report.json]
src tests examples benchmarks``, or `lint_paths` from Python.
"""
from repro_torch.analysis import parity, rules  # noqa: F401  (register)
from repro_torch.analysis.diagnostics import Diagnostic, Suppression
from repro_torch.analysis.registry import (Rule, all_rules, known, resolve,
                                           rule)
from repro_torch.analysis.runner import Report, lint_paths

__all__ = ["Diagnostic", "Suppression", "Rule", "rule", "known",
           "resolve", "all_rules", "Report", "lint_paths"]
