"""Run a serialized ExperimentSpec end-to-end from the command line with
the PyTorch port (port of `repro/sim/run.py`):

    PYTHONPATH=src python -m repro_torch.sim.run --spec exp.json \
        [--device cpu] [--metrics-out m.json] [--trace-out trace.json]

The JSON file holds one spec dict (see `ExperimentSpec.to_dict`), plus
an optional top-level ``"smoke_overrides"`` section — a flat mapping of
dotted spec paths to values (e.g. ``{"data.n_clients": 8}``) applied
only under ``--smoke``, so one file carries both the full scenario and
its fast CI variant. ``--set path=value`` applies ad-hoc overrides the
same way (value parsed as JSON, falling back to string). Prints the
structured `RunResult.summary()` as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.sim import Experiment, ExperimentSpec


def apply_override(d: dict, path: str, value) -> None:
    """Set a dotted path inside a nested spec dict, creating missing
    intermediate sections as needed
    (`"network.transport.params.drop_prob"`). A string intermediate is
    the shorthand component form ("gossip": "push") — it expands to
    ``{"name": ..., "params": {}}`` so overriding into it keeps the
    component choice; any other non-dict intermediate is a path error,
    not something to silently replace."""
    keys = path.split(".")
    cur = d
    for i, k in enumerate(keys[:-1]):
        nxt = cur.get(k)
        if isinstance(nxt, str):  # shorthand ComponentSpec
            nxt = cur[k] = {"name": nxt, "params": {}}
        elif nxt is None:
            nxt = cur[k] = {}
        elif not isinstance(nxt, dict):
            raise ValueError(
                f"cannot override {path!r}: {'.'.join(keys[:i + 1])!r} "
                f"is {nxt!r}, not a section")
        cur = nxt
    cur[keys[-1]] = value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.run",
        description="run one JSON-serialized ExperimentSpec end-to-end")
    ap.add_argument("--spec", required=True, metavar="PATH",
                    help="JSON file holding an ExperimentSpec dict")
    ap.add_argument("--smoke", action="store_true",
                    help="apply the file's smoke_overrides section")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="overrides",
                    help="dotted-path spec override, e.g. "
                         "data.n_clients=16 (repeatable)")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="also write the summary JSON to a file")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable observability and write the run's "
                         "metrics frame (strict JSON) to this path")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable observability + event tracing and "
                         "write a Chrome/Perfetto trace-event JSON to "
                         "this path (async event backend only)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    # config errors exit 2 with ONE line naming the file and the
    # offending field — a sweep harness greps stderr, it never wants a
    # traceback for a typo'd spec
    try:
        with open(args.spec) as f:
            raw = json.load(f)
    except OSError as e:
        print(f"error: {args.spec}: {e.strerror or e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: {args.spec}: invalid JSON at line {e.lineno} "
              f"column {e.colno}: {e.msg}", file=sys.stderr)
        return 2
    if not isinstance(raw, dict):
        print(f"error: {args.spec}: expected one ExperimentSpec object, "
              f"got {type(raw).__name__}", file=sys.stderr)
        return 2
    smoke = raw.pop("smoke_overrides", {})
    if args.smoke:
        for path, value in smoke.items():
            apply_override(raw, path, value)
    for kv in args.overrides:
        path, _, value = kv.partition("=")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass  # bare strings stay strings
        apply_override(raw, path, value)

    if args.metrics_out or args.trace_out:
        # the CLI flags are sugar over ObsSpec: enable obs and append
        # the matching sinks on top of whatever the file declares
        apply_override(raw, "obs.enabled", True)
        obs = raw.setdefault("obs", {})
        sinks = list(obs.get("sinks") or [])
        if args.metrics_out:
            sinks.append({"name": "metrics_json",
                          "params": {"path": args.metrics_out}})
        if args.trace_out:
            apply_override(raw, "obs.trace", True)
            sinks.append({"name": "perfetto",
                          "params": {"path": args.trace_out}})
        obs["sinks"] = sinks

    # spec errors, component params and paths not ported yet surface
    # from build() before any training starts
    try:
        spec = ExperimentSpec.from_dict(raw)
        exp = Experiment.from_spec(spec, device=args.device).build()
    except (TypeError, ValueError, NotImplementedError) as e:
        print(f"error: {args.spec}: {e}", file=sys.stderr)
        return 2
    result = exp.run()
    summary = result.summary()
    # summary() is json_ready: allow_nan=False proves no bare NaN/Inf
    # tokens can reach a consumer's strict JSON parser
    print(json.dumps(summary, indent=2, allow_nan=False))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2, allow_nan=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
