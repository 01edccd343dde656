"""The replint rule catalog (DESIGN.md §13): AST passes over one file.

Every rule here machine-checks a contract this repo already states in
prose — bit-identical reruns, wall-clock purity of virtual-time code,
strict JSON exports, loud unknown-param failures, jit tracing hygiene —
so these invariants stop being re-litigated in review.

RNG-DET and JIT-HYGIENE also check torch code (files that import
torch): draws from torch's global generator and entropy seeding, and
host-sync Python inside torch's compiled or captured regions. Files that
do not import torch get exactly the reference replint's diagnostics.

Name resolution: each `FileContext` records the file's import aliases
(``import numpy as np`` -> ``np`` = ``numpy``) and resolves attribute
chains through them, so ``np.random.default_rng`` and
``numpy.random.default_rng`` are the same call to every rule, and a
local variable that merely shadows ``random`` is not.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.registry import Rule, rule


class FileContext:
    """One parsed Python file: source, AST, and the import-alias map
    used for dotted-name resolution."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace("\\", "/")
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        # one walk of the tree, in ast.walk's order, shared by every rule
        self.nodes = list(ast.walk(self.tree))
        self.calls = [n for n in self.nodes if isinstance(n, ast.Call)]
        self.aliases = _collect_imports(self.tree)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression (`np.random.rand` ->
        ``numpy.random.rand``), or None for non-name expressions."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def imported(self, module: str) -> bool:
        return module in self.aliases.values() or any(
            v.startswith(module + ".") for v in self.aliases.values())


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{mod}.{a.name}"
    return aliases


def _calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---- RNG-DET -----------------------------------------------------------

_NP_RNG_CONSTRUCTORS = {"default_rng", "Generator", "RandomState",
                        "SeedSequence", "PCG64", "Philox", "MT19937",
                        "bit_generator"}
_PY_RANDOM_OK = {"Random", "getstate", "setstate"}
# torch draws that take a generator= (the *_like forms included)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}
# in-place Tensor draws
_TORCH_INPLACE = {"uniform_", "normal_", "bernoulli_", "exponential_",
                  "random_", "cauchy_", "log_normal_", "geometric_"}
# torch.nn.init's initializers that draw nothing
_TORCH_INIT_FIXED = {"zeros_", "ones_", "constant_", "eye_", "dirac_"}
# seeding from OS entropy
_TORCH_ENTROPY = {"torch.seed", "torch.random.seed", "torch.cuda.seed",
                  "torch.cuda.seed_all", "torch.cuda.random.seed",
                  "torch.cuda.random.seed_all"}
_GEN_HINT = "pass generator=torch.Generator(device).manual_seed(seed)"


@rule("RNG-DET")
class RngDet(Rule):
    contract = ("every RNG derives from an explicit seed expression — "
                "no unseeded default_rng(), no module-level np.random.* "
                "or random.* global-state draws; in torch code no draw "
                "from torch's global generator (no generator=) and no "
                "entropy seeding (torch.seed(), a generator's .seed())")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        if ctx.imported("torch"):
            yield from self._check_torch(ctx)
        for call in ctx.calls:
            name = ctx.resolve(call.func)
            if name is None:
                continue
            if name.startswith("numpy.random."):
                tail = name.split(".")[-1]
                if tail in _NP_RNG_CONSTRUCTORS:
                    if _unseeded(call):
                        yield self._d(ctx, call,
                                      f"unseeded numpy.random.{tail}() — "
                                      "pass an explicit seed expression")
                else:
                    yield self._d(ctx, call,
                                  f"module-level numpy.random.{tail} "
                                  "draws from hidden global state — "
                                  "use a seeded default_rng(seed)")
            elif (name.startswith("random.")
                  and ctx.aliases.get("random") == "random"):
                tail = name.split(".")[-1]
                if tail == "Random":
                    if _unseeded(call):
                        yield self._d(ctx, call,
                                      "unseeded random.Random() — pass "
                                      "an explicit seed")
                elif tail == "SystemRandom":
                    yield self._d(ctx, call,
                                  "random.SystemRandom draws OS entropy "
                                  "— unreproducible by construction")
                elif tail not in _PY_RANDOM_OK:
                    yield self._d(ctx, call,
                                  f"module-level random.{tail} draws "
                                  "from hidden global state — use a "
                                  "seeded random.Random(seed)")

    def _check_torch(self, ctx: FileContext) -> Iterator[Diagnostic]:
        for call in ctx.calls:
            name = ctx.resolve(call.func)
            if name in _TORCH_ENTROPY:
                yield self._d(ctx, call,
                              f"{name}() seeds from OS entropy — "
                              "unreproducible by construction; use "
                              "manual_seed(seed)")
                continue
            if any(k.arg == "generator" for k in call.keywords):
                continue
            if name is not None and name.startswith("torch."):
                tail = name.split(".")[-1]
                if name == f"torch.{tail}" and tail in _TORCH_DRAWS:
                    yield self._d(ctx, call,
                                  f"torch.{tail}() without generator= "
                                  "draws from torch's global generator "
                                  f"— {_GEN_HINT}")
                elif name.startswith("torch.nn.init.") \
                        and tail.endswith("_") \
                        and tail not in _TORCH_INIT_FIXED \
                        or tail in _TORCH_INPLACE:
                    yield self._d(ctx, call,
                                  f"{name}() without generator= draws "
                                  "from torch's global generator — "
                                  f"{_GEN_HINT}")
                continue
            if not isinstance(call.func, ast.Attribute) or (
                    name is not None
                    and name.startswith(("numpy.", "random."))):
                continue    # the module-level checks below own these
            attr = call.func.attr
            if attr in _TORCH_INPLACE:
                yield self._d(ctx, call,
                              f"in-place .{attr}() without generator= "
                              "draws from torch's global generator — "
                              f"{_GEN_HINT}")
            elif attr == "seed" and not call.args and not call.keywords:
                yield self._d(ctx, call,
                              ".seed() reseeds a generator from OS "
                              "entropy — unreproducible by "
                              "construction; use manual_seed(seed)")

    def _d(self, ctx, node, msg):
        return Diagnostic(ctx.rel, node.lineno, node.col_offset,
                          self.id, msg)


def _unseeded(call: ast.Call) -> bool:
    if call.keywords:
        return False
    if not call.args:
        return True
    a = call.args[0]
    return isinstance(a, ast.Constant) and a.value is None


# ---- WALLCLOCK ---------------------------------------------------------

_WALL_CALLS = {"time.time", "time.time_ns", "time.perf_counter",
               "time.perf_counter_ns", "time.monotonic",
               "time.monotonic_ns", "time.process_time",
               "time.process_time_ns"}
_WALL_DT_TAILS = {"now", "utcnow", "today"}
# the ONE place the perf_counter idiom may live (obs.Stopwatch)
_WALL_ALLOWED_SUFFIX = "obs/metrics.py"


@rule("WALLCLOCK")
class WallClock(Rule):
    contract = ("virtual-time code is wall-clock pure: no time.time / "
                "datetime.now / bare perf_counter outside obs/metrics.py"
                " — bracket with obs.Stopwatch")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        if ctx.rel.endswith(_WALL_ALLOWED_SUFFIX):
            return
        for call in ctx.calls:
            name = ctx.resolve(call.func)
            if name is None:
                continue
            if name in _WALL_CALLS or (
                    name.startswith("datetime.")
                    and name.split(".")[-1] in _WALL_DT_TAILS):
                yield Diagnostic(
                    ctx.rel, call.lineno, call.col_offset, self.id,
                    f"{name}() outside obs/metrics.py — use "
                    "obs.Stopwatch (the one perf_counter idiom) or "
                    "virtual time")


# ---- STRICT-JSON -------------------------------------------------------


@rule("STRICT-JSON")
class StrictJson(Rule):
    contract = ("every json.dump(s) passes allow_nan=False or routes "
                "its payload through obs.metrics.json_ready")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        for call in ctx.calls:
            name = ctx.resolve(call.func)
            if name not in ("json.dump", "json.dumps"):
                continue
            allow_nan = None
            for k in call.keywords:
                if k.arg == "allow_nan":
                    allow_nan = k.value
            if allow_nan is not None:
                if isinstance(allow_nan, ast.Constant) \
                        and allow_nan.value is True:
                    yield Diagnostic(
                        ctx.rel, call.lineno, call.col_offset, self.id,
                        f"{name}(allow_nan=True) — bare NaN tokens "
                        "reject under strict parsers")
                continue  # explicit allow_nan=<expr>: deliberate
            if call.args and _routes_json_ready(ctx, call.args[0]):
                continue
            yield Diagnostic(
                ctx.rel, call.lineno, call.col_offset, self.id,
                f"{name}() without allow_nan=False — pass it, or route "
                "the payload through obs.metrics.json_ready")


def _routes_json_ready(ctx: FileContext, arg: ast.AST) -> bool:
    if not isinstance(arg, ast.Call):
        return False
    name = ctx.resolve(arg.func)
    return name is not None and name.split(".")[-1] == "json_ready"


# ---- REG-STRICT --------------------------------------------------------

_VALIDATOR_TAILS = {"check_params", "config_from_params"}


@rule("REG-STRICT")
class RegStrict(Rule):
    contract = ("every sim-registry builder validates its params via "
                "config_from_params / check_params / a from_params "
                "classmethod — unknown spec keys must raise, not "
                "silently default")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        defs: Dict[str, ast.FunctionDef] = {}
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
        # decorator form: @register(kind, name)
        for fn in defs.values():
            for dec in fn.decorator_list:
                if _is_register_call(ctx, dec):
                    if not _validates(ctx, fn):
                        yield self._d(ctx, fn)
        # call form: register(kind, name)(local_fn)
        for call in ctx.calls:
            if (isinstance(call.func, ast.Call)
                    and _is_register_call(ctx, call.func)
                    and call.args
                    and isinstance(call.args[0], ast.Name)):
                fn = defs.get(call.args[0].id)
                if fn is not None and not _validates(ctx, fn):
                    yield self._d(ctx, fn)

    def _d(self, ctx, fn):
        return Diagnostic(
            ctx.rel, fn.lineno, fn.col_offset, self.id,
            f"registered builder {fn.name!r} never validates params — "
            "call check_params / config_from_params or delegate to a "
            "from_params classmethod")


def _is_register_call(ctx: FileContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or len(node.args) < 2:
        return False
    name = ctx.resolve(node.func)
    return name is not None and name.split(".")[-1] == "register"


def _validates(ctx: FileContext, fn: ast.AST) -> bool:
    for call in _calls(fn):
        name = ctx.resolve(call.func)
        if name is not None and name.split(".")[-1] in _VALIDATOR_TAILS:
            return True
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "from_params":
            return True
    return False


# ---- JIT-HYGIENE -------------------------------------------------------

_CASTS = {"float", "int", "bool"}
_NP_HOST = {"numpy.asarray", "numpy.array"}


@rule("JIT-HYGIENE")
class JitHygiene(Rule):
    contract = ("no Python casts on traced values, .item(), "
                "np.asarray, host RNG, or print inside @jax.jit "
                "functions and lax.scan bodies; nor those or .tolist() / "
                ".cpu() / .numpy() inside torch's compiled or captured "
                "regions (@torch.compile, torch.compile(fn), "
                "@torch.jit.script, torch.cuda.make_graphed_callables, "
                "with torch.cuda.graph(...))")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        jitted: List[Tuple[ast.AST, Set[str]]] = []
        defs: Dict[str, ast.AST] = {}
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
                static = _jit_static_names(ctx, node)
                if static is not None:
                    jitted.append((node, static))
        # lax.scan body functions: every parameter is traced
        seen = {id(fn) for fn, _ in jitted}
        for call in ctx.calls:
            name = ctx.resolve(call.func)
            if name in ("jax.lax.scan", "lax.scan") and call.args \
                    and isinstance(call.args[0], ast.Name):
                fn = defs.get(call.args[0].id)
                if fn is not None and id(fn) not in seen:
                    seen.add(id(fn))
                    jitted.append((fn, set()))
        for fn, static in jitted:
            traced = {a.arg for a in _all_args(fn)
                      if a.arg not in static and a.arg != "self"}
            yield from self._check_body(ctx, fn, traced)
        if ctx.imported("torch"):
            for region, traced in _torch_regions(ctx, defs):
                yield from self._check_torch_body(ctx, region, traced)

    def _check_body(self, ctx, fn, traced: Set[str]
                    ) -> Iterator[Diagnostic]:
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                traced = traced | {a.arg for a in _all_args(node)}
        for call in _calls(fn):
            name = ctx.resolve(call.func)
            if name in _CASTS and name not in ctx.aliases \
                    and call.args \
                    and (_names_in(call.args[0]) & traced):
                yield self._d(ctx, call,
                              f"Python {name}() on a traced value "
                              "forces host sync under jit — keep it "
                              "a jax array (or mark the arg static)")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "item" and not call.args:
                yield self._d(ctx, call,
                              ".item() inside a jitted function forces "
                              "device sync — return the array instead")
            elif name in _NP_HOST and call.args \
                    and (_names_in(call.args[0]) & traced):
                yield self._d(ctx, call,
                              f"{name} materializes a traced value on "
                              "host — use jnp inside jit")
            elif name is not None and (
                    name.startswith("numpy.random.")
                    or (name.startswith("random.")
                        and ctx.aliases.get("random") == "random")):
                yield self._d(ctx, call,
                              "host RNG inside a jitted function is "
                              "baked in at trace time — thread a "
                              "jax.random key instead")
            elif name == "print":
                yield self._d(ctx, call,
                              "print inside a jitted function runs at "
                              "trace time only — use jax.debug.print")

    def _check_torch_body(self, ctx, region, traced: Set[str]
                          ) -> Iterator[Diagnostic]:
        where = "inside a compiled or captured torch region"
        for node in ast.walk(region):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not region:
                traced = traced | {a.arg for a in _all_args(node)}
        for call in _calls(region):
            name = ctx.resolve(call.func)
            if name in _CASTS and name not in ctx.aliases \
                    and call.args \
                    and (_names_in(call.args[0]) & traced):
                yield self._d(ctx, call,
                              f"Python {name}() on a tensor {where} "
                              "forces a host sync (a graph break under "
                              "torch.compile, an error under CUDA graph "
                              "capture) — keep it a tensor")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _TORCH_HOST and not call.args:
                yield self._d(ctx, call,
                              f".{call.func.attr}() {where} copies to "
                              "the host and syncs the device — keep the "
                              "value a device tensor")
            elif name in _NP_HOST and call.args \
                    and (_names_in(call.args[0]) & traced):
                yield self._d(ctx, call,
                              f"{name} materializes a tensor on the host "
                              f"{where} — use torch ops")
            elif name is not None and (
                    name.startswith("numpy.random.")
                    or (name.startswith("random.")
                        and ctx.aliases.get("random") == "random")):
                yield self._d(ctx, call,
                              f"host RNG {where} is fixed when the region "
                              "is traced or captured — draw on the "
                              "device from a seeded torch.Generator")
            elif name == "print":
                yield self._d(ctx, call,
                              f"print {where} runs when the region is "
                              "traced or captured, not when it replays "
                              "— return the value and print outside")

    def _d(self, ctx, node, msg):
        return Diagnostic(ctx.rel, node.lineno, node.col_offset,
                          self.id, msg)


_TORCH_HOST = {"item", "tolist", "cpu", "numpy"}
_TORCH_COMPILE = {"torch.compile", "torch.jit.script"}


def _torch_regions(ctx: FileContext, defs: Dict[str, ast.AST]
                   ) -> Iterator[Tuple[ast.AST, Set[str]]]:
    """(region, traced names) of every torch compiled or captured region:
    functions under @torch.compile / @torch.compile(...) /
    @torch.jit.script, functions passed by name to torch.compile or
    torch.jit.script, callables passed by name to
    torch.cuda.make_graphed_callables (all parameters traced), and the
    bodies of ``with torch.cuda.graph(...)`` (the enclosing function's
    parameters and the names the body assigns traced)."""
    seen: Set[int] = set()

    def fn_region(fn):
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            yield fn, {a.arg for a in _all_args(fn) if a.arg != "self"}

    for fn in defs.values():
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if ctx.resolve(target) in _TORCH_COMPILE:
                yield from fn_region(fn)
    for call in ctx.calls:
        name = ctx.resolve(call.func)
        if not call.args:
            continue
        first = call.args[0]
        if name in _TORCH_COMPILE and isinstance(first, ast.Name):
            yield from fn_region(defs.get(first.id))
        elif name == "torch.cuda.make_graphed_callables":
            elts = first.elts if isinstance(first, (ast.Tuple, ast.List)) \
                else [first]
            for e in elts:
                if isinstance(e, ast.Name):
                    yield from fn_region(defs.get(e.id))
    yield from _graph_bodies(ctx, ctx.tree, set())


def _graph_bodies(ctx: FileContext, node: ast.AST, params: Set[str]
                  ) -> Iterator[Tuple[ast.AST, Set[str]]]:
    """The ``with torch.cuda.graph(...)`` bodies under `node`, each with
    its innermost enclosing function's parameters and the names the body
    assigns as traced."""
    for child in ast.iter_child_nodes(node):
        inner = params
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = {a.arg for a in _all_args(child) if a.arg != "self"}
        elif isinstance(child, (ast.With, ast.AsyncWith)) and any(
                isinstance(i.context_expr, ast.Call)
                and ctx.resolve(i.context_expr.func) == "torch.cuda.graph"
                for i in child.items):
            body = ast.Module(body=child.body, type_ignores=[])
            assigned = {t.id for t in ast.walk(body)
                        if isinstance(t, ast.Name)
                        and isinstance(t.ctx, ast.Store)}
            yield body, params | assigned
        yield from _graph_bodies(ctx, child, inner)


def _all_args(fn) -> list:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


def _jit_static_names(ctx: FileContext, fn) -> Optional[Set[str]]:
    """The static-argument names of a jit-decorated function, or None
    when the function is not jitted. Handles @jax.jit, @jax.jit(...)
    and @functools.partial(jax.jit, static_arg{names,nums}=...)."""
    for dec in fn.decorator_list:
        name = ctx.resolve(dec)
        if name in ("jax.jit", "jit"):
            return set()
        if not isinstance(dec, ast.Call):
            continue
        fname = ctx.resolve(dec.func)
        kws = None
        if fname in ("jax.jit", "jit"):
            kws = dec.keywords
        elif fname in ("functools.partial", "partial") and dec.args \
                and ctx.resolve(dec.args[0]) in ("jax.jit", "jit"):
            kws = dec.keywords
        if kws is None:
            continue
        static: Set[str] = set()
        args = _all_args(fn)
        for k in kws:
            if k.arg == "static_argnames":
                static |= set(_str_elts(k.value))
            elif k.arg == "static_argnums":
                for i in _int_elts(k.value):
                    if 0 <= i < len(args):
                        static.add(args[i].arg)
        return static
    return None


def _str_elts(node) -> Iterator[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _str_elts(e)


def _int_elts(node) -> Iterator[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _int_elts(e)


# ---- SET-ITER ----------------------------------------------------------

_SET_OPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference"}
# deterministic consumers: wrapping one of these launders the order away
_ORDER_SAFE = {"sorted", "len", "min", "max", "sum", "any", "all",
               "frozenset", "set"}


@rule("SET-ITER")
class SetIter(Rule):
    contract = ("no iteration over set values — insertion-order "
                "nondeterminism leaks into event scheduling and RNG "
                "consumption; wrap in sorted()")

    def check_file(self, ctx: FileContext) -> Iterator[Diagnostic]:
        yield from self._scope(ctx, ctx.tree.body)

    def _scope(self, ctx, body) -> Iterator[Diagnostic]:
        setvars: Set[str] = set()
        nested = []
        for stmt in body:
            for node in _walk_scope(stmt, nested):
                if isinstance(node, ast.Assign):
                    if self._is_set(ctx, node.value, setvars):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                setvars.add(t.id)
                elif isinstance(node, ast.AugAssign):
                    if isinstance(t := node.target, ast.Name) \
                            and (t.id in setvars
                                 or self._is_set(ctx, node.value,
                                                 setvars)):
                        setvars.add(t.id)
        for stmt in body:
            for node in _walk_scope(stmt, []):
                yield from self._check_node(ctx, node, setvars)
        for fn in nested:
            yield from self._scope(ctx, _nested_body(fn))

    def _check_node(self, ctx, node, setvars) -> Iterator[Diagnostic]:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if self._is_set(ctx, node.iter, setvars):
                yield self._d(ctx, node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if self._is_set(ctx, gen.iter, setvars):
                    yield self._d(ctx, gen.iter)
        elif isinstance(node, ast.Call):
            name = ctx.resolve(node.func)
            if name in ("list", "tuple", "enumerate", "iter") \
                    and node.args \
                    and self._is_set(ctx, node.args[0], setvars):
                yield self._d(ctx, node.args[0])

    def _is_set(self, ctx, node, setvars: Set[str]) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Name):
            return node.id in setvars
        if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_OPS):
            return (self._is_set(ctx, node.left, setvars)
                    or self._is_set(ctx, node.right, setvars))
        if isinstance(node, ast.Call):
            name = ctx.resolve(node.func)
            if name in ("set", "frozenset"):
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SET_METHODS:
                return self._is_set(ctx, node.func.value, setvars)
        return False

    def _d(self, ctx, node):
        return Diagnostic(
            ctx.rel, node.lineno, node.col_offset, self.id,
            "iteration over a set is insertion-order nondeterministic "
            "— wrap in sorted() or keep a list/dict")


def _walk_scope(node, nested: list) -> Iterator[ast.AST]:
    """Walk `node` without descending into nested function/class
    bodies; collects the nested defs into `nested`."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(child)
            # decorators/defaults evaluate in the enclosing scope
            for d in child.decorator_list:
                yield from _walk_scope(d, nested)
        elif isinstance(child, ast.ClassDef):
            nested.extend([child])  # class body is its own scope
        elif isinstance(child, ast.Lambda):
            nested.append(child)
        else:
            yield from _walk_scope(child, nested)


# classes and lambdas reuse the function-scope pass
def _nested_body(node) -> list:
    if isinstance(node, ast.Lambda):
        return [node.body]
    return node.body
