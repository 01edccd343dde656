"""The port's replint (`repro_torch.analysis`) against the reference's
(`repro.analysis`).

Every lint fixture of tests/test_analysis.py (read from that file's AST,
so a fixture added there is covered here) goes through both replints,
which must give identical diagnostic lists: rule, place, message and
severity. Each torch form of RNG-DET and JIT-HYGIENE has a firing
fixture, which fires in the port's replint only, and a clean twin, which
neither fires on. The repo itself passes the port's replint under
--strict, as the reference's gate (tests/test_analysis.py) holds it to
the reference's.
"""
from __future__ import annotations

import ast
import os
import textwrap

import pytest

from repro_torch.analysis import known as tknown
from repro_torch.analysis import lint_paths as tlint
from repro_torch.analysis.cli import main as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TESTS = os.path.join(REPO, "tests", "test_analysis.py")


def _fixtures():
    """(case id, source, file name, strict) of every
    `lint_src(tmp_path, <source>, ...)` call in tests/test_analysis.py
    and of every file its CLI test writes (`(tmp_path / "x.py")
    .write_text(<source>)`), and that file's module-level string
    constants (the OBS-PARITY project fixtures)."""
    with open(REF_TESTS, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant)
              and isinstance(n.value.value, str)
              for t in n.targets if isinstance(t, ast.Name)}
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        local = {t.id: n.value.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Constant)
                 and isinstance(n.value.value, str)
                 for t in n.targets if isinstance(t, ast.Name)}
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)]
        for i, call in enumerate(calls):
            func = call.func
            if isinstance(func, ast.Name) and func.id == "lint_src":
                src = call.args[1]
                kw = {k.arg: k.value.value for k in call.keywords
                      if isinstance(k.value, ast.Constant)}
                name, strict = kw.get("name", "mod.py"), kw.get("strict")
            elif isinstance(func, ast.Attribute) \
                    and func.attr == "write_text" \
                    and isinstance(func.value, ast.BinOp) \
                    and isinstance(func.value.right, ast.Constant) \
                    and str(func.value.right.value).endswith(".py"):
                src, name, strict = call.args[0], func.value.right.value, \
                    False
            else:
                continue
            if isinstance(src, ast.Name):
                if src.id not in local:
                    continue    # _parity_project's own argument
                src = ast.Constant(local[src.id])
            if not isinstance(src, ast.Constant):
                continue
            src = src.value
            out.append((f"{fn.name}[{i}]", src, name, bool(strict)))
    return out, consts


FIXTURES, CONSTS = _fixtures()


@pytest.fixture(scope="module")
def ref_lint():
    from repro.analysis import lint_paths
    return lint_paths


def _both(tmp_path, ref_lint, source, name="mod.py", strict=False):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    args = dict(root=str(tmp_path), strict=strict)
    return (ref_lint([str(f)], **args).diagnostics,
            tlint([str(f)], **args).diagnostics)


def _same(a, b):
    return [d.to_dict() for d in a] == [d.to_dict() for d in b]


def test_fixtures_were_found():
    assert len(FIXTURES) >= 28
    assert {"_PROBES", "_DESIGN"} <= set(CONSTS)


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_reference_fixture_same_diagnostics(tmp_path, ref_lint, case):
    _, source, name, strict = case
    want, got = _both(tmp_path, ref_lint, source, name, strict)
    assert _same(want, got), (want, got)


@pytest.mark.parametrize("variant", ["in_sync", "code_not_in_doc",
                                     "doc_not_in_code", "no_design",
                                     "without_probes"])
def test_obs_parity_fixture_same_diagnostics(tmp_path, ref_lint, variant):
    probes, design = CONSTS["_PROBES"], CONSTS["_DESIGN"]
    if variant == "code_not_in_doc":
        probes += "\n\ndef extra(mx):\n    mx.inc('net.rogue', 1)\n"
    elif variant == "doc_not_in_code":
        design += "| `net.ghost` | counter | - | nowhere |\n"
    elif variant == "no_design":
        design = None
    d = tmp_path / "obs"
    d.mkdir()
    (d / ("probes.py" if variant != "without_probes" else "other.py")
     ).write_text(probes)
    if design is not None:
        (tmp_path / "DESIGN.md").write_text(design)
    want = ref_lint([str(d)], root=str(tmp_path)).diagnostics
    got = tlint([str(d)], root=str(tmp_path)).diagnostics
    assert _same(want, got), (want, got)
    assert (variant in ("in_sync", "without_probes")) == (got == [])


def test_same_rule_catalog():
    from repro.analysis import known
    assert tknown() == known()


# ---- the torch forms: each fires in the port only, its twin nowhere ----

TORCH_FIRES = {
    "rng_global_draws": ("RNG-DET", 9, """\
        import torch

        def draws(x):
            a = torch.rand(3)
            b = torch.randn(2, 2, device="cuda")
            c = torch.randint(0, 5, (4,))
            d = torch.randperm(7)
            e = torch.normal(x, 1.0)
            f = torch.bernoulli(x)
            g = torch.multinomial(x, 2)
            return torch.poisson(x), torch.rand_like(x), a, b, c, d, e, f, g
        """),
    "rng_inplace_and_init": ("RNG-DET", 7, """\
        import torch
        from torch import nn

        def init(w):
            w.uniform_(-1, 1)
            w.normal_()
            w.bernoulli_(0.5)
            w.exponential_()
            w.random_(0, 10)
            nn.init.xavier_uniform_(w)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0)
            nn.init.zeros_(w)
        """),
    "rng_entropy": ("RNG-DET", 3, """\
        import torch

        def reseed():
            torch.seed()
            torch.cuda.seed()
            torch.Generator().seed()
        """),
    "jit_compile_decorator": ("JIT-HYGIENE", 7, """\
        import numpy as np
        import torch

        @torch.compile
        def step(x, n):
            print(x)
            y = float(n) + x.item()
            return y, x.tolist(), x.cpu(), x.numpy(), np.asarray(x)
        """),
    "jit_compile_call_and_script": ("JIT-HYGIENE", 3, """\
        import random
        import torch

        def body(x):
            return x * random.random()

        @torch.jit.script
        def scripted(x):
            return int(x)

        fast = torch.compile(body, mode="reduce-overhead")

        def other(x):
            return x.item()

        faster = torch.compile(other)
        """),
    "jit_graphed_and_captured": ("JIT-HYGIENE", 4, """\
        import numpy as np
        import torch

        def chunk(x):
            return x.sum().item()

        graphed = torch.cuda.make_graphed_callables((chunk,), (x0,))

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                z = bool(y)
                np.random.rand(3)
                print(z)
            return y.cpu()
        """),
}

TORCH_CLEAN = {
    "rng_seeded_generators": """\
        import torch
        from torch import nn

        def draws(x, seed, dev):
            gen = torch.Generator(dev).manual_seed(seed)
            a = torch.rand(3, generator=gen)
            b = torch.randn((2, 2), generator=gen, device=dev)
            c = torch.randint(0, 5, (4,), generator=gen)
            d = torch.randperm(7, generator=gen)
            e = torch.normal(x, 1.0, generator=gen)
            x.uniform_(-1, 1, generator=gen)
            x.normal_(generator=gen)
            nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
            nn.init.zeros_(x)
            gen.manual_seed(seed + 1)
            return a, b, c, d, e, torch.multinomial(x, 2, generator=gen)
        """,
    "jit_clean_regions": """\
        import torch

        @torch.compile
        def step(x, w):
            return torch.relu(x @ w).sum(dim=-1)

        def host(x):
            print(x.item(), x.tolist(), float(x))
            return x.cpu().numpy()

        def capture(g, x, out):
            with torch.cuda.graph(g):
                out.copy_(x * 2)
            return out.cpu()
        """,
}


@pytest.mark.parametrize("name", sorted(TORCH_FIRES))
def test_torch_form_fires_in_port_only(tmp_path, ref_lint, name):
    rule_id, n, source = TORCH_FIRES[name]
    want, got = _both(tmp_path, ref_lint, source)
    mine = [d for d in got if d.rule_id == rule_id]
    assert len(mine) == n, [d.format() for d in got]
    assert [d for d in want if d.rule_id == rule_id] == [], \
        [d.format() for d in want]
    # the reference's own findings (numpy/stdlib RNG) are the port's too
    assert {d.format() for d in want} <= {d.format() for d in got}


@pytest.mark.parametrize("name", sorted(TORCH_CLEAN))
def test_torch_clean_twin_silent(tmp_path, ref_lint, name):
    want, got = _both(tmp_path, ref_lint, TORCH_CLEAN[name])
    assert want == [] and got == [], [d.format() for d in got]


def test_torch_forms_need_a_torch_import(tmp_path, ref_lint):
    """Without `import torch` the torch forms stay silent, so a corpus
    without torch code gets exactly the reference's diagnostics."""
    src = "def f(w, g):\n    w.uniform_()\n    g.seed()\n"
    want, got = _both(tmp_path, ref_lint, src)
    assert want == got == []


# ---- the repo is self-clean under the port's replint -------------------

def test_repo_passes_port_strict_lint(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = tcli(["--strict", "src", "tests", "examples", "benchmarks"])
    out = capsys.readouterr()
    assert rc == 0, out.out
    assert "0 error(s), 0 warning(s)" in out.err
