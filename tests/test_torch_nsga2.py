"""The port's NSGA-II operators against the JAX reference: exact equality.

Deterministic operators (dominance, front peeling, crowding, survival
order) are fed the same numpy objectives. The random operators are fed
the reference's own `jax.random` draws for the same key split, so one
generation's children, and the final population of a whole GA run, must
be equal bit for bit. Objectives are drawn
from a coarse grid so ties and several fronts occur, which exercises the
stable sorts and the lossy fp32 sort keys of rank >= 1 fronts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import nsga2 as jn  # noqa: E402
from repro.core import objectives as jax_objectives  # noqa: E402
from repro_torch.core import nsga2 as tn  # noqa: E402
from repro_torch.core.objectives import population_objectives  # noqa: E402


def _objs(seed, lead, P):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 8, lead + (P, 2)) / 8.0
            + rng.random(lead + (P, 2)) * 1e-3 * (seed % 2)
            ).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("seed,P", [(0, 12), (1, 40), (2, 64), (3, 40)])
def test_deterministic_operators_match_exactly(seed, P):
    objs = _objs(seed, (), P)
    to = torch.as_tensor(objs)
    np.testing.assert_array_equal(_np(tn.dominance(to)),
                                  _np(jn.dominance(objs)))
    jranks = jn.nondominated_rank(objs)
    tranks = tn.nondominated_rank(to)
    np.testing.assert_array_equal(_np(tranks), _np(jranks))
    assert _np(jranks).max() >= 1          # rank >= 1 fronts exist
    np.testing.assert_array_equal(
        _np(tn.crowding_distance(to, tranks)),
        _np(jn.crowding_distance(objs, jranks)))
    jorder, jr, jc = jn._survival_order(objs)
    torder, tr, tc = tn._survival_order(to)
    np.testing.assert_array_equal(_np(torder), _np(jorder))
    np.testing.assert_array_equal(_np(tc), _np(jc))


def test_batched_operators_equal_vmapped_reference():
    objs = _objs(5, (3,), 24)
    to = torch.as_tensor(objs)
    jranks = jax.vmap(jn.nondominated_rank)(objs)
    tranks = tn.nondominated_rank(to)
    np.testing.assert_array_equal(_np(tranks), _np(jranks))
    np.testing.assert_array_equal(
        _np(tn.crowding_distance(to, tranks)),
        _np(jax.vmap(jn.crowding_distance)(objs, jranks)))
    np.testing.assert_array_equal(
        _np(tn._survival_order(to)[0]),
        _np(jax.vmap(lambda o: jn._survival_order(o)[0])(objs)))


@pytest.mark.parametrize("masked", [False, True])
def test_repair_k_with_reference_draws(masked):
    P, M, k = 10, 9, 3
    rng = np.random.default_rng(7)
    pop = (rng.random((P, M)) < 0.5).astype(np.float32)
    vm = (rng.random(M) < 0.6).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.uniform(key, (P, M)))
    want = jn.repair_k(jnp.asarray(pop), key, k,
                       None if vm is None else jnp.asarray(vm))
    got = tn.repair_k(torch.as_tensor(pop), torch.as_tensor(noise), k,
                      None if vm is None else torch.as_tensor(vm))
    np.testing.assert_array_equal(_np(got), _np(want))


def _reference_breed_draws(key_g, P, M):
    ks = jax.random.split(key_g, 6)
    return tn.BreedDraws(*(torch.as_tensor(np.array(a)) for a in (
        jax.random.randint(ks[0], (2, P), 0, P),
        jax.random.randint(ks[1], (2, P), 0, P),
        jax.random.uniform(ks[2], (P, M)),
        jax.random.uniform(ks[3], (P, 1)),
        jax.random.uniform(ks[4], (P, M)),
        jax.random.uniform(ks[5], (P, M)))))


@pytest.mark.parametrize("masked", [False, True])
def test_breed_generation_with_reference_draws(masked):
    P, M = 16, 10
    cfg = jn.NSGAConfig(pop_size=P, generations=1, k=3, p_mut=0.2)
    rng = np.random.default_rng(3)
    vm = (rng.random(M) < 0.7).astype(np.float32) if masked else None
    pop = np.array(jn._init_population(
        jax.random.PRNGKey(1), jax.random.PRNGKey(2), P, M, cfg.k,
        None if vm is None else jnp.asarray(vm)))
    objs = _objs(4, (), P)
    ranks = jn.nondominated_rank(objs)
    crowd = jn.crowding_distance(objs, ranks)
    key_g = jax.random.PRNGKey(5)
    want = jn._breed(jnp.asarray(pop), ranks, crowd, key_g, cfg,
                     None if vm is None else jnp.asarray(vm))
    got = tn._breed(torch.as_tensor(pop),
                    torch.as_tensor(np.asarray(ranks, np.int64)),
                    torch.as_tensor(np.array(crowd)),
                    _reference_breed_draws(key_g, P, M), tn.NSGAConfig(*cfg),
                    None if vm is None else torch.as_tensor(vm))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_init_population_with_reference_draws():
    P, M, k = 12, 8, 3
    k0, k1 = jax.random.PRNGKey(8), jax.random.PRNGKey(9)
    want = jn._init_population(k0, k1, P, M, k)
    draws = tn.InitDraws(
        torch.as_tensor(np.array(jax.random.uniform(k0, (P, M)))),
        torch.as_tensor(np.array(jax.random.uniform(k1, (P, M)))))
    got = tn._init_population(draws, k)
    np.testing.assert_array_equal(_np(got), _np(want))


def _reference_loop_draws(keys, cfg, M):
    """The reference `run_nsga2_batched`'s draws for per-client `keys`:
    InitDraws (N, P, M) and BreedDraws (N, G, ...), split as it splits
    them (key -> loop, init bits, init repair; loop -> G generations)."""
    P, G = cfg.pop_size, cfg.generations
    init, breed = [], []
    for key in keys:
        key_loop, k0, k1 = jax.random.split(key, 3)
        init.append(tn.InitDraws(
            torch.as_tensor(np.array(jax.random.uniform(k0, (P, M)))),
            torch.as_tensor(np.array(jax.random.uniform(k1, (P, M))))))
        gens = [_reference_breed_draws(kg, P, M)
                for kg in jax.random.split(key_loop, G)]
        breed.append(tn.BreedDraws(*map(torch.stack, zip(*gens))))
    return (tn.InitDraws(*map(torch.stack, zip(*init))),
            tn.BreedDraws(*map(torch.stack, zip(*breed))))


def test_ga_loop_with_reference_draws_matches_exactly():
    """The whole batched GA loop (initial repair, 2G + 1 evaluations,
    parent + child concatenation, survival order, the `_rows` pick), fed
    the reference's draws, ends in the reference's final population,
    objectives and ranks. acc and S lie on a 1/8 grid, so both packages
    compute the objectives exactly and the ties fall alike."""
    N, P, M = 3, 12, 9
    cfg = jn.NSGAConfig(pop_size=P, generations=4, k=3, p_mut=0.1)
    rng = np.random.default_rng(21)
    acc = (rng.integers(0, 9, (N, M)) / 8.0).astype(np.float32)
    a = rng.integers(0, 9, (N, M, M)) / 8.0
    S = np.triu(a) + np.triu(a, 1).transpose(0, 2, 1)
    S = S.astype(np.float32)
    vm = np.ones((N, M), np.float32)
    vm[1, [2, 5]] = 0.0
    vm[2, 0] = 0.0
    keys = jn.client_keys(5, list(range(N)))
    jax_objs = jax.vmap(lambda p, ac, s: jnp.stack(
        jax_objectives.population_objectives(p, ac, s), -1))
    want = jn.run_nsga2_batched(lambda pop: jax_objs(pop, acc, S), M, cfg,
                                keys, valid_mask=jnp.asarray(vm))
    ta, tS = torch.as_tensor(acc), torch.as_tensor(S)
    got = tn.run_nsga2_batched(
        lambda pop: torch.stack(population_objectives(pop, ta, tS), -1),
        M, tn.NSGAConfig(*cfg), None, valid_mask=torch.as_tensor(vm),
        draws=_reference_loop_draws(keys, cfg, M))
    for name in ("pop", "objs", "ranks"):
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]),
                                      err_msg=name)
    assert (_np(got["pop"]).sum(-1) == cfg.k).all()
    assert (_np(got["pop"]) * (1 - vm[:, None, :]) == 0).all()


def test_client_stream_independent_of_batch():
    """A client's GA depends only on (seed, client): the same client
    selects the same final population in any batch composition."""
    rng = np.random.default_rng(0)
    N, M = 3, 8
    acc = torch.as_tensor(rng.random((N, M)).astype(np.float32))
    a = rng.random((N, M, M)).astype(np.float32)
    S = torch.as_tensor((a + a.transpose(0, 2, 1)) / 2)
    cfg = tn.NSGAConfig(pop_size=12, generations=4, k=3)

    def run(batch):
        idx = torch.as_tensor(batch)
        out = tn.run_nsga2_batched(
            lambda pop: torch.stack(population_objectives(
                pop, acc[idx], S[idx]), dim=-1),
            M, cfg, tn.client_keys(7, batch))
        return {c: out["pop"][i] for i, c in enumerate(batch)}

    full, partial = run([0, 1, 2]), run([2, 0])
    for c in (0, 2):
        np.testing.assert_array_equal(full[c].numpy(), partial[c].numpy())
    assert (full[0].sum(-1) == 3).all()
