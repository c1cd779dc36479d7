"""Exact invariants of the XLA worms, checked chain by chain on a vmapped batch:
closed worms leave the constraint 2-form (Villain dn) or divergence
(Worldline δm) unchanged, the inline histogram's total is the worm length,
and at φ = 0, W = 1 the Villain worm equilibrates each link to the exact
discrete Gaussian P(n) ∝ e^{-2π²κ n²}."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import supervillain_tpu as sv
from supervillain_tpu.generators import villain as gv, worldline as gw
from supervillain_tpu.ops import calculus as calc


def _run_worms(G, cfgs, steps, seed):
    """``steps`` worms per chain over a chain batch; returns the final fields
    and the per-step inline outputs (steps, chains, ...)."""
    chains = jax.tree.leaves(cfgs)[0].shape[0]
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), G.init_stats())

    @jax.jit
    def run(key, cfgs, stats):
        def body(carry, k):
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            cfgs, stats, inline = jax.vmap(G.step)(keys, *carry)
            return (cfgs, stats), inline
        return jax.lax.scan(body, (cfgs, stats), jax.random.split(key, steps))

    (cfgs, _), inline = run(jax.random.key(seed), cfgs, stats)
    return cfgs, inline


def _warm_villain(S, chains, seed):
    """Chains with nonzero φ and n, on the constraint surface."""
    cfg0 = S.initial()
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    warm = gv.ExactNeighborhoodUpdate(S, interval_phi=0.5) if S.W == float('inf') \
        else gv.NeighborhoodUpdate(S, interval_phi=0.5)
    cfgs, _ = _run_worms(warm, cfgs, 20, seed)
    return cfgs


@pytest.mark.parametrize('W', [2, float('inf')])
def test_villain_worm_preserves_dn(W):
    # Small κ: moves are accepted often, so closed worms leave n changed.
    S = sv.Villain(sv.Lattice2D(6), 0.06, W=W)
    cfgs = _warm_villain(S, 8, seed=1)
    d = jax.vmap(lambda n: calc.d(S.Lattice, 1, n))
    out, inline = _run_worms(gv.ClassicWorm(S), cfgs, 20, seed=2)
    assert (np.asarray(d(out['n'])) == np.asarray(d(cfgs['n']))).all()
    assert np.asarray(inline['Worm_Length']).sum() > 0
    assert (np.asarray(out['n']) != np.asarray(cfgs['n'])).any()  # worms moved


@pytest.mark.parametrize('W', [2, float('inf')])
def test_worldline_worm_preserves_divergence(W):
    S = sv.Worldline(sv.Lattice2D(6), 0.5, W=W)
    cfg0 = S.initial()
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape), cfg0)
    out, inline = _run_worms(gw.ClassicWorm(S), cfgs, 10, seed=3)
    dm = jax.vmap(lambda m: calc.delta(S.Lattice, 1, m))(out['m'])
    assert (np.asarray(dm) == 0).all()
    assert (np.asarray(out['m']) != 0).any()


@pytest.mark.parametrize('model', ['villain', 'worldline'])
def test_worm_length_is_histogram_total(model):
    """Every tallied move lands in exactly one histogram bin, so the inline
    correlator's total equals Worm_Length on every chain and step."""
    if model == 'villain':
        S = sv.Villain(sv.Lattice2D(6), 0.3, W=2)
        G, hist_name = gv.ClassicWorm(S, max_moves=200), 'Vortex_Vortex'
        cfgs = _warm_villain(S, 8, seed=4)
    else:
        S = sv.Worldline(sv.Lattice2D(6), 0.5, W=2)
        G, hist_name = gw.ClassicWorm(S, max_moves=200), 'Spin_Spin'
        cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape), S.initial())
    _, inline = _run_worms(G, cfgs, 6, seed=5)
    hist = np.asarray(inline[hist_name])
    length = np.asarray(inline['Worm_Length'])
    np.testing.assert_array_equal(hist.sum(axis=(-2, -1)), length)
    assert length.max() > 0


def test_villain_worm_single_link_marginal():
    """φ frozen at 0, W=1: S = (κ/2) Σ_ℓ (2π n_ℓ)² factorizes over links, so
    ⟨n²⟩ is the exact discrete-Gaussian moment."""
    kappa, N, chains = 0.06, 4, 32
    S = sv.Villain(sv.Lattice2D(N), kappa, W=1)
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), S.initial())
    G = gv.ClassicWorm(S)
    chains_n = []
    for block in range(6):
        cfgs, _ = _run_worms(G, cfgs, 100, seed=10 + block)
        if block >= 2:
            chains_n.append(np.asarray(cfgs['n'], dtype=float))
    ns = np.stack(chains_n)                     # (blocks, chains, 2, N, N)
    per_chain = (ns ** 2).mean(axis=(0, 2, 3, 4))
    k = np.arange(-8, 9)
    w = np.exp(-2 * np.pi ** 2 * kappa * k ** 2)
    exact = (k ** 2 * w).sum() / w.sum()
    err = per_chain.std(ddof=1) / np.sqrt(chains)
    assert abs(per_chain.mean() - exact) < 5 * err, (per_chain.mean(), exact, err)
