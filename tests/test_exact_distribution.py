"""Exact-distribution test: on a 2×2 worldline lattice the equilibrium
distribution is enumerable, so the sampled chain can be χ²-tested against the
*exact* Boltzmann probabilities — a stronger check than the reference's
statistical cross-comparisons (its test battery never tests equilibrium
distributions directly).

The gauge-invariant state is u = m − δv/W (a closed integer 1-form: δu = 0 by
the δm = 0 constraint), distributed as P(u) ∝ exp(−Σ_ℓ u_ℓ² / 2κ).  At W=1 and
κ=0.4 the partition sum truncated at |u_ℓ| ≤ 3 carries all but O(1e-10) of the
mass, so exact probabilities are computable by brute force over the 8 links.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import supervillain_tpu as sv
from supervillain_tpu.generators import worldline as gw
from supervillain_tpu.ops import calculus
from supervillain_tpu.parallel.fleet import sample_fleet

KAPPA = 0.4


def _enumerate_closed_forms(L, cutoff):
    """All integer 1-forms u with δu = 0 and |u_ℓ| ≤ cutoff on the 2×2 lattice,
    with their Boltzmann weights."""
    n_links = 2 * L.sites
    vals = np.arange(-cutoff, cutoff + 1)
    grids = np.meshgrid(*([vals] * n_links), indexing='ij')
    u = np.stack([g.ravel() for g in grids], axis=-1)          # (K, 8)
    forms = u.reshape(-1, 2, L.N, L.N)
    # δu = 0 (vectorized over the enumeration batch)
    div = np.zeros((forms.shape[0], L.N, L.N))
    for mu in range(2):
        div += forms[:, mu] - np.roll(forms[:, mu], +1, axis=mu + 1)
    closed = np.abs(div).max(axis=(1, 2)) == 0
    forms = forms[closed]
    weights = np.exp(-(forms ** 2).sum(axis=(1, 2, 3)) / (2 * KAPPA))
    return forms, weights


def test_worldline_hammer_samples_exact_distribution():
    L = sv.Lattice2D(2)
    S = sv.Worldline(L, KAPPA, W=1)

    forms, weights = _enumerate_closed_forms(L, cutoff=3)
    Z = weights.sum()
    probs = weights / Z
    keys = [f.tobytes() for f in forms.astype(np.int8)]
    prob_of = dict(zip(keys, probs))

    # bound_worms='off': this test exercises the *unbounded* worm kernel itself
    # (2x2 lattice, worm lengths are tiny — no max-over-chains concern).
    fleet = sample_fleet(S, gw.Hammer(S), chains=48, steps=120, thin=4, seed=7,
                         bound_worms='off')
    cut = 20  # thermalization (in kept records)
    m = fleet.columns['m'][cut:].reshape(-1, 2, 2, 2)
    v = fleet.columns['v'][cut:].reshape(-1, 1, 2, 2)

    # u = m − δv/W, rounded to integers (exact at W=1).
    counts = {}
    n_draws = m.shape[0]
    for i in range(n_draws):
        dv = np.asarray(calculus.delta(L, 2, jnp.asarray(v[i], jnp.float64)))
        u = np.rint(m[i] - dv).astype(np.int8)
        assert np.abs(u).max() <= 3, 'sampled state outside enumeration cutoff'
        counts[u.tobytes()] = counts.get(u.tobytes(), 0) + 1

    # Every sampled state must be a valid closed form from the enumeration.
    for k in counts:
        assert k in prob_of, 'sampled a state with δu != 0'

    # χ² over bins with expected count ≥ 5; everything else pooled.
    chi2 = 0.0
    dof = 0
    pooled_obs = 0
    pooled_exp = 0.0
    for k, p in prob_of.items():
        exp = p * n_draws
        obs = counts.get(k, 0)
        if exp >= 5:
            chi2 += (obs - exp) ** 2 / exp
            dof += 1
        else:
            pooled_obs += obs
            pooled_exp += exp
    if pooled_exp > 0:
        chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
        dof += 1
    dof -= 1

    # Generous critical value (≈ p=1e-4 for the relevant dof range, plus slack
    # for residual autocorrelation at thin=4); the seed is fixed, so this is
    # deterministic.  A wrong equilibrium (e.g. a detailed-balance bug) moves
    # χ²/dof far above O(1).
    assert dof >= 5, f'too few populated bins ({dof}) for a meaningful test'
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'


def test_exact_enumeration_sanity():
    """The enumeration itself: the zero form dominates, wrap cycles come next
    with weight e^{-1/κ}, and probabilities are properly normalized."""
    L = sv.Lattice2D(2)
    forms, weights = _enumerate_closed_forms(L, cutoff=2)
    Z = weights.sum()
    idx0 = int(np.argmax(weights))
    assert np.abs(forms[idx0]).max() == 0
    # Straight torus wraps on a 2×2 lattice touch two links: S = 2/(2κ) = 1/κ.
    wrap_weight = np.exp(-1 / KAPPA)
    assert np.isclose(np.sort(weights)[-2], wrap_weight)
    assert weights.max() / Z < 1  # nonzero states carry real mass


# -- Villain worm equilibrium (classic and chunked) -------------------------

VKAPPA = 0.06  # 2π²κ ≈ 1.18: n = ±1 links carry real mass, ±2 negligible-ish


def _enumerate_villain_n(L, cutoff):
    """All integer 1-forms n with |n_ℓ| ≤ cutoff on the 2×2 lattice with their
    weights under S = (κ/2) Σ_ℓ (2π n_ℓ)² (φ frozen at 0).  At W=1 there is no
    constraint, so the worm alone is ergodic on n."""
    n_links = 2 * L.sites
    vals = np.arange(-cutoff, cutoff + 1)
    grids = np.meshgrid(*([vals] * n_links), indexing='ij')
    n = np.stack([g.ravel() for g in grids], axis=-1).reshape(-1, 2, L.N, L.N)
    weights = np.exp(-(VKAPPA / 2) * ((2 * np.pi * n) ** 2).sum(axis=(1, 2, 3)))
    return n, weights


def _chi2_against(prob_of, counts, n_draws):
    chi2, dof, pooled_obs, pooled_exp = 0.0, 0, 0, 0.0
    for k, p in prob_of.items():
        exp = p * n_draws
        obs = counts.get(k, 0)
        if exp >= 5:
            chi2 += (obs - exp) ** 2 / exp
            dof += 1
        else:
            pooled_obs += obs
            pooled_exp += exp
    if pooled_exp > 0:
        chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
        dof += 1
    return chi2, dof - 1


@pytest.mark.parametrize('worm', ['classic', 'chunked'])
def test_villain_worm_samples_exact_distribution(worm):
    """χ² of the worm-only chain (φ frozen) against the enumerated Boltzmann
    distribution of n — run for both the data-dependent-length ClassicWorm and
    the fixed-trip-count ChunkedWorm, whose fixed-stride emission is exactly
    unbiased at W=1 (see generators/villain.py:ChunkedWorm)."""
    from supervillain_tpu.generators import villain as gv

    L = sv.Lattice2D(2)
    S = sv.Villain(L, VKAPPA, W=1)
    G = gv.ClassicWorm(S) if worm == 'classic' else gv.ChunkedWorm(S, moves_per_step=12)

    forms, weights = _enumerate_villain_n(L, cutoff=2)
    probs = weights / weights.sum()
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), probs))

    fleet = sample_fleet(S, G, chains=64, steps=100, thin=4, seed=11,
                         bound_worms='off')
    cut = 20
    ns = fleet.columns['n'][cut:].reshape(-1, 2, 2, 2).astype(np.int8)
    assert np.abs(ns).max() <= 3, 'sampled n far outside enumeration cutoff'

    # Rare |n|=3 excursions fall outside the enumeration; their total mass is
    # O(e^{-9·2π²κ}) — fold them into the pooled χ² bin via a sentinel key.
    counts = {}
    for x in ns:
        k = x.tobytes() if np.abs(x).max() <= 2 else b'overflow'
        counts[k] = counts.get(k, 0) + 1
    prob_of = dict(prob_of)
    prob_of[b'overflow'] = 16 * np.exp(-(VKAPPA / 2) * (2 * np.pi * 3) ** 2)

    chi2, dof = _chi2_against(prob_of, counts, ns.shape[0])
    assert dof >= 5, f'too few populated bins ({dof})'
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'


def _enumerate_villain_closed_n(L, cutoff):
    """The dn = 0 subset of the |n_ℓ| ≤ cutoff enumeration with its weights:
    the sector a worm-only chain explores at W>1 (worm moves add closed dual
    loops, preserving dn exactly)."""
    n, weights = _enumerate_villain_n(L, cutoff)
    curl = (np.roll(n[:, 1], -1, axis=1) - n[:, 1]
            - np.roll(n[:, 0], -1, axis=2) + n[:, 0])
    closed = np.abs(curl).max(axis=(1, 2)) == 0
    return n[closed], weights[closed]


@pytest.mark.parametrize('cap,thin', [(None, 4), (8, 16)])
def test_villain_worm_w2_exact_distribution(cap, thin):
    """χ² of the W=2 worm-only chain (φ frozen) against the enumerated
    Boltzmann distribution over closed (dn = 0) integer 1-forms.

    cap=8 forces frequent truncation (the worm must return to its tail within
    8 moves or roll back), validating that the max_moves-bounded kernel — the
    fleet-safe default — samples the *same* exact distribution as the
    unbounded one.  Truncation slows mixing (rolled-back steps are identity
    moves), so the capped variant thins harder: χ²/dof at thin 4/16/32 was
    measured at 4.92/1.67/1.26 — a thinning-dependence profile characteristic
    of autocorrelation, not bias."""
    from supervillain_tpu.generators import villain as gv

    L = sv.Lattice2D(2)
    S = sv.Villain(L, VKAPPA, W=2)
    G = gv.ClassicWorm(S, max_moves=cap)

    forms, weights = _enumerate_villain_closed_n(L, cutoff=2)
    probs = weights / weights.sum()
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), probs))

    fleet = sample_fleet(S, G, chains=64, steps=100, thin=thin, seed=13,
                         bound_worms='off')
    cut = 20
    ns = fleet.columns['n'][cut:].reshape(-1, 2, 2, 2).astype(np.int8)

    # Every emitted configuration must stay in the dn = 0 sector: a rollback
    # bug (emitting a truncated open worm) would land outside the enumeration.
    counts = {}
    for x in ns:
        k = x.tobytes() if np.abs(x).max() <= 2 else b'overflow'
        counts[k] = counts.get(k, 0) + 1
    for k in counts:
        assert k == b'overflow' or k in prob_of, 'sampled a state with dn != 0'
    prob_of = dict(prob_of)
    prob_of[b'overflow'] = 4 * np.exp(-(VKAPPA / 2) * 2 * (2 * np.pi * 3) ** 2)

    chi2, dof = _chi2_against(prob_of, counts, ns.shape[0])
    assert dof >= 5, f'too few populated bins ({dof})'
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'


def test_worldline_hammer_capped_worm_exact_distribution():
    """The worldline Hammer with a tightly capped worm (max_worm_moves=6,
    frequent truncation + rollback) still samples the exact distribution."""
    L = sv.Lattice2D(2)
    S = sv.Worldline(L, KAPPA, W=1)

    forms, weights = _enumerate_closed_forms(L, cutoff=3)
    probs = weights / weights.sum()
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), probs))

    fleet = sample_fleet(S, gw.Hammer(S, max_worm_moves=6), chains=48, steps=120,
                         thin=4, seed=17)
    cut = 20
    m = fleet.columns['m'][cut:].reshape(-1, 2, 2, 2)
    v = fleet.columns['v'][cut:].reshape(-1, 1, 2, 2)

    counts = {}
    for i in range(m.shape[0]):
        dv = np.asarray(calculus.delta(L, 2, jnp.asarray(v[i], jnp.float64)))
        u = np.rint(m[i] - dv).astype(np.int8)
        assert np.abs(u).max() <= 3
        counts[u.tobytes()] = counts.get(u.tobytes(), 0) + 1
    for k in counts:
        assert k in prob_of, 'sampled a state with δu != 0 (rollback bug?)'

    chi2, dof = _chi2_against(prob_of, counts, m.shape[0])
    assert dof >= 5
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'


def _enumerate_villain_exact_n(L, zcut):
    """All n = dz for integer 0-forms z (gauge-fixed z[origin]=0, entries in
    ±zcut), with Boltzmann weights at φ = 0 — the sector the z-only
    ExactNeighborhoodUpdate explores at W=∞ from a cold start."""
    zs = np.array(np.meshgrid(*([np.arange(-zcut, zcut + 1)] * (L.sites - 1)),
                              indexing='ij')).reshape(L.sites - 1, -1).T
    forms = {}
    for zrow in zs:
        z = np.concatenate([[0], zrow]).reshape((1,) + L.dims)
        n = np.stack([np.roll(z[0], -1, axis=mu) - z[0] for mu in range(L.D)])
        k = n.astype(np.int8).tobytes()
        if k not in forms:
            forms[k] = np.exp(-(VKAPPA / 2) * ((2 * np.pi * n) ** 2).sum())
    return forms


def test_exact_neighborhood_samples_exact_distribution():
    """χ² of the z-only ExactNeighborhoodUpdate chain (interval_phi = 0, φ
    frozen at 0) at W=∞ against the enumerated Boltzmann distribution over
    exact forms n = dz — validating the compound Site+Exact kernel's
    proposal symmetry and ΔS algebra end-to-end."""
    from supervillain_tpu.generators import villain as gv

    L = sv.Lattice2D(2)
    S = sv.Villain(L, VKAPPA, W=float('inf'))
    G = gv.ExactNeighborhoodUpdate(S, interval_phi=0.0, interval_z=1)

    forms = _enumerate_villain_exact_n(L, zcut=3)
    Z = sum(forms.values())
    prob_of = {k: w / Z for k, w in forms.items()}

    fleet = sample_fleet(S, G, chains=64, steps=100, thin=4, seed=23)
    cut = 20
    ns = fleet.columns['n'][cut:].reshape(-1, 2, 2, 2).astype(np.int8)

    counts = {}
    for x in ns:
        counts[x.tobytes()] = counts.get(x.tobytes(), 0) + 1
    for k in counts:
        assert k in prob_of, 'sampled n is not an exact form (dz)'

    chi2, dof = _chi2_against(prob_of, counts, ns.shape[0])
    assert dof >= 5, f'too few populated bins ({dof})'
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'
