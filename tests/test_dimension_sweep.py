"""Dimension-general parameter sweep: the reference's generators and
constraints work in any D (its observables battery runs D up to 5); here the
full Hammer stacks are swept over D ∈ {3, 4} × W ∈ {1, 2, ∞} for both
formulations with validity, gauge/equivalence invariance, and observable
finiteness checked — making "dimension-general" an evidenced claim at the
generator level, not just the calculus level (reference test/harness.py +
test/test_validity.py run the same invariants on its grid).
"""

from functools import cache

import numpy as np
import pytest

import supervillain_tpu as sv
from supervillain_tpu.generators import villain as gv, worldline as gw

DS = (3, 4)
WS = (1, 2, float('inf'))
STEPS = 8
N = 3  # odd N exercises the multi-color checkerboards in D > 2


@cache
def villain_ensemble(D, W):
    S = sv.Villain(sv.Lattice(D, N), 0.5, W)
    return S, sv.Ensemble(S).generate(STEPS, gv.Hammer(S), seed=D * 101 + 7)


@cache
def worldline_ensemble(D, W):
    S = sv.Worldline(sv.Lattice(D, N), 0.5, W)
    return S, sv.Ensemble(S).generate(STEPS, gw.Hammer(S), seed=D * 211 + 3)


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_villain_validity_in_d(D, W):
    S, e = villain_ensemble(D, W)
    for i in range(0, STEPS, 3):
        assert S.valid({'n': e.n[i]})


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_villain_gauge_invariance_in_d(D, W):
    """S is invariant under φ → φ + 2πk, n → n + dk for integer k."""
    from supervillain_tpu.ops import calculus as calc
    S, e = villain_ensemble(D, W)
    rng = np.random.default_rng(D * 13 + int(W if W != float('inf') else 99))
    k = rng.integers(-2, 3, (1,) + S.Lattice.dims)
    phi, n = e.phi[-1], e.n[-1]
    s0 = float(S(phi, n))
    s1 = float(S(phi + 2 * np.pi * k, n + np.asarray(calc.d(S.Lattice, 0, k))))
    assert abs(s1 - s0) < 1e-6 * max(1.0, abs(s0))


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_worldline_validity_in_d(D, W):
    S, e = worldline_ensemble(D, W)
    for i in range(0, STEPS, 3):
        assert S.valid({'m': e.m[i]})


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_observables_finite_in_d(D, W):
    S, e = villain_ensemble(D, W)
    for name in ('ActionDensity', 'InternalEnergyDensity', 'WindingSquared'):
        vals = np.asarray(getattr(e, name))
        assert np.isfinite(vals).all(), name
    if W == float('inf'):
        assert np.allclose(np.asarray(e.WindingSquared), 0.0)


@pytest.mark.parametrize('D', DS)
def test_worldline_observables_finite_in_d(D):
    S, e = worldline_ensemble(D, 2)
    for name in ('ActionDensity', 'InternalEnergyDensity'):
        vals = np.asarray(getattr(e, name))
        assert np.isfinite(vals).all(), name


@pytest.mark.parametrize('W', WS)
def test_d4_topological_charge_consistency(W):
    """The D=4 topological battery at the generator level: Q integrates the
    charge density, Q ≡ 0 exactly at W=∞ (dn = 0), finite otherwise."""
    S, e = villain_ensemble(4, W)
    q = np.asarray(e.TopologicalCharge)
    qd = np.asarray(e.TopologicalChargeDensity)
    np.testing.assert_allclose(q, qd.sum(axis=tuple(range(1, qd.ndim))),
                               rtol=1e-6, atol=1e-8)
    if W == float('inf'):
        np.testing.assert_allclose(q, 0.0, atol=1e-10)


@pytest.mark.parametrize('D,W', [(3, 1), (3, 2), (4, 1)])
def test_worldline_local_updates_separately_in_d(D, W):
    """Each worldline local update alone keeps δm = 0 in D > 2."""
    S = sv.Worldline(sv.Lattice(D, N), 0.5, W)
    for G in (gw.VortexUpdate(S), gw.CoexactUpdate(S), gw.WrappingUpdate(S)):
        e = sv.Ensemble(S).generate(4, G, seed=D * 31 + W)
        assert S.valid({'m': e.m[-1]})


@pytest.mark.parametrize('D', (3, 4))
def test_worldline_worm_in_d(D):
    """The XLA worm is dimension-general (2D directions + close), unlike the
    D=2-only worm; δm = 0 must be restored on every kept draw."""
    S = sv.Worldline(sv.Lattice(D, N), 0.8, W=1)
    e = sv.Ensemble(S).generate(6, gw.ClassicWorm(S), seed=D)
    for i in range(6):
        assert S.valid({'m': e.m[i]})
