"""Zero-inflated integer proposals (``p_n`` / ``p_z``) of the neighborhood
updates: symmetric, valid, and faster-mixing at large κ."""

import numpy as np

import supervillain_tpu as sv
from supervillain_tpu.generators import villain as gv


def test_zero_inflated_neighborhood_is_valid_and_mixes_faster():
    """p_n makes the integer moves rare (so more proposals are pure-φ and accepted)
    while keeping the proposal symmetric; the chain stays on the constraint surface
    and agrees with the uniform-proposal chain statistically."""
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    sparse = gv.NeighborhoodUpdate(S, p_n=0.05)
    e = sv.Ensemble(S).generate(300, sparse, seed=11)
    for i in range(0, 300, 50):
        assert S.valid({'n': e.n[i]})
    uniform = gv.NeighborhoodUpdate(S)
    eu = sv.Ensemble(S).generate(300, uniform, seed=12)
    acc_sparse = float(sparse._stats['NeighborhoodUpdate']['accepted'])
    acc_uniform = float(uniform._stats['NeighborhoodUpdate']['accepted'])
    assert acc_sparse > acc_uniform  # the point of the knob
    # Statistical agreement vs a well-mixed chain (the uniform-proposal chain does
    # not thermalize in 300 steps at kappa=0.5 — the pathology p_n addresses).
    eh = sv.Ensemble(S).generate(300, gv.Hammer(S), seed=13)
    ba = sv.Bootstrap(e.cut(100).every(3), draws=100, seed=1)
    bb = sv.Bootstrap(eh.cut(100).every(3), draws=100, seed=2)
    ma, ea = ba.estimate('ActionDensity')
    mb, eb = bb.estimate('ActionDensity')
    assert abs(ma - mb) / np.hypot(ea, eb) < 5


def test_zero_inflated_int_proposal_is_symmetric():
    import jax
    from supervillain_tpu.generators.base import zero_inflated_int
    draws = np.asarray(zero_inflated_int(jax.random.key(0), (200_000,), 2, 0.3))
    p_plus = (draws > 0).mean()
    p_minus = (draws < 0).mean()
    assert abs(p_plus - p_minus) < 0.01        # symmetric
    assert abs(p_plus + p_minus - 0.3) < 0.01  # inflation rate
    assert set(np.unique(draws)) <= {-2, -1, 0, 1, 2}
