"""Trace-time guard rails of the public API — these errors must fire before
any device dispatch (so they are testable on the CPU backend) and must say
exactly what to pass instead."""

import numpy as np
import pytest

import supervillain_tpu as sv


def test_bound_worms_rejects_unknown_policy():
    from supervillain_tpu.parallel.fleet import _bounded_worms
    from supervillain_tpu.generators import villain as gv
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    with pytest.raises(ValueError, match="'raise', 'auto', or 'off'"):
        _bounded_worms(gv.Hammer(S), S, 16, 'maybe')


@pytest.mark.parametrize('D', (2, 3, 4, 5))
def test_linearize_coordinatize_roundtrip(D):
    """linearize flattens the D spatial axes into one sites axis;
    coordinatize inverts it — round-trip exact for any D."""
    L = sv.Lattice(D, 3)
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2,) + L.dims)
    flat = L.linearize(x)
    assert flat.shape == (2, L.sites)
    back = L.coordinatize(flat)
    assert back.shape == x.shape
    assert np.allclose(np.asarray(back), x)
