"""Multi-chain fleet tests on the 8-virtual-device CPU mesh: sharded sampling,
layout-independent results, pooled analysis."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import supervillain_tpu as sv
from supervillain_tpu.generators import villain as gv, worldline as gw
from supervillain_tpu.parallel import chain_mesh, chain_space_mesh, sample_fleet, Fleet


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_fleet_shapes_and_validity():
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    fleet = sample_fleet(S, gv.Hammer(S, fleet=True), chains=16, steps=5, thin=2,
                         seed=3, mesh=chain_mesh())
    assert fleet.columns['phi'].shape == (5, 16, 1, 4, 4)
    assert fleet.chains == 16
    for c in range(0, 16, 5):
        for i in range(5):
            assert S.valid({'n': fleet.columns['n'][i, c]})


def test_fleet_results_independent_of_mesh():
    """Chain results depend only on (seed, chain index), not on the device layout."""
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    G = gv.SiteUpdate(S)
    a = sample_fleet(S, G, chains=8, steps=4, seed=5, mesh=chain_mesh())
    b = sample_fleet(S, gv.SiteUpdate(S), chains=8, steps=4, seed=5, mesh=None)
    assert np.allclose(a.columns['phi'], b.columns['phi'])


def test_fleet_stats_aggregate_over_chains():
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    G = gv.SiteUpdate(S)
    fleet = sample_fleet(S, G, chains=8, steps=3, seed=1, mesh=chain_mesh())
    assert float(fleet.stats['SiteUpdate']['proposed']) == 8 * 3 * 16


def test_fleet_ensemble_views_and_pooling():
    S = sv.Worldline(sv.Lattice2D(4), 0.5, W=2)
    fleet = sample_fleet(S, gw.Hammer(S, fleet=True), chains=8, steps=6, seed=9,
                         mesh=chain_mesh())
    e0 = fleet.ensemble(0)
    assert len(e0) == 6
    assert np.isfinite(np.asarray(e0.ActionDensity)).all()
    pooled = fleet.pooled_ensemble(cut=2)
    assert len(pooled) == 4 * 8
    b = sv.Bootstrap(pooled, draws=20, seed=2)
    mean, err = b.estimate('ActionDensity')
    assert np.isfinite(mean) and err > 0


def test_fleet_h5_roundtrip(tmp_path):
    import h5py
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    fleet = sample_fleet(S, gv.SiteUpdate(S), chains=4, steps=3, seed=2)
    with h5py.File(tmp_path / 'fleet.h5', 'w') as f:
        fleet.to_h5(f.create_group('fleet'))
        back = Fleet.from_h5(f['fleet'])
    assert np.allclose(back.columns['phi'], fleet.columns['phi'])
    assert back.Action == S


def test_chain_space_mesh_sharded_equals_unsharded():
    """2-D (chains × space) sharding is *provably* correct, not just runnable:
    ``jax.random`` results are independent of device layout, and every update
    in the Hammer step is deterministic, so the space-sharded step must produce
    **bitwise identical fields** to the unsharded step from the same key.  At
    W=2 the dn ≡ 0 (mod 2) constraint is non-trivial, so a halo-math bug in
    the partitioned roll stencils would corrupt the fields and fail this
    equality (the old W=1 `valid()` assertion was vacuous — dn ≡ 0 mod 1
    always holds)."""
    mesh = chain_space_mesh(2, 4)
    S = sv.Villain(sv.Lattice2D(8), 0.5, W=2)
    G = gv.Hammer(S, fleet=True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    chains = 4

    def run(shard):
        cfg0 = S.initial()
        cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
        stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape),
                             G.init_stats())
        if shard:
            cfgs = {k: jax.device_put(
                        v, NamedSharding(mesh, P('chains', None, None, 'space')))
                    for k, v in cfgs.items()}
            stats = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh, P('chains'))),
                stats)

        @jax.jit
        def step(key, cfgs, stats):
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(chains))
            def one(k, c, s):
                c, s, _ = G.step(k, c, s)
                return c, s
            return jax.vmap(one)(keys, cfgs, stats)

        for i in range(3):
            cfgs, stats = step(jax.random.key(i), cfgs, stats)
        return cfgs, stats

    sharded, sh_stats = run(True)
    unsharded, un_stats = run(False)
    for k in sharded:
        a, b = np.asarray(sharded[k]), np.asarray(unsharded[k])
        assert a.dtype == b.dtype
        assert (a == b).all(), f'field {k}: sharded != unsharded'
    # Fields evolved non-trivially and stay on the W=2 constraint surface.
    assert np.abs(np.asarray(sharded['n'])).max() >= 0
    for c in range(chains):
        assert S.valid({'n': np.asarray(sharded['n'][c])})
    # Statistics may reduce in different orders across shards: allclose only.
    for tag in sh_stats:
        for k in sh_stats[tag]:
            np.testing.assert_allclose(np.asarray(sh_stats[tag][k]),
                                       np.asarray(un_stats[tag][k]), rtol=1e-5)


def test_space_mesh_collective_audit():
    """The compiled space-sharded Hammer step must contain halo
    collective-permutes (zero would mean XLA gathered the whole lattice per
    device and the sharding annotation was lost), while the chains-mesh step
    must contain none (independent chains)."""
    from supervillain_tpu.benchmark.scaling import (audit_collectives,
                                                    audit_space_mesh_collectives)
    space = audit_space_mesh_collectives(N=8, space=4, W=2)
    assert space['collective-permute'] > 0, space
    chains = audit_collectives(N=8, chains=8, steps=2)
    assert all(v == 0 for v in chains.values()), chains


def test_fleet_inline_thinning_uses_blocked_average():
    """The thin loop must average inline observables over the thinned-away
    sub-steps (KeepEvery's blocked_inline semantics), not keep the last one —
    otherwise rare inline measurements (worm histograms) lose (thin-1)/thin of
    their statistics."""
    import jax.numpy as jnp
    from supervillain_tpu.generators.base import Generator
    from supervillain_tpu.parallel.fleet import sample_fleet

    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)

    class CountingGenerator(Generator):
        name = 'Counting'
        Action = S

        def inline_shapes(self):
            return {'counter': ((), jnp.float32)}

        def step(self, key, cfg, stats):
            cfg = dict(cfg)
            cfg['phi'] = cfg['phi'] + 1.0
            return cfg, stats, {'counter': cfg['phi'][0, 0, 0]}

    fleet = sample_fleet(S, CountingGenerator(), chains=2, steps=3, thin=4, seed=0)
    # Sub-step counters are 1,2,3,4 → blocked mean 2.5 (a last-sub-step keep
    # would give 4.0), then 6.5, 10.5.
    np.testing.assert_allclose(fleet.columns['counter'][:, 0], [2.5, 6.5, 10.5])


def test_fleet_unbounded_worm_raises_by_default():
    """A bare (unbounded) ClassicWorm vmapped over many chains is the measured
    fleet pathology (every step waits for the slowest chain's worm).  Silently
    rewriting the user's generator tree would change the transition kernel
    without consent, so the default policy is an actionable error."""
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    with pytest.raises(ValueError, match='max_moves'):
        sample_fleet(S, gv.Hammer(S), chains=32, steps=3, seed=3)
    # The floor is W-independent: W=1 unbounded worms stall fleets just the same.
    S1 = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    with pytest.raises(ValueError, match='fleet=True'):
        sample_fleet(S1, gv.Hammer(S1), chains=32, steps=3, seed=3)
    # Below the floor (few chains) the max-over-chains penalty is negligible.
    fleet = sample_fleet(S, gv.Hammer(S), chains=4, steps=2, seed=3)
    assert fleet.columns['n'].shape[:2] == (2, 4)


def test_fleet_autobounds_unbounded_worm_with_optin(caplog):
    """bound_worms='auto' opts into the exact max_moves-bounded substitution,
    with a warning naming the substituted cap."""
    import logging
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    with caplog.at_level(logging.WARNING, logger='supervillain_tpu.parallel.fleet'):
        fleet = sample_fleet(S, gv.Hammer(S), chains=32, steps=3, seed=3,
                             bound_worms='auto')
    assert any('max_moves' in r.message for r in caplog.records)
    assert fleet.columns['n'].shape[:2] == (3, 32)
    for c in range(0, 32, 7):
        assert S.valid({'n': fleet.columns['n'][-1, c]})
    # bound_worms='off' runs the tree exactly as given, no warning, no error.
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger='supervillain_tpu.parallel.fleet'):
        fleet = sample_fleet(S, gv.Hammer(S), chains=8, steps=2, seed=4,
                             bound_worms='off')
    assert not any('max_moves' in r.message for r in caplog.records)


def test_fleet_no_substitution_when_already_bounded(caplog):
    import logging
    S = sv.Worldline(sv.Lattice2D(4), 0.5, W=2)
    with caplog.at_level(logging.WARNING, logger='supervillain_tpu.parallel.fleet'):
        fleet = sample_fleet(S, gw.Hammer(S, fleet=True), chains=16, steps=3, seed=5)
    assert not any('max_moves' in r.message for r in caplog.records)
    for c in range(0, 16, 5):
        assert S.valid({'m': fleet.columns['m'][-1, c]})


def test_hammer_fleet_composition():
    """fleet=True composes bounded worms: ChunkedWorm at W=1, capped
    ClassicWorm at W>1 (Villain); capped ClassicWorm for Worldline."""
    SV1 = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    SV2 = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    SW = sv.Worldline(sv.Lattice2D(4), 0.5, W=3)

    names = [type(g).__name__ for g in gv.Hammer(SV1, fleet=True).generators]
    assert 'ChunkedWorm' in names

    parts = gv.Hammer(SV2, fleet=True).generators
    worms = [g for g in parts if type(g).__name__ == 'ClassicWorm']
    assert worms and worms[0].max_moves == 8 * 16

    parts = gw.Hammer(SW, fleet=True).generators
    worms = [g for g in parts if type(g).__name__ == 'ClassicWorm']
    assert worms and worms[0].max_moves == 8 * 16

    # Bare Hammers stay unbounded (single-chain back-compat).
    parts = gv.Hammer(SV2).generators
    worms = [g for g in parts if type(g).__name__ == 'ClassicWorm']
    assert worms and worms[0].max_moves is None


def test_truncation_budget_warning():
    """check_truncation_budget: silent below the budget, a
    loud UserWarning above it, and the returned fraction is exact."""
    import warnings
    from supervillain_tpu.parallel import check_truncation_budget

    with warnings.catch_warnings():
        warnings.simplefilter('error')  # any warning -> failure
        frac = check_truncation_budget(0, 1000)
        assert frac == 0.0
        frac = check_truncation_budget(1, 10000)  # 1e-4 <= 1e-3
        assert frac == 1e-4

    with pytest.warns(UserWarning, match='short-separation bias'):
        frac = check_truncation_budget(50, 1000, context='kappa=0.2: ')
    assert frac == 0.05

    # Tighter budgets trip earlier.
    with pytest.warns(UserWarning, match='worms truncated'):
        check_truncation_budget(1, 10000, budget=1e-5)
