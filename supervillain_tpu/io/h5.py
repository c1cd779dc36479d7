"""HDF5 persistence: ensembles, actions, generators.

Capability parity with the reference's h5 subsystem
(/root/reference/supervillain/h5/: Data strategies, ReadWriteable, Extendable,
resizable arrays): generate → write → continue_from → extend → read round-trips with
measurement equality.  The schema is explicit and typed rather than
pickled-``__dict__``:

    ensemble/
      @type = 'Ensemble', @version
      action/            (@type Villain|Worldline, lattice/{D,N}, kappa, W)
      configurations/    (one resizable draw-major dataset per field/inline column)
      index, weight      (resizable)
      @index_stride
      final/             (the chain's last field configuration, for continuation)
      @generator         (JSON spec; reconstructed against the action)
      measured/          (cached observable columns; complex stored as real+imag)
"""

from __future__ import annotations

import json
import logging

import numpy as np

from .. import meta
from ..models import Villain, Worldline
from ..ops import Lattice

logger = logging.getLogger(__name__)


def check_version(group, strict=True):
    """Compare a group's stored ``@version`` against the running package version.

    Mirrors the reference's strict/lenient metadata check
    (/root/reference/supervillain/h5/data.py:40-56): a mismatch raises
    ``ValueError`` when ``strict`` and logs a warning otherwise.  Groups written
    before versioning (no ``@version`` attr) pass silently, like the reference's
    ``KeyError: pass`` branch.
    """
    stored = group.attrs.get('version')
    if stored is None:
        return
    if stored != meta.version:
        message = (f'Version mismatch for {group.name}: stored with '
                   f'{stored!r} but currently use {meta.version!r}')
        if strict:
            raise ValueError(message)
        logger.warning(message)


# -- actions ---------------------------------------------------------------

def action_from_h5(group):
    kind = group.attrs['type']
    if kind == 'Villain':
        return Villain.from_h5(group)
    if kind == 'Worldline':
        return Worldline.from_h5(group)
    raise ValueError(f'Unknown action type {kind!r}')


# -- generators ------------------------------------------------------------

_SPEC_ARGS = {
    'SiteUpdate': ('interval_phi',),
    'LinkUpdate': ('interval_n',),
    'ExactUpdate': ('interval_z',),
    'CohomologyUpdate': ('interval_h',),
    'NeighborhoodUpdate': ('interval_phi', 'interval_n', 'p_n'),
    'ExactNeighborhoodUpdate': ('interval_phi', 'interval_z', 'p_z'),
    'VortexUpdate': ('interval_v',),
    'CoexactUpdate': ('interval_t',),
    'WrappingUpdate': ('interval_w',),
    'PlaquetteUpdate': (),
    'ClassicWorm': ('max_moves',),
    'ChunkedWorm': ('moves_per_step',),
    'DoNothing': (),
}


def generator_spec(g):
    """JSON-serializable description of a generator tree."""
    from ..generators.combining import Sequentially, KeepEvery
    from ..generators.monitor import Logger
    if isinstance(g, Sequentially):
        # Persist the de-duplicated stats tags so that stats accumulated under
        # suffixed tags (two same-named sub-generators) reconcile on reload.
        return {'cls': 'Sequentially', 'generators': [generator_spec(x) for x in g.generators],
                'tags': list(g._tags)}
    if isinstance(g, KeepEvery):
        return {'cls': 'KeepEvery', 'n': g.n, 'blocked_inline': g.blocked_inline,
                'generator': generator_spec(g.generator)}
    if isinstance(g, Logger):
        return generator_spec(g.generator)
    cls = type(g).__name__
    family = type(g).__module__.rsplit('.', 1)[-1]
    args = {k: getattr(g, k) for k in _SPEC_ARGS.get(cls, ())}
    return {'cls': cls, 'family': family, 'args': args}


def generator_from_spec(spec, action):
    """Reconstruct a generator tree against ``action``."""
    from ..generators.combining import Sequentially, KeepEvery
    from ..generators import base as gbase, villain as gvillain, worldline as gworldline
    cls = spec['cls']
    if cls == 'Sequentially':
        seq = Sequentially([generator_from_spec(s, action) for s in spec['generators']])
        if 'tags' in spec and list(spec['tags']) != seq._tags:
            seq._tags = list(spec['tags'])
            seq.name = 'Sequentially(' + ', '.join(seq._tags) + ')'
        return seq
    if cls == 'KeepEvery':
        return KeepEvery(spec['n'], generator_from_spec(spec['generator'], action),
                         blocked_inline=spec['blocked_inline'])
    family = {'base': gbase, 'villain': gvillain, 'worldline': gworldline}.get(spec['family'])
    klass = getattr(family, cls, None)
    if klass is None:
        raise LookupError(f"generator {spec['family']}.{cls} does not exist in "
                          f'supervillain_tpu {meta.version}')
    if cls == 'DoNothing':
        return klass()
    return klass(action, **spec['args'])


# -- ensembles -------------------------------------------------------------

def _write_column(group, name, value):
    value = np.asarray(value)
    if np.iscomplexobj(value):
        g = group.create_group(name)
        g.attrs['complex'] = True
        g.create_dataset('real', data=value.real, maxshape=(None,) + value.shape[1:])
        g.create_dataset('imag', data=value.imag, maxshape=(None,) + value.shape[1:])
    else:
        group.create_dataset(name, data=value, maxshape=(None,) + value.shape[1:])


def _read_column(node):
    import h5py
    if isinstance(node, h5py.Group):
        return np.asarray(node['real']) + 1j * np.asarray(node['imag'])
    return np.asarray(node)


def _extend_column(group, name, value):
    value = np.asarray(value)
    import h5py
    node = group[name]
    if isinstance(node, h5py.Group):
        for part, data in (('real', value.real), ('imag', value.imag)):
            ds = node[part]
            start = ds.shape[0]
            ds.resize(start + data.shape[0], axis=0)
            ds[start:] = data
    else:
        start = node.shape[0]
        node.resize(start + value.shape[0], axis=0)
        node[start:] = value


def ensemble_to_h5(ensemble, group):
    group.attrs['type'] = 'Ensemble'
    group.attrs['version'] = meta.version
    ensemble.Action.to_h5(group.create_group('action'))

    cfgs = group.create_group('configurations')
    for name, column in ensemble.configuration.fields.items():
        _write_column(cfgs, name, column)

    _write_column(group, 'index', np.asarray(ensemble.index))
    _write_column(group, 'weight', np.asarray(ensemble.weight))
    group.attrs['index_stride'] = int(ensemble.index_stride)

    final = getattr(ensemble, '_final', None)
    if final is None and len(ensemble):
        final = {k: ensemble.configuration[len(ensemble) - 1][k]
                 for k in ensemble.Action.fields}
    if final is not None:
        fg = group.create_group('final')
        for k, val in final.items():
            fg[k] = np.asarray(val)

    if hasattr(ensemble, 'generator'):
        group.attrs['generator'] = json.dumps(generator_spec(ensemble.generator))
        stats = getattr(ensemble.generator, '_stats', None)
        if stats is not None:
            import jax
            group.attrs['generator_stats'] = json.dumps(
                jax.tree.map(float, stats))

    next_key = getattr(ensemble, '_next_key', None)
    if next_key is not None:
        group.create_dataset('next_key', data=np.asarray(next_key))

    from ..observables import registry
    measured = group.create_group('measured')
    for name in ensemble.measured:
        _write_column(measured, name, ensemble.__dict__[name])
    return group


def ensemble_from_h5(group, strict=True):
    from ..ensemble import Ensemble
    from ..configurations import Configurations

    check_version(group, strict=strict)
    action = action_from_h5(group['action'])
    e = Ensemble(action)
    e.configuration = Configurations({k: _read_column(group['configurations'][k])
                                      for k in group['configurations']})
    e.index = _read_column(group['index'])
    e.weight = _read_column(group['weight'])
    e.index_stride = int(group.attrs['index_stride'])
    if 'final' in group:
        e._final = {k: np.asarray(group['final'][k]) for k in group['final']}
    if 'generator' in group.attrs:
        try:
            e.generator = generator_from_spec(json.loads(group.attrs['generator']), action)
        except LookupError as err:
            # Draws and measurements stay readable; continuing the chain needs
            # a generator this version has.
            logger.warning(f'{group.name}: {err}; read without its generator.')
        else:
            if 'generator_stats' in group.attrs:
                e.generator._stats = json.loads(group.attrs['generator_stats'])
    if 'next_key' in group:
        e._next_key = np.asarray(group['next_key'])
    if 'measured' in group:
        for name in group['measured']:
            e.__dict__[name] = _read_column(group['measured'][name])
    return e


def ensemble_extend_h5(ensemble, group):
    """Append ``ensemble``'s draws to an existing ensemble group (the reference's
    ``Extendable.extend_h5`` workflow)."""
    cfgs = group['configurations']
    for name, column in ensemble.configuration.fields.items():
        _extend_column(cfgs, name, column)
    _extend_column(group, 'index', np.asarray(ensemble.index))
    _extend_column(group, 'weight', np.asarray(ensemble.weight))

    final = getattr(ensemble, '_final', None)
    if final is not None:
        del group['final']
        fg = group.create_group('final')
        for k, val in final.items():
            fg[k] = np.asarray(val)

    next_key = getattr(ensemble, '_next_key', None)
    if next_key is not None:
        if 'next_key' in group:
            del group['next_key']
        group.create_dataset('next_key', data=np.asarray(next_key))
    stats = getattr(getattr(ensemble, 'generator', None), '_stats', None)
    if stats is not None:
        import jax
        group.attrs['generator_stats'] = json.dumps(jax.tree.map(float, stats))
    # Drop stale cached measurements: they no longer cover the extended chain.
    if 'measured' in group:
        del group['measured']
        group.create_group('measured')
    return group
