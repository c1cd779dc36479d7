"""Fleets of independent Markov chains, vmapped and sharded over a device mesh.

This is the capability the reference lacks entirely (SURVEY §2.9): thousands of
chains run as one jitted program — ``vmap`` over the chain axis, ``lax.scan`` over
steps, shardings over the mesh so XLA lays chains across devices and aggregates
statistics with collectives.  Per-chain PRNG keys are folded from a root key by chain
index, so results are independent of the device layout.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import chain_mesh


#: Truncated-worm fraction above which inline worm histograms should not be
#: used quantitatively (the short-separation bias scales with this fraction).
TRUNCATION_BUDGET = 1e-3


def check_truncation_budget(truncated, total_worms, *, budget=TRUNCATION_BUDGET,
                            context=''):
    """Warn loudly when the truncated fraction of worms exceeds ``budget``.

    Capped worms (``ClassicWorm(max_moves=...)``) roll back exactly (the
    sampled distribution is unbiased) but their *histogram tallies are kept*,
    so the inline Vortex_Vortex / Spin_Spin correlators carry a
    short-separation bias proportional to the truncated fraction.  Production
    guidance (generators/villain.py ClassicWorm docstring): keep it ≲ 1e-3 or
    raise ``max_moves``.  Returns the fraction.
    """
    total_worms = max(1, int(total_worms))
    frac = float(truncated) / total_worms
    if frac > budget:
        import warnings
        warnings.warn(
            f'{context}{float(truncated):.0f}/{total_worms} worms truncated '
            f'(fraction {frac:.2e} > {budget:g}) — inline worm histograms '
            f'carry short-separation bias at this point; raise '
            f'max_moves or exclude the inline correlator from fits.',
            stacklevel=2)
    return frac


class Fleet:
    """Draws from many independent chains: field columns of shape
    (kept, chains, ...), per-chain final configurations, pooled statistics."""

    def __init__(self, action, columns, stats, final, index, weight=None):
        self.Action = action
        self.columns = columns          # name -> np.ndarray (kept, chains, ...)
        self.stats = stats              # aggregated over chains
        self.final = final              # name -> np.ndarray (chains, ...)
        self.index = index
        self.weight = weight if weight is not None else np.ones(len(index))

    @property
    def chains(self):
        return next(iter(self.final.values())).shape[0]

    def __len__(self):
        return len(self.index)

    def ensemble(self, chain):
        """View chain ``chain`` as a standard :class:`Ensemble`."""
        from ..ensemble import Ensemble
        from ..configurations import Configurations
        e = Ensemble(self.Action).from_configurations(
            Configurations({k: v[:, chain] for k, v in self.columns.items()}))
        e.index = self.index
        e.index_stride = int(self.index[1] - self.index[0]) if len(self.index) > 1 else 1
        e.weight = self.weight
        return e

    def pooled_ensemble(self, cut=0):
        """Concatenate all chains (after a per-chain thermalization ``cut``) into one
        ensemble of independent-by-construction draws."""
        from ..ensemble import Ensemble
        from ..configurations import Configurations
        cols = {k: v[cut:].reshape((-1,) + v.shape[2:]) for k, v in self.columns.items()}
        e = Ensemble(self.Action).from_configurations(Configurations(cols))
        e.index = np.arange(len(next(iter(cols.values()))))
        e.index_stride = 1
        e.weight = np.ones(len(e.index))
        return e

    def to_h5(self, group):
        group.attrs['type'] = 'Fleet'
        self.Action.to_h5(group.create_group('action'))
        cols = group.create_group('columns')
        for k, v in self.columns.items():
            cols.create_dataset(k, data=v, maxshape=(None,) + v.shape[1:])
        group['index'] = self.index
        group['weight'] = self.weight
        fin = group.create_group('final')
        for k, v in self.final.items():
            fin[k] = v
        stats = group.create_group('stats')
        for tag, s in self.stats.items():
            g = stats.create_group(tag)
            for k, v in s.items():
                g[k] = np.asarray(v)

    @classmethod
    def from_h5(cls, group):
        from ..io import action_from_h5
        action = action_from_h5(group['action'])
        columns = {k: np.asarray(group['columns'][k]) for k in group['columns']}
        final = {k: np.asarray(group['final'][k]) for k in group['final']}
        stats = {tag: {k: np.asarray(group['stats'][tag][k])
                       for k in group['stats'][tag]}
                 for tag in group['stats']}
        return cls(action, columns, stats, final,
                   np.asarray(group['index']), np.asarray(group['weight']))


# An unbounded ClassicWorm vmapped over a fleet makes every step wait for the
# slowest chain's excursion (max-over-chains, not mean — see docs/performance.md).
# The max of `chains` draws from the worm-length distribution grows without
# bound near criticality (power-law tails), and already at ~8 chains the
# max/mean penalty is measurable for the exponential-tail case, so the floor is
# deliberately conservative and W-independent (the pathology does not care
# about W; the old `chains <= N` escape let a 64-chain L=64 W=2 fleet through).
_WORM_BOUND_FLOOR = 8


def _bounded_worms(generator, action, chains, policy):
    """Fleet worm-bounding policy.

    ``policy='raise'`` (default): finding a bare (unbounded) ClassicWorm in the
    tree with ``chains >= _WORM_BOUND_FLOOR`` is an error — silently rewriting
    the user's generator tree would change the transition kernel (and any
    persisted generator description) without consent.  The error says exactly
    what to pass instead.

    ``policy='auto'``: rebuild the tree with ``ClassicWorm(max_moves=8·sites)``
    (an exact bounded kernel — truncated worms roll back) and warn.

    ``policy='off'``: pass through unchanged (expert opt-out, e.g. exactness
    tests of the unbounded kernel itself on tiny lattices)."""
    import logging
    from ..generators.combining import Sequentially, KeepEvery
    from ..generators.monitor import Logger
    from ..generators import villain as gvillain, worldline as gworldline

    if policy not in ('raise', 'auto', 'off'):
        raise ValueError(f"bound_worms must be 'raise', 'auto', or 'off', "
                         f'got {policy!r}')
    if policy == 'off' or chains < _WORM_BOUND_FLOOR:
        return generator

    cap = 8 * action.Lattice.sites
    changed = []

    def rebuild(g):
        if isinstance(g, Sequentially):
            return Sequentially([rebuild(x) for x in g.generators])
        if isinstance(g, KeepEvery):
            return KeepEvery(g.n, rebuild(g.generator), blocked_inline=g.blocked_inline)
        if isinstance(g, Logger):
            inner = rebuild(g.generator)
            return Logger(inner, channel=g.channel, timer=g.timer) if inner is not g.generator else g
        if isinstance(g, (gvillain.ClassicWorm, gworldline.ClassicWorm)) \
                and g.max_moves is None:
            changed.append(g)
            return type(g)(g.Action, max_moves=cap)
        return g

    rebuilt = rebuild(generator)
    if not changed:
        return generator
    if policy == 'raise':
        raise ValueError(
            f'Unbounded ClassicWorm vmapped over {chains} chains: every fleet '
            f'step would wait for the slowest chain\'s worm (max-over-chains, '
            f'not mean).  Pass Hammer(..., fleet=True) or '
            f'ClassicWorm(max_moves=...) to bound it explicitly, '
            f"sample_fleet(..., bound_worms='auto') to let the fleet "
            f'substitute ClassicWorm(max_moves={cap}) (an exact bounded '
            f"kernel), or bound_worms='off' to run unbounded anyway.")
    logging.getLogger(__name__).warning(
        f'Unbounded ClassicWorm vmapped over {chains} chains: substituting '
        f'ClassicWorm(max_moves={cap}) — an exact bounded kernel (truncated '
        f'worms roll back).  Pass Hammer(..., fleet=True) or '
        f'ClassicWorm(max_moves=...) explicitly to silence this.')
    return rebuilt


def sample_fleet(action, generator, *, chains, steps, thin=1, seed=0, mesh=None,
                 start='cold', keep_fields=True, progress=None, bound_worms='raise'):
    """Sample ``chains`` independent chains for ``steps`` kept configurations, each
    separated by ``thin`` generator applications.

    Returns a :class:`Fleet`.  With a mesh, chains are sharded across devices and the
    whole fleet advances as a single SPMD program.

    ``bound_worms`` governs what happens when the generator tree contains an
    unbounded ClassicWorm (see :func:`_bounded_worms`): ``'raise'`` (default)
    errors with the explicit alternatives, ``'auto'`` substitutes an exact
    ``max_moves``-capped worm with a warning, ``'off'`` runs it as given.
    """
    if mesh is None and len(jax.devices()) > 1:
        mesh = chain_mesh()

    generator = _bounded_worms(generator, action, chains, bound_worms)

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)

    if start == 'cold':
        cfg0 = action.initial()
    else:
        cfg0 = {k: jnp.asarray(start[k]) for k in action.fields}
    cfg0 = generator.prepare(cfg0)
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape),
                         generator.init_stats())

    if mesh is not None and chains % mesh.devices.size != 0:
        import logging
        logging.getLogger(__name__).warning(
            f'{chains} chains not divisible by {mesh.devices.size} devices; '
            'running unsharded.')
        mesh = None

    if mesh is not None:
        def shard_leaf(x):
            spec = P('chains', *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
        cfgs = jax.tree.map(shard_leaf, cfgs)
        stats = jax.tree.map(shard_leaf, stats)

    def scan_chunk(key, cfgs, stats, n):
        def body(carry, k):
            cfgs, stats = carry
            def chain_step(ck, cfg, st):
                def inner(c, kk):
                    cfg, st = c
                    cfg, st, inline = generator.step(kk, cfg, st)
                    return (cfg, st), inline
                keys = jax.random.split(ck, thin)
                (cfg, st), inlines = jax.lax.scan(inner, (cfg, st), keys)
                # Blocked inline averaging over the thinned-away sub-steps
                # (KeepEvery's blocked_inline semantics, reference
                # combining.py:58-116) so rare measurements — e.g. worm
                # correlator histograms — keep all their statistics.
                inline = {kk: v.mean(axis=0) for kk, v in inlines.items()}
                return cfg, st, inline
            chains_n = jax.tree.leaves(cfgs)[0].shape[0]
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains_n))
            cfgs, stats, inline = jax.vmap(chain_step)(keys, cfgs, stats)
            out = dict(cfgs) if keep_fields else {}
            out.update(inline)
            return (cfgs, stats), out
        keys = jax.random.split(key, n)
        return jax.lax.scan(body, (cfgs, stats), keys)

    jitted = jax.jit(scan_chunk, static_argnums=3)

    chunk = steps if progress is None else max(1, steps // 20)
    chunks = []
    remaining = steps
    while remaining > 0:
        chunks.append(min(chunk, remaining))
        remaining -= chunks[-1]
    iterator = chunks if progress is None else progress(chunks)

    columns = None
    offset = 0
    for n in iterator:
        key, sub = jax.random.split(key)
        (cfgs, stats), draws = jitted(sub, cfgs, stats, n)
        host = {k: np.asarray(v) for k, v in draws.items()}
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape[1:], dtype=v.dtype)
                       for k, v in host.items()}
        for k, v in host.items():
            columns[k][offset:offset + n] = v
        offset += n

    # Aggregate statistics across chains (a psum under SPMD).
    agg_stats = jax.tree.map(lambda x: np.asarray(jnp.sum(x, axis=0)), stats)
    final = {k: np.asarray(v) for k, v in cfgs.items()}
    index = thin * (1 + np.arange(steps))
    return Fleet(action, columns, agg_stats, final, index)
