"""Generator protocol: pure jittable Markov-chain updates.

A generator owns static configuration (action, proposal intervals) and exposes

    step(key, cfg, stats) -> (cfg, stats, inline)

a *pure function* suitable for ``lax.scan`` over steps and ``vmap``/sharding over
chains.  ``cfg`` is the field pytree, ``stats`` an acceptance-accounting pytree (one
sub-dict per generator tag), and ``inline`` a dict of per-step inline-observable
arrays with static shapes (declared by :meth:`inline_shapes`).

This is the functional reformulation of the reference's mutate-a-dict interface
(/root/reference/supervillain/generator/generator.py:12-41); the stateful
``step(cfg) -> cfg`` shell and ``report()`` strings are layered on top for API parity.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def uniform_nonzero_int(key, shape, interval, dtype=jnp.int32):
    """Uniform over ±{1, ..., interval} (zero excluded)."""
    r = jax.random.randint(key, shape, 0, 2 * interval)
    return jnp.where(r < interval, r - interval, r - interval + 1).astype(dtype)


def uniform_int_with_zero(key, shape, interval, dtype=jnp.int32):
    """Uniform over {-interval, ..., +interval} (zero included)."""
    return jax.random.randint(key, shape, -interval, interval + 1).astype(dtype)


def zero_inflated_int(key, shape, interval, p, dtype=jnp.int32):
    """Symmetric sparse proposal: ±k with k uniform in {1..interval}, each sign with
    probability p/2; zero otherwise.  P(+k) = P(−k) for every k, so any Metropolis
    update built on it satisfies detailed balance; p tunes how often the expensive
    (rarely accepted at large κ) integer moves are attempted at all."""
    ku, km = jax.random.split(key)
    u = jax.random.uniform(ku, shape)
    mag = jax.random.randint(km, shape, 1, interval + 1)
    sign = jnp.where(u < p / 2, 1, 0) - jnp.where((u >= p / 2) & (u < p), 1, 0)
    return (sign * mag).astype(dtype)


def metropolis(key, dS, shape):
    """Metropolis test: accept mask and clipped acceptance probability."""
    acceptance = jnp.clip(jnp.exp(-dS), max=1.0)
    draw = jax.random.uniform(key, shape, dtype=acceptance.dtype)
    return draw < acceptance, acceptance


class Generator:
    """Base class: stats bookkeeping and the stateful compatibility shell."""

    #: Identifier used as the stats-pytree key; overridden per class.
    name = 'Generator'

    def __str__(self):
        return self.name

    # -- functional interface (override step / inline_shapes) -------------

    def init_stats(self):
        return {self.name: {'accepted': jnp.zeros(()), 'proposed': jnp.zeros(()),
                            'acceptance': jnp.zeros(()), 'sweeps': jnp.zeros(())}}

    def inline_shapes(self):
        """dict name -> (shape, dtype) of per-step inline observables."""
        return {}

    def step(self, key, cfg, stats):  # pragma: no cover - abstract
        raise NotImplementedError

    def prepare(self, cfg):
        """Add any generator-carried state to the starting configuration.

        Called once before a chain starts so that the scan carry's pytree
        structure is static (e.g. :class:`~.villain.ChunkedWorm` carries its
        open-worm head/tail between steps).  Default: no extra state."""
        return cfg

    # -- bookkeeping helpers ----------------------------------------------

    def _tally(self, stats, accepted, proposed, acceptance, sweeps=1.0):
        s = stats[self.name]
        return stats | {self.name: {
            'accepted': s['accepted'] + accepted,
            'proposed': s['proposed'] + proposed,
            'acceptance': s['acceptance'] + acceptance,
            'sweeps': s['sweeps'] + sweeps,
        }}

    # -- stateful compatibility shell -------------------------------------

    @property
    def _shell_key(self):
        if not hasattr(self, '_key'):
            self._key = jax.random.key(np.random.SeedSequence().entropy % (2 ** 63))
        return self._key

    def seed(self, seed):
        """Seed the stateful shell's PRNG (reproducible `.step(cfg)` chains)."""
        self._key = jax.random.key(seed)
        return self

    def _shell_stats(self):
        if not hasattr(self, '_stats'):
            self._stats = self.init_stats()
        return self._stats

    def step_cfg(self, cfg):
        """Stateful single step: dict in, dict out (reference-style shell).

        Fields are the pytree leaves; inline observables ride in the returned dict.
        """
        key = self._shell_key
        self._key, sub = jax.random.split(key)
        if not hasattr(self, '_jitted'):
            self._jitted = jax.jit(self.step)
        fields = {k: jnp.asarray(v) for k, v in cfg.items() if k in self._field_names()}
        new_cfg, self._stats, inline = self._jitted(sub, fields, self._shell_stats())
        out = dict(cfg)
        out.update(new_cfg)
        out.update(inline)
        return out

    def _field_names(self):
        return getattr(self, 'fields', None) or ('phi', 'n', 'm', 'v')

    # -- reporting ---------------------------------------------------------

    def report(self, stats=None):
        stats = stats if stats is not None else getattr(self, '_stats', self.init_stats())
        lines = []
        for tag, s in stats.items():
            accepted = float(s['accepted'])
            proposed = float(s['proposed'])
            acceptance = float(s['acceptance'])
            sweeps = max(float(s['sweeps']), 1.0)
            if proposed > 0:
                lines.append(
                    f'{tag}: {accepted:.0f} proposals accepted of {proposed:.0f} proposed updates.\n'
                    f'    {accepted / proposed:.6f} acceptance rate\n'
                    f'    {acceptance / sweeps:.6f} average Metropolis acceptance probability.'
                )
            else:
                lines.append(f'{tag}: no proposals recorded.')
        return '\n'.join(lines)


class DoNothing(Generator):
    """Example generator: identity update with a constant inline observable ``one``
    (reference /root/reference/supervillain/generator/example.py:6-24)."""

    name = 'DoNothing'

    def inline_shapes(self):
        return {'one': ((), jnp.zeros(()).dtype)}

    def step(self, key, cfg, stats):
        return cfg, self._tally(stats, 0.0, 0.0, 0.0), {'one': jnp.ones(())}
