"""Markov-chain driver: ``lax.scan`` over generator steps.

Capability parity with /root/reference/supervillain/ensemble.py:17-336, reorganized
for an accelerator: the whole chain is one jitted scan (optionally chunked
for progress reporting / bounded device memory), draws land on the host as stacked
NumPy columns, and observables attach lazily through the registry descriptors.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from .configurations import Configurations
from .utils import Timer

logger = logging.getLogger(__name__)


def _no_op(iterable, **kwargs):
    return iterable


class Ensemble:
    """An ensemble of configurations importance-sampled according to ``action``."""

    def __init__(self, action):
        self.Action = action

    # -- construction ------------------------------------------------------

    def from_configurations(self, configurations):
        self.configuration = configurations
        if not hasattr(self, 'index'):
            self.index = np.arange(len(configurations))
            self.index_stride = 1
            self.weight = np.ones(len(configurations))
        return self

    def generate(self, steps, generator, start='cold', seed=0, progress=_no_op,
                 starting_index=0, index_stride=1, chunk=None):
        """Run the chain for ``steps`` configurations.

        Parameters
        ----------
        steps: int
        generator: Generator
            Provides the pure ``step(key, cfg, stats)`` kernel.
        start: 'cold' or a configuration dict
        seed: int or jax PRNG key
        progress: tqdm-like wrapper (chunked execution is used when supplied)
        starting_index, index_stride: labeling of the draws
        chunk: int, optional
            Scan in chunks of this many steps (bounds device memory for the stacked
            draws and enables progress reporting).  Default: one scan.
        """
        S = self.Action

        if getattr(generator, 'host_only', False):
            return self._generate_host(steps, generator, start, progress,
                                       starting_index, index_stride)

        key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)

        if start == 'cold':
            cfg = S.initial()
        elif isinstance(start, dict):
            cfg = {k: jnp.asarray(start[k]) for k in S.fields}
        else:
            raise ValueError(f'Not sure how to start from a {type(start)}.')
        cfg = generator.prepare(cfg)

        # Accumulate into the generator's lifetime stats when it already has
        # some (reference generators are stateful accumulators, so a continued
        # chain's report() covers the whole history, not just the last segment).
        stats = getattr(generator, '_stats', None)
        if stats is not None:
            stats = jax.tree.map(jnp.asarray, stats)
        else:
            stats = generator.init_stats()

        def body(carry, k):
            cfg, stats = carry
            cfg, stats, inline = generator.step(k, cfg, stats)
            return (cfg, stats), (cfg, inline)

        from functools import partial

        @partial(jax.jit, static_argnums=3)
        def run(key, cfg, stats, n):
            keys = jax.random.split(key, n)
            return jax.lax.scan(body, (cfg, stats), keys)

        if chunk is None:
            chunk = steps if progress is _no_op else max(1, int(np.ceil(steps / 50)))

        columns = None
        offset = 0
        with Timer(logger.info, f'Generation of {steps} configurations', per=steps):
            remaining = steps
            chunks = []
            while remaining > 0:
                chunks.append(min(chunk, remaining))
                remaining -= chunks[-1]
            for n in progress(chunks, desc='Generation'):
                key, sub = jax.random.split(key)
                (cfg, stats), (draws, inlines) = run(sub, cfg, stats, n)
                host = {k: np.asarray(v) for k, v in draws.items()}
                host.update({k: np.asarray(v) for k, v in inlines.items()})
                if columns is None:
                    columns = {k: np.empty((steps,) + v.shape[1:], dtype=v.dtype)
                               for k, v in host.items()}
                for k, v in host.items():
                    columns[k][offset:offset + n] = v
                offset += n

        self.configuration = Configurations(columns)
        self.index_stride = index_stride
        self.index = starting_index + index_stride * np.arange(steps)
        self.weight = np.ones(steps)
        self.start = start
        self.generator = generator
        generator._stats = jax.tree.map(np.asarray, stats)
        self._final = {k: np.asarray(v) for k, v in cfg.items()}
        # The carried key was split once per chunk; what remains is fresh and
        # unused.  Persisting it lets continue_from resume the *same* PRNG
        # stream instead of re-deriving a seed from the chain length (which
        # replayed identical proposal streams for equal-length extensions).
        self._next_key = np.asarray(jax.random.key_data(key))

        for line in generator.report().split('\n'):
            logger.info(line)
        return self

    def _generate_host(self, steps, generator, start, progress, starting_index, index_stride):
        """Python-loop generation for host-only (oracle) generators."""
        S = self.Action
        if start == 'cold':
            cfg = {k: np.asarray(v) for k, v in S.initial().items()}
        else:
            cfg = dict(start)
        columns = None
        for i in progress(range(steps), desc='Generation'):
            cfg = generator.step_cfg(cfg)
            if columns is None:
                columns = {k: np.empty((steps,) + np.shape(v), dtype=np.asarray(v).dtype)
                           for k, v in cfg.items()}
            for k, v in cfg.items():
                columns[k][i] = v
        self.configuration = Configurations(columns)
        self.index_stride = index_stride
        self.index = starting_index + index_stride * np.arange(steps)
        self.weight = np.ones(steps)
        self.start = start
        self.generator = generator
        self._final = {k: np.asarray(cfg[k]) for k in S.fields}
        return self

    @classmethod
    def continue_from(cls, ensemble, steps, progress=_no_op):
        """Extend a chain: use the last configuration and generator of ``ensemble``
        (an Ensemble or an h5py.Group storing one) to generate ``steps`` more."""
        import h5py
        if isinstance(ensemble, h5py.Group):
            from .io import ensemble_from_h5
            e = ensemble_from_h5(ensemble)
        elif isinstance(ensemble, Ensemble):
            e = ensemble
        else:
            raise ValueError('ensemble should be an Ensemble or an h5 group storing one.')

        generator = e.generator
        action = e.Action
        last = getattr(e, '_final', None) or e.configuration[-1]
        last = {k: last[k] for k in action.fields}
        index = e.index[-1] + e.index_stride
        next_key = getattr(e, '_next_key', None)
        if next_key is not None:
            seed = jax.random.wrap_key_data(jnp.asarray(next_key))
        else:
            # Host-only (oracle) generators carry their own NumPy RNG; any
            # chain without a stored key falls back to a length-derived seed.
            seed = len(e) + 1
        return Ensemble(action).generate(steps, generator, start=last, seed=seed,
                                         progress=progress, starting_index=index,
                                         index_stride=e.index_stride)

    # -- sizes and access --------------------------------------------------

    def __len__(self):
        return len(self.configuration)

    def __getattr__(self, name):
        # Field columns are exposed as ensemble attributes, unifying observables'
        # access to fields and other observables.
        if name.startswith('__'):
            raise AttributeError(name)
        try:
            return getattr(self.__dict__['configuration'], name)
        except KeyError:
            raise AttributeError(name) from None

    # -- measurement ---------------------------------------------------------

    def measure(self, observables=None):
        """Measure every known primary observable (or the named subset)."""
        from .observables import registry
        if observables is None:
            observables = registry.keys()
        result = {}
        for o in observables:
            try:
                result[o] = getattr(self, o)
            except NotImplementedError:
                logger.info(f'{o} is not implemented for {self.Action}')
        return result

    @property
    def measured(self):
        from .observables import registry
        return self.__dict__.keys() & registry.keys()

    def autocorrelation_time(self, observables=None, every=False):
        """Max integrated autocorrelation time over fluctuating measured observables,
        falling back to half the ensemble length when nothing fluctuates."""
        from .observables import registry
        from .analysis import autocorrelation_time

        if observables is None:
            observables = self.measured
            observables = set(o for o in observables if registry[o].autocorrelation(self))
        if len(observables) == 0:
            observables = tuple(registry.keys())

        auto = {}
        for name in observables:
            if not registry[name].autocorrelation(self):
                continue
            try:
                auto[name] = autocorrelation_time(getattr(self, name))
            except NotImplementedError:
                continue
            except Exception:
                logger.warning(f'{name} does not fluctuate enough; excluded from '
                               'the autocorrelation time calculation.')

        if every:
            return auto
        if not auto:
            # Floor at 1 so downstream cut/every never receive a zero stride
            # (an over-cut chain can be empty here).
            tau = max(1, int(np.ceil(len(self) / 2)))
            logger.warning('No observable fluctuated enough to estimate an '
                           f'autocorrelation time; falling back to τ = {tau}.')
            return tau
        return max(auto.values())

    # -- thinning ------------------------------------------------------------

    def cut(self, start):
        """Drop the first ``start`` configurations (thermalization)."""
        e = Ensemble(self.Action).from_configurations(self.configuration[start:])
        e.index = self.index[start:]
        e.index_stride = self.index_stride
        e.weight = self.weight[start:]
        for o in self.measured:
            setattr(e, o, getattr(self, o)[start:])
        if hasattr(self, 'generator'):
            e.generator = self.generator
        if hasattr(self, '_final'):
            e._final = self._final
        if hasattr(self, '_next_key'):
            e._next_key = self._next_key
        return e

    def every(self, stride):
        """Keep every ``stride``-th configuration (decorrelation); the generator is
        wrapped in KeepEvery so continuation stays strided."""
        from .generators import KeepEvery
        stride = int(stride)
        if stride < 1:
            raise ValueError(f'every() needs a stride >= 1, got {stride}.')
        e = Ensemble(self.Action).from_configurations(self.configuration[::stride])
        e.index = self.index[::stride]
        e.index_stride = self.index_stride * stride
        e.weight = self.weight[::stride]
        for o in self.measured:
            setattr(e, o, getattr(self, o)[::stride])
        if hasattr(self, 'generator'):
            e.generator = KeepEvery(stride, self.generator, blocked_inline=False)
        if hasattr(self, '_final'):
            e._final = self._final
        if hasattr(self, '_next_key'):
            e._next_key = self._next_key
        return e

    # -- plotting ------------------------------------------------------------

    def plot_history(self, axes, observable, label=None, histogram_label=None,
                     bins=31, density=True, alpha=0.5, color=None, history_kwargs=dict()):
        """History + histogram panels for a scalar observable."""
        if 'label' not in history_kwargs:
            history_kwargs['label'] = label
        if histogram_label is None:
            histogram_label = label
        data = np.asarray(getattr(self, observable))
        axes[0].plot(self.index, data, color=color, **history_kwargs)
        axes[1].hist(data, label=histogram_label, orientation='horizontal',
                     bins=bins, density=density, color=color, alpha=alpha)

    # -- persistence -----------------------------------------------------------

    def to_h5(self, group):
        from .io import ensemble_to_h5
        ensemble_to_h5(self, group)

    @classmethod
    def from_h5(cls, group):
        from .io import ensemble_from_h5
        return ensemble_from_h5(group)

    def extend_h5(self, group):
        from .io import ensemble_extend_h5
        return ensemble_extend_h5(self, group)
