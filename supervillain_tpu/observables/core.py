"""Observable and DerivedQuantity machinery.

Capability parity with /root/reference/supervillain/observable/observable.py:19-174
and derived.py:15-77: subclassing ``Observable`` auto-registers the class and installs
a descriptor on :class:`~supervillain_tpu.ensemble.Ensemble`; dependencies are
resolved by argument-name introspection against the ensemble (fields or other
observables), forming a transparent dataflow DAG; ``DerivedQuantity`` does the same
for :class:`~supervillain_tpu.analysis.Bootstrap`, consuming post-resampling
expectation values.

Device reformulation: a measurement function is a *pure per-configuration jnp function*
``measure(S, *deps)``; the descriptor evaluates it across the whole ensemble with one
``jax.vmap`` (or ``lax.map`` when the class sets ``sequential = True`` — for
gather-heavy correlators whose vmapped memory footprint would blow up).
"""

from __future__ import annotations

import inspect
import logging

import numpy as np
import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)

registry = {}
derived_registry = {}


def progress(iterable, **kwargs):
    """Overridable progress hook (reference observable/__init__.py:14-26)."""
    return iterable


def _measure_columns(measure, action, deps, sequential=False):
    """Evaluate a per-configuration measurement across the draw axis."""
    dev_deps = [jnp.asarray(d) for d in deps]

    def single(*xs):
        return measure(action, *xs)

    if sequential:
        fn = jax.jit(single)
        values = jax.lax.map(lambda xs: fn(*xs), tuple(dev_deps))
    else:
        values = jax.vmap(single)(*dev_deps)
    return np.asarray(values)


class Observable:
    """Per-configuration primary observable; attaches to Ensemble by subclassing."""

    #: Evaluate draws with lax.map instead of vmap (bounded memory).
    sequential = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        name = cls.__name__
        registry[name] = cls
        from ..ensemble import Ensemble
        setattr(Ensemble, name, cls())
        logger.debug(f'Observable registered: {name}')

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        name = type(self).__name__

        if name in obj.__dict__:
            return obj.__dict__[name]

        # Inline-measured shortcut: the generator already produced this column.
        cfg = obj.__dict__.get('configuration')
        if cfg is not None and name in cfg:
            return np.asarray(cfg.fields[name])

        class_name = type(obj.Action).__name__
        measure = getattr(self, class_name, None)
        if measure is None:
            measure = getattr(self, 'default', None)
        if measure is None:
            raise NotImplementedError(f'{name} not implemented for {class_name}')

        args = inspect.getfullargspec(measure).args
        deps = [getattr(obj, a) for a in args[1:]]  # args[0] is the action
        values = _measure_columns(measure, obj.Action, deps, sequential=self.sequential)
        obj.__dict__[name] = values
        return values

    def __set__(self, obj, value):
        obj.__dict__[type(self).__name__] = value

    @classmethod
    def autocorrelation(cls, ensemble):
        """Should this observable participate in the ensemble's autocorrelation-time
        estimate?  Overridden by the mixins below."""
        return False


class DerivedQuantity:
    """Post-bootstrap quantity, nonlinear in expectation values; attaches to
    Bootstrap by subclassing."""

    sequential = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        name = cls.__name__
        derived_registry[name] = cls
        from ..analysis.bootstrap import Bootstrap
        setattr(Bootstrap, name, cls())
        logger.debug(f'DerivedQuantity registered: {name}')

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        name = type(self).__name__
        if name in obj.__dict__:
            return obj.__dict__[name]

        class_name = type(obj.Action).__name__
        measure = getattr(self, class_name, None)
        if measure is None:
            measure = getattr(self, 'default', None)
        if measure is None:
            raise NotImplementedError(f'{name} not implemented for {class_name}')

        args = inspect.getfullargspec(measure).args
        deps = [getattr(obj, a) for a in args[1:]]
        values = _measure_columns(measure, obj.Action, deps, sequential=self.sequential)
        obj.__dict__[name] = values
        return values

    def __set__(self, obj, value):
        obj.__dict__[type(self).__name__] = value

    @classmethod
    def autocorrelation(cls, ensemble):
        return False


# -- autocorrelation-participation mixins (reference observable.py:104-174) --------

class Scalar:
    @classmethod
    def autocorrelation(cls, ensemble):
        return True


class Constrained:
    @classmethod
    def autocorrelation(cls, ensemble):
        return (ensemble.Action.W != 1) and super().autocorrelation(ensemble)


class OnlyVillain:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Villain
        return isinstance(ensemble.Action, Villain) and super().autocorrelation(ensemble)


class OnlyWorldline:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Worldline
        return isinstance(ensemble.Action, Worldline) and super().autocorrelation(ensemble)


class NotVillain:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Villain
        return (not isinstance(ensemble.Action, Villain)) and super().autocorrelation(ensemble)


class NotWorldline:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Worldline
        return (not isinstance(ensemble.Action, Worldline)) and super().autocorrelation(ensemble)
