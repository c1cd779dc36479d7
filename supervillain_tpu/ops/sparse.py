"""Sparse-operator API (reference compact.py:1042-1285), realized as masked dense
operations.

The reference's input-sparse ``delta_sparse``/``d_sparse`` and output-sparse
``coface_sum_at``/``face_sum_at`` exist to avoid O(volume) NumPy work per CPU
proposal.  On an accelerator the masked dense forms *are* the fast path (everything fuses into
whole-lattice vector ops), so these functions exist for API parity and for host-side
code that wants the reference's calling convention: they are numerically identical
to applying the dense operator to the equivalent sparse form (the reference's own
bit-exactness guarantee).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .lattice import Lattice
from . import calculus as calc


def _embed(lattice: Lattice, degree: int, component: int, color, values):
    """Dense form with ``values`` on ``component`` at the sites ``color``."""
    values = jnp.asarray(values)
    form = jnp.zeros(lattice.form_shape(degree), dtype=values.dtype)
    return form.at[(component,) + tuple(color)].set(values)


def delta_sparse(lattice, degree, component, color, values, out=None):
    """δ of a degree-form supported on one (component, color).  With ``out``, the
    result is accumulated into it (incremental δv maintenance)."""
    result = calc.delta(lattice, degree, _embed(lattice, degree, component, color, values))
    if out is None:
        return result
    out += np.asarray(result).astype(out.dtype, copy=False)
    return out


def d_sparse(lattice, degree, component, color, values, out=None):
    """d of a degree-form supported on one (component, color)."""
    result = calc.d(lattice, degree, _embed(lattice, degree, component, color, values))
    if out is None:
        return result
    out += np.asarray(result).astype(out.dtype, copy=False)
    return out


def coface_sum_at(lattice, degree, f, component, color):
    """The coface sum of a degree-form ``f``, read out at one (component, color) of
    the (degree+1)-form output."""
    dense = calc.coface_sum(lattice, degree, jnp.asarray(f))
    return dense[(component,) + tuple(color)]


def face_sum_at(lattice, degree, f, component, color):
    """The face sum of a degree-form ``f``, read out at one (component, color) of
    the (degree-1)-form output."""
    dense = calc.face_sum(lattice, degree, jnp.asarray(f))
    return dense[(component,) + tuple(color)]
