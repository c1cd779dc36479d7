"""Host-tier ``Form``: a metadata-carrying ndarray for analysis and plotting.

The reference exposes a ``Form`` ndarray subclass whose degree and lattice survive
elementwise ufuncs (/root/reference/supervillain/lattice/compact.py:665-897).  On the
device compute path this framework deliberately uses *plain* arrays — JAX transformations
must not depend on runtime array subclassing, and degree is static call-site metadata
(see PARITY.md §2.1).  ``Form`` is the *host* half of that split: a NumPy subclass for
interactive work, measurement post-processing, and plotting, with the reference's API
(``component``, ``face_sum``/``coface_sum``, interlaced round-trips, same-degree ufunc
re-wrapping).  Converting to the device tier is just ``jnp.asarray(form)``; wrapping a
device result back is ``lattice.form(p, np.asarray(x))``.

Semantics (not code) follow the reference:
  * elementwise ufuncs whose Form operands all share one degree return a Form of that
    degree; mixed-degree arithmetic and reductions return plain ndarrays
    (compact.py:728-755).
  * ``component(*dirs)`` is a writable spatial view (compact.py:760-780).
  * ``to_interlaced``/``from_interlaced`` embed into / extract from the (2N)^D layout
    (compact.py:782-840).
  * ``face_sum``/``coface_sum`` return the (p∓1)-form unsigned incidence sums, or 0 at
    the degree boundary (compact.py:846-890).
"""

from __future__ import annotations

from math import comb

import numpy as np

from .lattice import Lattice
from . import calculus, interlaced

__all__ = ['Form']


class Form(np.ndarray):
    """A p-form on a :class:`Lattice`: shape ``(C(D,p), N, ..., N)`` with the leading
    axis indexing components lexicographically by sorted direction tuple."""

    __batch_tag__ = 'Form'

    def __new__(cls, input_array, *, degree, lattice, dtype=None):
        obj = np.asarray(input_array, dtype=dtype).view(cls)
        if obj.shape[-lattice.D - 1:] != lattice.form_shape(degree):
            raise ValueError(
                f'data of shape {obj.shape} is not a (batch of) degree-{degree} '
                f'form(s) on {lattice!r}: expected trailing {lattice.form_shape(degree)}')
        obj.degree = degree
        obj.lattice = lattice
        return obj

    @classmethod
    def spatial_shape(cls, *, degree, lattice):
        """``(C(D,p), N, ..., N)``."""
        return (comb(lattice.D, degree),) + (lattice.N,) * lattice.D

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.degree = getattr(obj, 'degree', None)
        self.lattice = getattr(obj, 'lattice', None)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        forms = [x for x in inputs if isinstance(x, Form)]
        degrees = {f.degree for f in forms}
        raw = tuple(np.asarray(x) for x in inputs)
        out = kwargs.get('out')
        if out is not None:
            kwargs['out'] = tuple(np.asarray(o) for o in out)
        result = getattr(ufunc, method)(*raw, **kwargs)
        # Re-wrap only when unambiguous: one shared degree, elementwise shape,
        # and the operand still has a full form shape (a sliced view keeps the
        # metadata via __array_finalize__ but is no longer a whole form — its
        # arithmetic must return a plain ndarray rather than crash on the
        # shape-validating constructor).
        if (len(degrees) == 1 and isinstance(result, np.ndarray)
                and forms and result.shape == forms[0].shape
                and forms[0].lattice is not None):
            lattice, degree = forms[0].lattice, forms[0].degree
            if result.shape[-lattice.D - 1:] == lattice.form_shape(degree):
                return Form(result, degree=degree, lattice=lattice)
        return result

    # -- component access ---------------------------------------------------

    def component(self, *dirs):
        """Writable spatial view of one component, shape ``(N, ..., N)``.

        Accepts ``f.component(0, 2)`` or ``f.component((0, 2))``.
        """
        if len(dirs) == 1 and hasattr(dirs[0], '__iter__'):
            dirs = tuple(dirs[0])
        idx = self.lattice.comp_index[self.degree][tuple(sorted(dirs))]
        return np.asarray(self)[idx]

    # -- interlaced layout ----------------------------------------------------

    def to_interlaced(self):
        """Embed into the (2N)^D interlaced array (odd coordinates = form dirs)."""
        return interlaced.to_interlaced(self.lattice, self.degree, np.asarray(self))

    @classmethod
    def from_interlaced(cls, p, data, lattice=None):
        """Inverse of :meth:`to_interlaced`; ``lattice`` inferred from shape."""
        data = np.asarray(data)
        if lattice is None:
            lattice = Lattice(data.ndim, data.shape[0] // 2)
        return cls(interlaced.from_interlaced(lattice, p, data),
                   degree=p, lattice=lattice)

    # -- unsigned incidence sums ----------------------------------------------

    def face_sum(self):
        """(p-1)-form unsigned sum over faces; ``0`` for a 0-form."""
        if self.degree == 0:
            return 0
        out = np.asarray(calculus.face_sum(self.lattice, self.degree, np.asarray(self)))
        return Form(out, degree=self.degree - 1, lattice=self.lattice)

    def coface_sum(self):
        """(p+1)-form unsigned sum onto cofaces; ``0`` for a top form."""
        if self.degree == self.lattice.D:
            return 0
        out = np.asarray(calculus.coface_sum(self.lattice, self.degree, np.asarray(self)))
        return Form(out, degree=self.degree + 1, lattice=self.lattice)

    def __repr__(self):
        return (f'Form(degree={self.degree}, shape={self.shape}, '
                f'lattice={self.lattice!r})')
