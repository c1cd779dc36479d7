"""D-dimensional periodic hypercubic lattice and compact p-form storage.

A p-form on a ``Lattice(D, N)`` is stored as an array of shape ``(C(D,p), N, ..., N)``
with the leading axis indexing the C(D,p) components, listed lexicographically by the
sorted tuple of "form directions" (capability parity with the reference's compact
layout, /root/reference/supervillain/lattice/compact.py:60-190).

Design notes
------------
* The ``Lattice`` itself is *static metadata*: hashable, compared by ``(D, N)``, and
  closed over by jitted functions.  All incidence tables, checkerboard masks, and
  coordinate arrays are host-side NumPy constants baked into the trace.
* Fields are plain ``jax.numpy`` arrays (no ndarray subclassing — JAX transformations
  must not depend on runtime array types).  Degree is tracked statically by callers.
* All operators in :mod:`supervillain_tpu.ops.calculus` are built from the incidence
  tables computed here as static Python loops over ``jnp.roll`` terms, which XLA fuses
  into single elementwise kernels.
"""

from __future__ import annotations

from functools import cached_property, lru_cache
from itertools import combinations, permutations
from math import comb

import numpy as np
import jax.numpy as jnp
import jax


def fft_coordinates(n: int) -> np.ndarray:
    """FFT-convention coordinates for a periodic direction of size ``n``:
    ``0, 1, ..., n//2, -(n//2)+1, ..., -1`` (reference ``_dimension``,
    /root/reference/supervillain/lattice/__init__.py:4-9)."""
    return np.array(list(range(0, n // 2 + 1)) + list(range(-n // 2 + 1, 0)), dtype=int)


def _sorting_sign(seq) -> int:
    """Sign of the permutation sorting a sequence of distinct integers."""
    inversions = sum(
        1
        for i in range(len(seq))
        for j in range(i + 1, len(seq))
        if seq[i] > seq[j]
    )
    return -1 if inversions % 2 else +1


class Lattice:
    """A D-dimensional hypercubic periodic lattice with N sites per direction.

    Static metadata container: enumerates p-form components, incidence tables for the
    discrete exterior calculus, checkerboard colorings, FFT-convention coordinates.
    Hashable and equality-compared by ``(D, N)`` so jitted functions can close over it.
    """

    def __init__(self, D: int, N: int):
        if D < 1 or N < 1:
            raise ValueError(f'Need D >= 1 and N >= 1, got D={D}, N={N}')
        self.D = int(D)
        self.N = int(N)
        # components[p]: ordered list of sorted direction-tuples, lexicographic.
        self.components = {p: list(combinations(range(D), p)) for p in range(D + 1)}
        # comp_index[p][dirs] -> integer index along axis 0 of a p-form array.
        self.comp_index = {
            p: {c: i for i, c in enumerate(self.components[p])} for p in range(D + 1)
        }

    # -- identity ---------------------------------------------------------

    def __eq__(self, other):
        return isinstance(other, Lattice) and (self.D, self.N) == (other.D, other.N)

    def __hash__(self):
        return hash((type(self).__name__, self.D, self.N))

    def __repr__(self):
        return f'Lattice(D={self.D}, N={self.N})'

    # -- sizes ------------------------------------------------------------

    @cached_property
    def dims(self):
        return (self.N,) * self.D

    @cached_property
    def sites(self):
        return self.N ** self.D

    @cached_property
    def origin(self):
        return (0,) * self.D

    @property
    def dim(self):
        return self.D

    @cached_property
    def links(self):
        return self.D * self.sites

    @cached_property
    def cells_of_degree(self):
        return {p: comb(self.D, p) * self.sites for p in range(self.D + 1)}

    @cached_property
    def cells_of_codegree(self):
        return {q: self.cells_of_degree[self.D - q] for q in range(self.D + 1)}

    def form_shape(self, p: int):
        """Shape ``(C(D,p), N, ..., N)`` of a p-form array."""
        return (comb(self.D, p),) + self.dims

    # -- factories --------------------------------------------------------

    def zeros(self, p: int, dtype=jnp.float32):
        return jnp.zeros(self.form_shape(p), dtype=dtype)

    def form(self, p: int, data=None, dtype=float):
        """Host-tier :class:`~supervillain_tpu.ops.form.Form` of degree ``p``.

        With no ``data`` this is a zero form, matching the reference's
        ``Lattice.form(p, dtype)`` zeros alias
        (/root/reference/supervillain/lattice/compact.py:280-300).  The second
        argument — wrapping an existing array as a Form — is an extension of
        this framework (the reference's factory takes no data argument).
        Device-tier (plain ``jnp``) zeros come from :meth:`zeros`."""
        from .form import Form
        if data is None:
            data = np.zeros(self.form_shape(p), dtype=dtype)
            return Form(data, degree=p, lattice=self)
        return Form(np.asarray(data), degree=p, lattice=self)

    def random(self, p: int, key=None, dtype=jnp.float32):
        """Uniform [0,1) p-form.  With a JAX ``key`` uses jax.random; without, NumPy."""
        if key is not None:
            return jax.random.uniform(key, self.form_shape(p), dtype=dtype)
        return jnp.asarray(np.random.random(self.form_shape(p)), dtype=dtype)

    # -- coordinates ------------------------------------------------------

    @cached_property
    def coord_1d(self) -> np.ndarray:
        return fft_coordinates(self.N)

    @cached_property
    def coords(self) -> np.ndarray:
        """FFT-convention coordinate of each site, shape (D, N, ..., N)."""
        return np.stack(
            np.meshgrid(*(self.coord_1d for _ in range(self.D)), indexing='ij'),
            axis=0,
        )

    @cached_property
    def coordinates(self) -> np.ndarray:
        """Every site's coordinates, shape (sites, D)."""
        return np.stack(
            [c.flatten() for c in np.meshgrid(*[self.coord_1d] * self.D, indexing='ij')],
            axis=1,
        )

    @cached_property
    def R_squared(self) -> np.ndarray:
        """Distance-squared from the origin at each site, shape (N, ..., N)."""
        return np.sum(self.coords ** 2, axis=0)

    def mod(self, x):
        """Map integer coordinates into the FFT-convention range [-(N//2)+1, N//2]."""
        x = np.asarray(x)
        return self.coord_1d[np.mod(x, self.N)]

    def distance_squared(self, a, b):
        """Shortest-path squared distance on the torus between coordinate vectors."""
        d = self.mod(np.asarray(a) - np.asarray(b))
        return np.sum(d ** 2, axis=-1)

    # -- incidence tables -------------------------------------------------

    @cached_property
    def _operator_tables(self):
        """Static incidence tables ``(out_idx, in_idx, axis, sign)`` for the four
        shift-and-accumulate operators (semantics of
        /root/reference/supervillain/lattice/compact.py:143-174).

        d / coface_sum map p -> p+1; delta / face_sum map p -> p-1.
        """
        D = self.D
        tables = {}
        for p in range(D):
            d_rows, co_rows = [], []
            for out_comp in self.components[p + 1]:
                out_idx = self.comp_index[p + 1][out_comp]
                for j, k_j in enumerate(out_comp):
                    in_idx = self.comp_index[p][tuple(k for k in out_comp if k != k_j)]
                    d_rows.append((out_idx, in_idx, k_j, (-1) ** j))
                    co_rows.append((out_idx, in_idx, k_j, 1))
            tables[('d', p)] = tuple(d_rows)
            tables[('coface_sum', p)] = tuple(co_rows)
        all_dirs = set(range(D))
        for p in range(1, D + 1):
            de_rows, fa_rows = [], []
            for out_comp in self.components[p - 1]:
                out_idx = self.comp_index[p - 1][out_comp]
                M = set(out_comp)
                for e in sorted(all_dirs - M):
                    in_idx = self.comp_index[p][tuple(sorted(M | {e}))]
                    j = sum(1 for m in out_comp if m < e)
                    de_rows.append((out_idx, in_idx, e, (-1) ** j))
                    fa_rows.append((out_idx, in_idx, e, 1))
            tables[('delta', p)] = tuple(de_rows)
            tables[('face_sum', p)] = tuple(fa_rows)
        return tables

    def operator_table(self, op: str, degree: int):
        try:
            return self._operator_tables[(op, degree)]
        except KeyError:
            raise ValueError(f'no operator table for op={op!r} at degree={degree}')

    # -- checkerboarding --------------------------------------------------

    @cached_property
    def checkerboard_masks(self) -> np.ndarray:
        """Boolean masks, shape (n_colors, N, ..., N), partitioning the sites so that
        no two same-color sites are nearest neighbors (through the periodic boundary
        included).  Even N: 2 colors by coordinate-parity.  Odd N: 2^max(D,2) colors by
        (hyperoctant-pair, parity), matching the reference guarantee
        (/root/reference/supervillain/lattice/compact.py:191-239).
        """
        D, N = self.D, self.N
        coords = self.coords
        parity = np.mod(coords.sum(axis=0), 2)

        if N % 2 == 0:
            return np.stack([parity == c for c in (0, 1)])

        masks = []
        n_pairs = 1 << max(D - 1, 1)
        for b in range(n_pairs):
            if D == 1:
                pair = coords[0] >= 0 if b == 0 else coords[0] < 0
            else:
                # Pair of opposite hyperoctants: representative has coords[0] >= 0 and
                # the bits of b set the sign of coords[1..D-1]; the partner flips all.
                pos = coords[0] >= 0
                neg = coords[0] < 0
                for k in range(1, D):
                    bit = (b >> (k - 1)) & 1
                    if bit == 0:
                        pos &= coords[k] >= 0
                        neg &= coords[k] < 0
                    else:
                        pos &= coords[k] < 0
                        neg &= coords[k] >= 0
                pair = pos | neg
            for c in (0, 1):
                masks.append(pair & (parity == c))
        return np.stack(masks)

    @cached_property
    def checkerboarding(self):
        """``np.where``-style index tuples per color (reference-compatible view of
        :attr:`checkerboard_masks`)."""
        return tuple(np.where(m) for m in self.checkerboard_masks)

    @cached_property
    def n_colors(self):
        return len(self.checkerboard_masks)

    # -- Fourier methods --------------------------------------------------

    def _spatial_axes(self):
        return tuple(range(-self.D, 0))

    def fft(self, form, axes=None):
        """Ortho-normalized DFT over the last D (spatial) axes."""
        return jnp.fft.fftn(jnp.asarray(form), axes=(axes if axes is not None else self._spatial_axes()), norm='ortho')

    def ifft(self, form, axes=None):
        """Ortho-normalized inverse DFT over the last D (spatial) axes."""
        return jnp.fft.ifftn(jnp.asarray(form), axes=(axes if axes is not None else self._spatial_axes()), norm='ortho')

    def convolution(self, f, g, axes=None):
        r"""Fourier-accelerated periodic convolution
        ``(f * g)(r) = sum_x f(x) g(r - x)``
        (convention of /root/reference/supervillain/lattice/compact.py:407-463)."""
        ax = axes if axes is not None else self._spatial_axes()
        return np.sqrt(self.sites) * self.ifft(self.fft(f, axes=ax) * self.fft(g, axes=ax), axes=ax)

    def correlation(self, f, g, axes=None):
        r"""Fourier-accelerated cross-correlation
        ``(f ⋆ g)(r) = (1/N^D) sum_x conj(f(x)) g(x - r)``
        (convention of /root/reference/supervillain/lattice/compact.py:465-536)."""
        ax = axes if axes is not None else self._spatial_axes()
        return self.fft(self.fft(f, axes=ax).conj() * self.fft(g, axes=ax), axes=ax) / np.sqrt(self.sites)

    # -- reshaping --------------------------------------------------------

    def linearize(self, v, dims=(-1,)):
        """Flatten each of the listed D-axis spatial blocks of ``v`` into one
        sites-sized axis (inverse of :meth:`coordinatize`)."""
        v = np.asarray(v) if not isinstance(v, jnp.ndarray) else v
        shape = v.shape
        v_dims = len(shape)
        dm = set(dims)
        future_dims = v_dims - (self.D - 1) * len(dm)
        dm = set(d % future_dims for d in dm)
        new_shape = []
        idx = 0
        for i in range(future_dims):
            if i not in dm:
                new_shape.append(shape[idx])
                idx += 1
            else:
                new_shape.append(self.sites)
                idx += self.D
        return v.reshape(new_shape)

    def coordinatize(self, v, dims=(-1,), center_origin=False):
        """Unflatten each listed sites-sized axis of ``v`` back into D spatial axes."""
        v = np.asarray(v) if not isinstance(v, jnp.ndarray) else v
        v_dims = len(v.shape)
        to_reshape = np.sort(np.remainder(np.array(dims), v_dims))
        new_shape = ()
        for i, s in enumerate(v.shape):
            new_shape += ((s,) if i not in to_reshape else self.dims)
        reshaped = v.reshape(new_shape)
        if not center_origin:
            return reshaped
        axes = to_reshape + np.arange(len(to_reshape)) * (self.D - 1)
        roll = np.roll if isinstance(reshaped, np.ndarray) else jnp.roll
        for a in axes:
            for d in range(self.D):
                reshaped = roll(reshaped, self.N // 2, axis=int(a) + d)
        return reshaped

    # -- hyperoctahedral symmetrization -----------------------------------

    @cached_property
    def _hyperoctahedral_permutations(self):
        """Site-index permutation arrays for the D!·2^D signed coordinate permutations
        (the B_D point group of the hypercubic lattice)."""
        coords = self.coordinates
        coord_to_idx = {tuple(c): k for k, c in enumerate(coords)}
        result = []
        for perm in permutations(range(self.D)):
            for signs in np.ndindex(*([2] * self.D)):
                sign_vec = np.array([1 - 2 * s for s in signs])
                idx_perm = np.array([
                    coord_to_idx[tuple(self.mod(sign_vec * coords[i][list(perm)]))]
                    for i in range(self.sites)
                ])
                result.append(idx_perm)
        return result

    def symmetrize(self, correlator, dims=(-1,)):
        """Average over the hyperoctahedral group: projects onto the trivial irrep of
        the lattice point group (/root/reference/supervillain/lattice/compact.py:629-655)."""
        C = np.asarray(self.linearize(np.asarray(correlator), dims=dims))
        v_dims = len(C.shape)
        sites_axis = list(dims)[0] % v_dims
        perms = self._hyperoctahedral_permutations
        result = np.sum([np.take(C, p, axis=sites_axis) for p in perms], axis=0)
        return self.coordinatize(result / len(perms), dims=dims)

    # -- persistence ------------------------------------------------------

    def to_h5(self, group):
        group.attrs['type'] = 'Lattice'
        group['D'] = self.D
        group['N'] = self.N

    @classmethod
    def from_h5(cls, group):
        return cls(int(np.asarray(group['D'])), int(np.asarray(group['N'])))


class Lattice2D(Lattice):
    """Thin D=2 specialization with reference-compatible aliases
    (/root/reference/supervillain/lattice/two_dimensional.py:9-180)."""

    def __init__(self, N):
        super().__init__(2, N)

    @property
    def nt(self):
        return self.N

    @property
    def nx(self):
        return self.N

    @property
    def t(self):
        return self.coord_1d

    @property
    def x(self):
        return self.coord_1d

    @property
    def T(self):
        return self.coords[0]

    @property
    def X(self):
        return self.coords[1]

    @cached_property
    def plaquettes(self):
        return self.sites

    def __repr__(self):
        return f'Lattice2D(N={self.N})'

    @classmethod
    def from_h5(cls, group):
        return cls(int(np.asarray(group['N'])))

    def plot_form(self, p, form, axis, label=None, cmap=None, pointsize=200,
                  linkwidth=0.025, markerstyle='o'):
        """Visualize a p-form on the axis: 0-forms as colored sites (scatter),
        1-forms as colored links (quiver-style bars), 2-forms as colored plaquettes
        (imshow) — the capability of the reference's
        Lattice2D.plot_form (/root/reference/supervillain/lattice/two_dimensional.py:75-180).
        """
        import matplotlib.pyplot as plt
        from matplotlib import colors as mcolors
        form = np.asarray(form)
        N = self.N
        norm = mcolors.CenteredNorm()
        cmap = cmap or plt.get_cmap('PiYG')
        if p == 0:
            sc = axis.scatter(*np.meshgrid(range(N), range(N), indexing='ij'),
                              c=form[0], cmap=cmap, norm=norm, s=pointsize,
                              marker=markerstyle, label=label)
            plt.colorbar(sc, ax=axis)
        elif p == 1:
            t, x = np.meshgrid(range(N), range(N), indexing='ij')
            cnorm = mcolors.CenteredNorm()
            cnorm.autoscale(form)
            for mu, (dt, dx) in enumerate(((1, 0), (0, 1))):
                for tt in range(N):
                    for xx in range(N):
                        axis.plot([tt, tt + dt], [xx, xx + dx],
                                  color=cmap(cnorm(form[mu, tt, xx])),
                                  linewidth=1 + 100 * linkwidth)
            axis.scatter(t, x, color='black', s=pointsize / 10, zorder=3)
        elif p == 2:
            im = axis.imshow(form[0].T, origin='lower', cmap=cmap, norm=norm,
                             extent=(-0.5, N - 0.5, -0.5, N - 0.5))
            plt.colorbar(im, ax=axis)
        else:
            raise ValueError(f'plot_form supports p in (0, 1, 2), got {p}')
        axis.set_xlabel('t')
        axis.set_ylabel('x')
        if label:
            axis.set_title(label)
        return axis


@lru_cache(maxsize=None)
def _cached_lattice(D, N):
    return Lattice(D, N)
