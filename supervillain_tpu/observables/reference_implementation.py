"""Slow/simple reference observables (the role of
/root/reference/supervillain/observable/reference_implementation/spin.py:5-185):
dense-stencil taxicab estimators that the fast gather-based measurements must equal
numerically, configuration by configuration."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .core import Observable
from ._taxicab import spin_tables, vortex_tables


def villain_numpy(kappa, phi, n):
    r"""Plain float64 NumPy evaluation of one Villain configuration's
    ``ActionDensity``, ``WindingSquared`` and ``Spin_Spin``, written from the
    definitions and sharing no code with the jnp measurements: links
    ``dφ - 2πn`` by forward differences, the 2-form ``dn`` on every
    orientation ``μ < ν``, and the spin correlator
    ``(1/Λ) Σ_x e^{-iφ(x)} e^{iφ(x-r)}`` as the transform of the power spectrum.
    Any D; ``phi`` is ``(1, *dims)`` and ``n`` is ``(D, *dims)``."""
    phi = np.asarray(phi, dtype=np.float64)[0]
    n = np.asarray(n, dtype=np.float64)
    D = phi.ndim
    sites = phi.size
    links = [np.roll(phi, -1, axis=mu) - phi - 2 * np.pi * n[mu] for mu in range(D)]
    action = 0.5 * kappa * sum((l ** 2).sum() for l in links) / sites
    dn = [(np.roll(n[nu], -1, axis=mu) - n[nu]) - (np.roll(n[mu], -1, axis=nu) - n[mu])
          for mu in range(D) for nu in range(mu + 1, D)]
    winding = np.mean(np.stack(dn) ** 2)
    power = np.abs(np.fft.fftn(np.exp(1j * phi))) ** 2
    spin = np.fft.fftn(power) / sites ** 2
    return {'ActionDensity': action, 'WindingSquared': winding, 'Spin_Spin': spin}


def _dense_stencils(tables, L):
    """Expand padded gather tables into dense 1-form stencils, one per displacement:
    shape (N, N, D, N, N)."""
    dirs, offs, signs, lengths = tables
    N = L.N
    out = np.zeros((N, N, L.D) + L.dims)
    for i in range(N):
        for j in range(N):
            for s in range(lengths[i, j]):
                out[i, j, dirs[i, j, s], offs[i, j, s, 0], offs[i, j, s, 1]] += signs[i, j, s]
    return out


class Spin_SpinSlow(Observable):
    r"""Worldline Spin_Spin via dense stencils and whole-volume contractions — a
    different mechanism than the fast gather implementation, kept as its numerical
    oracle.  Never optimize."""

    sequential = True

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        if L.D != 2:
            raise NotImplementedError('D=2 only')
        N = L.N
        dense = _dense_stencils(spin_tables(L.D, N), L)
        stencils = jnp.asarray(dense)
        lengths = jnp.asarray(np.abs(dense).sum(axis=(2, 3, 4)))

        result = []
        for i in range(N):
            row = []
            for j in range(N):
                P = stencils[i, j]
                # Average over all translations of the path: roll the stencil to
                # every starting site.
                vals = []
                for t in range(N):
                    for x in range(N):
                        Pt = jnp.roll(jnp.roll(P, t, axis=-2), x, axis=-1)
                        Pm = jnp.sum(Pt * Links)
                        vals.append(jnp.exp(-1 / (2 * S.kappa) * (2 * Pm + lengths[i, j])))
                row.append(jnp.mean(jnp.stack(vals)))
            result.append(jnp.stack(row))
        return jnp.stack(result)


class Vortex_VortexSlow(Observable):
    r"""Villain Vortex_Vortex via dense dual-lattice stencils — numerical oracle for
    the fast gather implementation."""

    sequential = True

    @staticmethod
    def Villain(S, Links):
        L = S.Lattice
        if L.D != 2:
            raise NotImplementedError('D=2 only')
        N = L.N
        dense = _dense_stencils(vortex_tables(L.D, N), L)
        stencils = jnp.asarray(dense)
        lengths = jnp.asarray(np.abs(dense).sum(axis=(2, 3, 4)))

        result = []
        for i in range(N):
            row = []
            for j in range(N):
                P = stencils[i, j]
                vals = []
                for t in range(N):
                    for x in range(N):
                        Pt = jnp.roll(jnp.roll(P, t, axis=-2), x, axis=-1)
                        Pn = jnp.sum(Pt * Links)
                        dS = -2 * np.pi * S.kappa * (Pn - np.pi * lengths[i, j])
                        vals.append(jnp.exp(-dS))
                row.append(jnp.mean(jnp.stack(vals)))
            result.append(jnp.stack(row))
        return jnp.stack(result)


class Spin_SpinSloppy(Observable):
    r"""Single-overlay taxicab Spin_Spin (the role of
    /root/reference/supervillain/observable/reference_implementation/spin.py:5-73):
    the boson creation/destruction defect always sits at the absolute origin, with no
    translation average — the same expectation value as :class:`~.spin.Spin_Spin` but
    less juice per configuration (noisier).  The Villain branch is the full FFT
    correlation, identical to the production measurement."""

    sequential = True

    @staticmethod
    def Villain(S, phi):
        L = S.Lattice
        cdtype = jnp.complex128 if jnp.result_type(0.0) == jnp.float64 else jnp.complex64
        spin = jnp.exp(1j * phi[0].astype(cdtype))
        return L.correlation(spin, spin)

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        if L.D != 2:
            raise NotImplementedError(
                'The Worldline Spin_Spin taxicab measurement is only implemented for D=2.')
        dirs, offs, signs, lengths = (jnp.asarray(t) for t in spin_tables(L.D, L.N))
        # One overlay only: the path starts at the absolute origin, so the padded
        # gather table's offsets ARE the link positions.
        vals = Links[dirs, offs[..., 0], offs[..., 1]]        # (N, N, Lmax)
        Pm = (signs * vals).sum(axis=-1)                      # (N, N)
        return jnp.exp(-1 / (2 * S.kappa) * (2 * Pm + lengths.astype(Pm.dtype)))
