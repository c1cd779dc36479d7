"""Discrete exterior calculus on the compact p-form layout, in pure JAX.

Operators: exterior derivative ``d``, codifferential ``delta``, unsigned incidence
aggregators ``face_sum``/``coface_sum``, Hodge–de Rham Laplacian, Hodge ``star``,
``wedge`` product, and the periodic translations ``push``/``pull``.

Semantics match the reference exactly (conventions documented at
/root/reference/supervillain/lattice/compact.py:973-1495 and lattice/reference.py),
but the implementation is accelerator-idiomatic: every operator is a *static* Python loop over
``jnp.roll`` shift-and-accumulate terms generated from the lattice incidence tables.
Under ``jit`` XLA fuses the whole loop into a handful of elementwise kernels; there is
no table-driven gather at runtime and no per-site work on the host.

All functions take the input form *unbatched*, shape ``(C(D,p), N, ..., N)``; batch
with ``jax.vmap``.  Integer inputs stay integer (all four incidence operators and the
Laplacian are exact integer combinations of shifts).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .lattice import Lattice, _sorting_sign

__all__ = [
    'd', 'delta', 'face_sum', 'coface_sum', 'laplacian', 'star', 'wedge',
    'push', 'pull', 'inner',
]


def _shift_accumulate(lattice: Lattice, op: str, p: int, f, out_degree: int, mode: str):
    """Shared engine for d / delta / face_sum / coface_sum.

    ``mode`` selects the per-row term:
      * ``'fwd_diff'``:  sign * (roll(s, -1, axis) - s)        [d]
      * ``'bwd_diff'``: -sign * (s - roll(s, +1, axis))        [delta]
      * ``'fwd_sum'``:   s + roll(s, -1, axis)                 [coface_sum]
      * ``'bwd_sum'``:   s + roll(s, +1, axis)                 [face_sum]
    """
    D = lattice.D
    table = lattice.operator_table(op, p)
    from math import comb
    n_out = comb(D, out_degree)
    terms = [None] * n_out
    for out_idx, in_idx, axis, sign in table:
        s = f[in_idx]
        ax = axis - D  # spatial axis `axis` counted from the right (vmap-safe)
        if mode == 'fwd_diff':
            t = jnp.roll(s, -1, axis=ax) - s
            t = sign * t
        elif mode == 'bwd_diff':
            t = s - jnp.roll(s, +1, axis=ax)
            t = (-sign) * t
        elif mode == 'fwd_sum':
            t = s + jnp.roll(s, -1, axis=ax)
        elif mode == 'bwd_sum':
            t = s + jnp.roll(s, +1, axis=ax)
        else:  # pragma: no cover
            raise ValueError(mode)
        terms[out_idx] = t if terms[out_idx] is None else terms[out_idx] + t
    return jnp.stack(terms)


def d(lattice: Lattice, p: int, f):
    r"""Exterior derivative of a p-form: ``(df)_O[x] = sum_j (-1)^j Δ_{o_j} f_{O\{o_j}}[x]``
    with the forward difference ``Δ_k A[x] = A[x+e_k] - A[x]``.  Returns a (p+1)-form,
    or scalar 0 for a top form (reference compact.py:973-1001)."""
    if p == lattice.D:
        return jnp.zeros((), dtype=jnp.asarray(f).dtype)
    return _shift_accumulate(lattice, 'd', p, f, p + 1, 'fwd_diff')


def delta(lattice: Lattice, p: int, f):
    r"""Codifferential (formal adjoint of :func:`d`) of a p-form: a (p-1)-form built
    from backward differences, or scalar 0 for a 0-form (reference compact.py:1008-1039)."""
    if p == 0:
        return jnp.zeros((), dtype=jnp.asarray(f).dtype)
    return _shift_accumulate(lattice, 'delta', p, f, p - 1, 'bwd_diff')


def face_sum(lattice: Lattice, p: int, f):
    r"""Unsigned sum of a p-form onto its (p-1)-faces:
    ``g_M[x] = sum_{O ⊃ M} (f_O[x] + f_O[x - e_e])`` (reference compact.py:848-867).
    Used to aggregate per-link ΔS onto sites in Metropolis sweeps."""
    if p == 0:
        return jnp.zeros((), dtype=jnp.asarray(f).dtype)
    return _shift_accumulate(lattice, 'face_sum', p, f, p - 1, 'bwd_sum')


def coface_sum(lattice: Lattice, p: int, f):
    r"""Unsigned sum of a p-form onto incident (p+1)-cofaces:
    ``g_O[x] = sum_{M ⊂ O} (f_M[x] + f_M[x + e_o])`` (reference compact.py:869-890)."""
    if p == lattice.D:
        return jnp.zeros((), dtype=jnp.asarray(f).dtype)
    return _shift_accumulate(lattice, 'coface_sum', p, f, p + 1, 'fwd_sum')


def laplacian(lattice: Lattice, p: int, f):
    r"""Hodge–de Rham Laplacian ``Δ = dδ + δd``, evaluated directly as the
    component-diagonal nearest-neighbor stencil
    ``(Δf)_I[x] = sum_k (2 f_I[x] - f_I[x+e_k] - f_I[x-e_k])``
    (the cross terms cancel on the flat torus; reference compact.py:1292-1345).
    Exact integer combination of shifts, so it preserves dtype."""
    D = lattice.D
    result = (2 * D) * f
    for k in range(D):
        ax = k - D
        result = result - jnp.roll(f, -1, axis=ax) - jnp.roll(f, +1, axis=ax)
    return result


def star(lattice: Lattice, p: int, f):
    r"""Hodge star of a p-form, a (D-p)-form:
    ``(★f)_J[x] = σ(I⌢J) f_I[x - e_I]`` with I the complement of J and the alignment
    shift ``e_I = sum_{k∈I} e_k`` (reference compact.py:1360-1416)."""
    D = lattice.D
    out = []
    for J_comp in lattice.components[D - p]:
        J = set(J_comp)
        I_comp = tuple(k for k in range(D) if k not in J)
        sign = _sorting_sign(I_comp + J_comp)
        s = f[lattice.comp_index[p][I_comp]]
        for k in I_comp:
            s = jnp.roll(s, +1, axis=k - D)
        out.append(sign * s)
    return jnp.stack(out)


def wedge(lattice: Lattice, pa: int, a, pb: int, b):
    r"""Wedge product of an n-form and an m-form, an (n+m)-form:
    ``(a ∧ b)_O[x] = sum_{O = A ⊔ B} σ(A⌢B) a_A[x] b_B[x + e_A]``
    (reference compact.py:1423-1495)."""
    from itertools import combinations as _comb
    D = lattice.D
    n, m = pa, pb
    if n + m > D:
        raise ValueError(f'Cannot wedge a {n}-form and a {m}-form in D={D}')
    out = []
    for out_comp in lattice.components[n + m]:
        acc = None
        for A_dirs in _comb(out_comp, n):
            B_dirs = tuple(k for k in out_comp if k not in A_dirs)
            inversions = sum(1 for k in A_dirs for j in B_dirs if j < k)
            sign = (-1) ** inversions
            a_sp = a[lattice.comp_index[n][A_dirs]]
            b_sp = b[lattice.comp_index[m][B_dirs]]
            for k in A_dirs:
                b_sp = jnp.roll(b_sp, -1, axis=k - D)
            term = sign * (a_sp * b_sp)
            acc = term if acc is None else acc + term
        out.append(acc)
    return jnp.stack(out)


def push(form, shift):
    r"""Translate forward: ``push(f, Δx)[..., x] = f[..., x - Δx]`` (periodic);
    reference compact.py:904-927."""
    result = jnp.asarray(form)
    for i, s in enumerate(shift):
        if s:
            result = jnp.roll(result, int(s), axis=i - len(shift))
    return result


def pull(form, shift):
    r"""Translation operator ``T_Δx``: ``pull(f, Δx)[..., x] = f[..., x + Δx]``."""
    return push(form, tuple(-s for s in shift))


def inner(a, b):
    """Componentwise inner product ``⟨a, b⟩ = sum_{I,x} a_I[x] b_I[x]``."""
    return jnp.sum(a * b)
