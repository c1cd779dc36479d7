"""Taxicab-path gather tables for the defect-reweighting correlators.

The Worldline ``Spin_Spin`` and Villain ``Vortex_Vortex`` measurements reweight by
the action change of a path-shaped field offset (reference observable/spin.py:49-224
and observable/vortex.py:62-189).  Per displacement the path is the taxicab route —
the full time separation first, then the full space separation (D=2 only, as in the
reference).

Device reformulation: instead of per-displacement Python loops with fancy indexing, we
precompute *padded* per-displacement gather tables (direction, offset, sign) once per
lattice on the host, and the measurement becomes a single batched gather + reduction,
chunked over displacement rows with ``lax.map`` to bound memory.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def spin_tables(D, N):
    """Padded path tables for the Worldline Spin_Spin taxicab measurement.

    Returns (dirs, offs, signs, lengths) with shapes (N, N, Lmax), (N, N, Lmax, 2),
    (N, N, Lmax), (N, N); displacement (i, j) labels Δ = (coord_1d[i], coord_1d[j]).
    Tracing along a link counts +1, against it −1.
    """
    if D != 2:
        raise NotImplementedError('Taxicab paths are implemented for D=2 only.')
    from ..ops.lattice import fft_coordinates
    coord = fft_coordinates(N)
    Lmax = 2 * (N // 2)
    dirs = np.zeros((N, N, Lmax), dtype=np.int32)
    offs = np.zeros((N, N, Lmax, 2), dtype=np.int32)
    signs = np.zeros((N, N, Lmax), dtype=np.int32)
    lengths = np.zeros((N, N), dtype=np.int32)

    for i in range(N):
        dt = int(coord[i])
        for j in range(N):
            dx = int(coord[j])
            T, X = abs(dt), abs(dx)
            length = T + X
            lengths[i, j] = length
            steps = []
            if dt > 0:
                # Temporal links at (0,0), (1,0), ..., (dt-1, 0), traced along (+).
                steps += [(0, (t, 0), +1) for t in range(dt)]
            elif dt < 0:
                # Traced against: links at (-1,0), ..., (dt, 0).
                steps += [(0, (t, 0), -1) for t in range(-1, dt - 1, -1)]
            if dx > 0:
                steps += [(1, (dt, x), +1) for x in range(dx)]
            elif dx < 0:
                steps += [(1, (dt, x), -1) for x in range(-1, dx - 1, -1)]
            for s, (d, (ot, ox), sg) in enumerate(steps):
                dirs[i, j, s] = d
                offs[i, j, s] = (ot % N, ox % N)
                signs[i, j, s] = sg
    return dirs, offs, signs, lengths


@lru_cache(maxsize=None)
def vortex_tables(D, N):
    """Padded dual-lattice path tables for the Villain Vortex_Vortex measurement.

    The path traces on the dual lattice from ★y to ★x; its Hodge star is a 1-form
    stencil on the original links (construction of reference vortex.py:160-180).
    Returns (dirs, offs, signs, lengths) shaped as in :func:`spin_tables`.
    """
    if D != 2:
        raise NotImplementedError('Taxicab paths are implemented for D=2 only.')
    from ..ops.lattice import fft_coordinates
    coord = fft_coordinates(N)
    Lmax = 2 * (N // 2)
    dirs = np.zeros((N, N, Lmax), dtype=np.int32)
    offs = np.zeros((N, N, Lmax, 2), dtype=np.int32)
    signs = np.zeros((N, N, Lmax), dtype=np.int32)
    lengths = np.zeros((N, N), dtype=np.int32)

    for i in range(N):
        dt = int(coord[i])
        for j in range(N):
            dx = int(coord[j])
            if (dt, dx) == (0, 0):
                continue
            # Build the stencil exactly as the reference does: slice assignments on a
            # zero 1-form followed by a one-site push per direction.
            stencil = np.zeros((2, N, N), dtype=np.int64)
            if dt > 0:
                stencil[1][:dt, 0] = +1
            elif dt < 0:
                stencil[1][dt:, 0] = -1
            stencil[1] = np.roll(stencil[1], 1, axis=0)   # push by (1, 0)
            if dx > 0:
                stencil[0][dt % N, :dx] = -1
            elif dx < 0:
                stencil[0][dt % N, dx:] = +1
            stencil[0] = np.roll(stencil[0], 1, axis=1)   # push by (0, 1)

            nz = np.nonzero(stencil)
            length = len(nz[0])
            lengths[i, j] = length
            dirs[i, j, :length] = nz[0]
            offs[i, j, :length, 0] = nz[1]
            offs[i, j, :length, 1] = nz[2]
            signs[i, j, :length] = stencil[nz]
    return dirs, offs, signs, lengths
