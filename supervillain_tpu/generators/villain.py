"""Monte-Carlo updates for the Villain action.

Each update is a pure jittable kernel over the field pytree ``{'phi', 'n'}``.
Checkerboard colors are *static masks* — a whole color's proposals, ΔS evaluation
(algebraic, via one fused ``face_sum``), Metropolis test, and application happen as a
few fused elementwise device kernels; the loop over colors is a static Python loop.

Update semantics match the reference generator-for-generator:
    SiteUpdate           /root/reference/supervillain/generator/villain/site.py:13-132
    LinkUpdate           .../villain/link.py:13-113
    ExactUpdate          .../villain/exact.py:12-141
    CohomologyUpdate     .../villain/cohomology.py:12-129
    NeighborhoodUpdate   .../villain/neighborhood.py:12-150
    ClassicWorm          .../villain/worm.py:17-196 (D=2)
    Hammer               .../villain/__init__.py:10-63
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import Lattice
from ..ops import calculus as calc
from ..models import Villain
from .base import (Generator, uniform_nonzero_int, uniform_int_with_zero,
                   zero_inflated_int, metropolis)
from .combining import Sequentially, KeepEvery

TWO_PI = 2 * np.pi


def _require_villain(action):
    if not isinstance(action, Villain):
        raise ValueError('Need a Villain action')


class SiteUpdate(Generator):
    r"""Checkerboarded Metropolis update of φ alone:
    ``Δφ_x ~ U(-interval_phi, +interval_phi)``, n fixed.

    ΔS is evaluated algebraically per link, ``(κ/2)·dΔφ·(2(dφ-2πn) + dΔφ)``, and
    aggregated per site with one ``face_sum`` per color."""

    name = 'SiteUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi):
        _require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        r = calc.d(L, 0, phi) - TWO_PI * n
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            mask = jnp.asarray(L.checkerboard_masks[ci])
            k1, k2 = jax.random.split(jax.random.fold_in(key, ci))
            prop = jax.random.uniform(k1, L.dims, dtype=fdt,
                                      minval=-self.interval_phi, maxval=self.interval_phi)
            change_phi = jnp.where(mask, prop, 0)[None]
            change_dphi = calc.d(L, 0, change_phi)
            dS_link = (S.kappa / 2) * change_dphi * (2 * r + change_dphi)
            dS = calc.face_sum(L, 1, dS_link)[0]
            accept, prob = metropolis(k2, dS, L.dims)
            accept = accept & mask
            applied = jnp.where(accept, change_phi[0], 0)[None]
            phi = phi + applied
            r = r + calc.d(L, 0, applied)
            accepted = accepted + accept.sum()
            acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        stats = self._tally(stats, accepted, float(L.sites), acceptance / L.sites)
        return cfg | {'phi': phi}, stats, {}


class LinkUpdate(Generator):
    r"""Whole-1-form simultaneous Metropolis update of n alone:
    ``Δn_ℓ ∈ W·(±{1..interval_n})``, φ fixed.  No checkerboarding is needed — with
    dφ frozen every link's ΔS is independent."""

    name = 'LinkUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_n=1):
        _require_villain(action)
        if action.W == float('inf'):
            raise ValueError('LinkUpdate changes dn by multiples of W; undefined at W=inf.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_n = int(interval_n)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        dphi = calc.d(L, 0, phi)
        k1, k2 = jax.random.split(key)
        change_n = S.W * uniform_nonzero_int(k1, n.shape, self.interval_n, dtype=n.dtype)
        dS = (-TWO_PI * S.kappa * change_n) * (dphi - TWO_PI * n - np.pi * change_n)
        accept, prob = metropolis(k2, dS, n.shape)
        n = n + jnp.where(accept, change_n, 0)

        stats = self._tally(stats, accept.sum().astype(fdt), float(L.links), prob.mean().astype(fdt))
        return cfg | {'n': n}, stats, {}


class ExactUpdate(Generator):
    r"""Coordinated update ``Δn = dz`` for an integer 0-form z so that ``d(Δn) = d²z = 0``
    — preserves dn exactly (works at W=∞).  Checkerboarded like :class:`SiteUpdate`."""

    name = 'ExactUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_z=1):
        _require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_z = int(interval_z)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        dphi = calc.d(L, 0, phi)
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            mask = jnp.asarray(L.checkerboard_masks[ci])
            k1, k2 = jax.random.split(jax.random.fold_in(key, ci))
            z = uniform_nonzero_int(k1, L.dims, self.interval_z, dtype=n.dtype)
            change_z = jnp.where(mask, z, 0)[None]
            change_n = calc.d(L, 0, change_z)
            dS_link = (-TWO_PI * S.kappa * change_n) * ((dphi - TWO_PI * n) - np.pi * change_n)
            dS = calc.face_sum(L, 1, dS_link)[0]
            accept, prob = metropolis(k2, dS, L.dims)
            accept = accept & mask
            applied_z = jnp.where(accept, change_z[0], 0)[None]
            n = n + calc.d(L, 0, applied_z)
            accepted = accepted + accept.sum()
            acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        stats = self._tally(stats, accepted, float(L.sites), acceptance / L.sites)
        return cfg | {'n': n}, stats, {}


class CohomologyUpdate(Generator):
    r"""Winding-sector update: for each direction μ, propose adding a constant
    ``h_μ ∈ ±{1..interval_h}`` to ``n_μ`` on the slice ``x_μ = 0``.  ``d(Δn) = 0``
    exactly, and the winding number w_μ changes by h_μ."""

    name = 'CohomologyUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_h=1):
        _require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_h = int(interval_h)
        # slice_masks[mu]: 1 on sites with x_mu = 0, shape dims.
        masks = []
        for mu in range(self.Lattice.D):
            m = np.zeros(self.Lattice.dims, dtype=bool)
            idx = tuple(0 if i == mu else slice(None) for i in range(self.Lattice.D))
            m[idx] = True
            masks.append(m)
        self._slice_masks = np.stack(masks)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        r = calc.d(L, 0, phi) - TWO_PI * n
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for mu in range(L.D):
            mask = jnp.asarray(self._slice_masks[mu])
            k1, k2 = jax.random.split(jax.random.fold_in(key, mu))
            h = uniform_nonzero_int(k1, (), self.interval_h, dtype=n.dtype)
            change_r = (-TWO_PI) * h.astype(fdt)
            dS = jnp.sum(jnp.where(mask, (S.kappa / 2) * change_r * (2 * r[mu] + change_r), 0))
            prob = jnp.clip(jnp.exp(-dS), max=1.0)
            accept = jax.random.uniform(k2, (), dtype=fdt) < prob
            dh = jnp.where(accept, h, 0)
            n = n.at[mu].add(jnp.where(mask, dh, 0))
            r = r.at[mu].add(jnp.where(mask, (-TWO_PI) * dh.astype(fdt), 0))
            accepted = accepted + accept.astype(fdt)
            acceptance = acceptance + prob

        stats = self._tally(stats, accepted, float(L.D), acceptance / L.D)
        return cfg | {'n': n}, stats, {}


class NeighborhoodUpdate(Generator):
    r"""Simultaneous site-neighborhood update: Δφ at each same-color site plus
    ``Δn ∈ W·{-interval_n..interval_n}`` on the 2D links touching it; the adjacent
    link sets of same-color sites are disjoint, so one fused ``face_sum`` aggregates
    ΔS per site."""

    name = 'NeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, p_n=None):
        """``p_n``: probability that each adjacent link proposes a nonzero Δn
        (zero-inflated symmetric proposal).  ``None`` (the default, the reference's
        scheme) draws Δn uniformly over W·{-interval_n..interval_n}, i.e. nonzero
        with probability 2i/(2i+1); at large κ those moves are almost always
        rejected, so a small p_n (~0.05) raises the acceptance — and the mixing
        rate — by an order of magnitude on big lattices while remaining an exact
        Metropolis kernel (the proposal stays symmetric)."""
        _require_villain(action)
        if action.W == float('inf'):
            raise ValueError('NeighborhoodUpdate offers Δn in multiples of W; undefined at W=inf.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_n)
        self.p_n = None if p_n is None else float(p_n)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        r = calc.d(L, 0, phi) - TWO_PI * n
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            mask = jnp.asarray(L.checkerboard_masks[ci])
            kp, kn, kb, km = jax.random.split(jax.random.fold_in(key, ci), 4)

            prop = jax.random.uniform(kp, L.dims, dtype=fdt,
                                      minval=-self.interval_phi, maxval=self.interval_phi)
            change_phi = jnp.where(mask, prop, 0)[None]

            # Forward link (mu, x) and backward link (mu, x - e_mu) per color site.
            if self.p_n is None:
                fwd = S.W * uniform_int_with_zero(kn, (L.D,) + L.dims, self.interval_n, dtype=n.dtype)
                bwd = S.W * uniform_int_with_zero(kb, (L.D,) + L.dims, self.interval_n, dtype=n.dtype)
            else:
                fwd = S.W * zero_inflated_int(kn, (L.D,) + L.dims, self.interval_n, self.p_n, dtype=n.dtype)
                bwd = S.W * zero_inflated_int(kb, (L.D,) + L.dims, self.interval_n, self.p_n, dtype=n.dtype)
            fwd_parts = []
            bwd_parts = []
            for mu in range(L.D):
                bwd_mask = jnp.roll(mask, -1, axis=mu)  # sites x - e_mu for x in color
                fwd_parts.append(jnp.where(mask, fwd[mu], 0))
                bwd_parts.append(jnp.where(bwd_mask, bwd[mu], 0))
            change_n_fwd = jnp.stack(fwd_parts)
            change_n_bwd = jnp.stack(bwd_parts)
            change_n = change_n_fwd + change_n_bwd

            change_r = calc.d(L, 0, change_phi) - TWO_PI * change_n
            dS_link = (S.kappa / 2) * change_r * (2 * r + change_r)
            dS = calc.face_sum(L, 1, dS_link)[0]

            accept, prob = metropolis(km, dS, L.dims)
            accept = accept & mask

            applied_phi = jnp.where(accept, change_phi[0], 0)[None]
            applied_parts = []
            for mu in range(L.D):
                acc_bwd = jnp.roll(accept, -1, axis=mu)
                applied_parts.append(jnp.where(accept, change_n_fwd[mu], 0)
                                     + jnp.where(acc_bwd, change_n_bwd[mu], 0))
            applied_n = jnp.stack(applied_parts)

            phi = phi + applied_phi
            n = n + applied_n
            r = r + calc.d(L, 0, applied_phi) - TWO_PI * applied_n
            accepted = accepted + accept.sum()
            acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        stats = self._tally(stats, accepted, float(L.sites), acceptance / L.sites)
        return cfg | {'phi': phi, 'n': n}, stats, {}


class ExactNeighborhoodUpdate(Generator):
    r"""Compound (Δφ, Δz) site update: each checkerboard-color site proposes a
    simultaneous Δφ and an integer Δz with Δn = d(Δz) on its adjacent links, so
    d(Δn) = d²(Δz) = 0 and the constraint dn ≡ 0 mod W is preserved *exactly
    at every W including W=∞* — this is the W=∞ analogue of
    :class:`NeighborhoodUpdate` (whose link proposals are multiples of W and
    therefore undefined at W=∞), fusing the reference's SiteUpdate + ExactUpdate
    (/root/reference/supervillain/generator/villain/{site,exact}.py) into one
    single-ΔS Metropolis kernel.  Dimension-general.

    The link-residual change is d(Δφ − 2πΔz): supported on the same 2D adjacent
    links as NeighborhoodUpdate's, with the same per-link ΔS algebra and the same
    color-disjointness argument (each link touches exactly one same-color site).

    ``p_z``: zero-inflated symmetric Δz proposal, like NeighborhoodUpdate's
    ``p_n``."""

    name = 'ExactNeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_z=1, p_z=None):
        _require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_z = int(interval_z)
        self.p_z = None if p_z is None else float(p_z)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype

        r = calc.d(L, 0, phi) - TWO_PI * n
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            mask = jnp.asarray(L.checkerboard_masks[ci])
            kp, kz, km = jax.random.split(jax.random.fold_in(key, ci), 3)

            prop = jax.random.uniform(kp, L.dims, dtype=fdt,
                                      minval=-self.interval_phi, maxval=self.interval_phi)
            change_phi = jnp.where(mask, prop, 0)[None]

            if self.p_z is None:
                z = uniform_int_with_zero(kz, L.dims, self.interval_z, dtype=n.dtype)
            else:
                z = zero_inflated_int(kz, L.dims, self.interval_z, self.p_z, dtype=n.dtype)
            change_z = jnp.where(mask, z, 0)[None]
            change_n = calc.d(L, 0, change_z)

            change_r = calc.d(L, 0, change_phi) - TWO_PI * change_n
            dS_link = (S.kappa / 2) * change_r * (2 * r + change_r)
            dS = calc.face_sum(L, 1, dS_link)[0]

            accept, prob = metropolis(km, dS, L.dims)
            accept = accept & mask

            applied_phi = jnp.where(accept, change_phi[0], 0)[None]
            applied_z = jnp.where(accept, change_z[0], 0)[None]
            applied_n = calc.d(L, 0, applied_z)

            phi = phi + applied_phi
            n = n + applied_n
            r = r + calc.d(L, 0, applied_phi) - TWO_PI * applied_n
            accepted = accepted + accept.sum()
            acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        stats = self._tally(stats, accepted, float(L.sites), acceptance / L.sites)
        return cfg | {'phi': phi, 'n': n}, stats, {}


class ClassicWorm(Generator):
    r"""Prokof'ev–Svistunov worm on the plaquettes of a D=2 lattice: the head moves to
    one of the 4 neighboring plaquettes, changing the crossed link's n while keeping dn
    fixed; when head == tail (or always, at W=1) a 20%-conditional close move returns
    to the z sector.  Tallies the inline ``Vortex_Vortex`` histogram and ``Worm_Length``.

    Pure ``lax.while_loop`` kernel with data-dependent trip count; vmaps over chains.
    Not ergodic alone (never changes φ or dn).

    ``max_moves`` bounds the trip count (fleet safety: under ``vmap`` every step
    waits for the *slowest* chain's worm, so an unbounded worm over many chains
    at W>1 has effectively unbounded step time).  A worm that has not closed
    after ``max_moves`` moves is rolled back (at W≠1; at W=1 the open
    configuration is itself valid and is kept).  Exactness: every micro-move
    satisfies detailed balance in the extended (fields, head, tail) space, so
    trajectories pair with their reversals at equal length — restricting to
    trajectories of length ≤ ``max_moves`` and returning the unclosed remainder
    to the start state preserves detailed balance of the whole-worm kernel, so
    the *field*-sector chain is exact.  The inline worm *estimators*
    (``Vortex_Vortex``, ``Worm_Length``) are a different matter: truncation
    removes the visits a long excursion would have contributed beyond
    ``max_moves``, so whenever truncation actually fires the histogram is
    biased toward short head–tail separations (the long-distance correlator
    tail is undersampled).  :meth:`report` therefore surfaces the truncated
    fraction — keep it ≲ a per-mille of worms (raise ``max_moves``) before
    using the inline correlator quantitatively."""

    name = 'ClassicWorm'
    fields = ('phi', 'n')

    # Neighboring-plaquette moves (east, north, west, south) in (t, x) array offsets,
    # the links each move crosses, and the constraint-restoring Δn per move.
    _moves = np.array([[0, -1], [1, 0], [0, 1], [-1, 0]])
    _link_dir = np.array([0, 1, 0, 1])
    _link_off = np.array([[0, 0], [1, 0], [0, 1], [0, 0]])
    _plaquette = np.array([+1, +1, -1, -1])

    def __init__(self, action, max_moves=None):
        _require_villain(action)
        if action.Lattice.D != 2:
            raise NotImplementedError('ClassicWorm is only implemented for D=2')
        self.Action = action
        self.Lattice = action.Lattice
        self.max_moves = None if max_moves is None else int(max_moves)

    def inline_shapes(self):
        L = self.Lattice
        return {'Vortex_Vortex': ((L.N, L.N), jnp.zeros(()).dtype),
                'Worm_Length': ((), jnp.zeros(()).dtype)}

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        N = L.N
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype
        dphi = calc.d(L, 0, phi)

        k_orient, k_tail, k_head, k_loop = jax.random.split(key, 4)
        orientation = jnp.where(jax.random.bernoulli(k_orient), 1, -1).astype(n.dtype)
        change_n = orientation * jnp.asarray(self._plaquette, dtype=n.dtype)

        tail = jax.random.randint(k_tail, (2,), 0, N)
        if S.W == 1:
            # At W=1 an open worm satisfies the (mod 1) constraint from the start.
            head = jax.random.randint(k_head, (2,), 0, N)
        else:
            head = tail

        moves = jnp.asarray(self._moves)
        link_dir = jnp.asarray(self._link_dir)
        link_off = jnp.asarray(self._link_off)

        cap = self.max_moves

        def cond(state):
            out = ~state[0]
            if cap is not None:
                out = out & (state[1] < cap)
            return out

        def body(state):
            done, t, key, head, n, hist = state
            key, k_close, k_choice, k_accept = jax.random.split(key, 4)

            closed = jnp.all(head == tail) | (S.W == 1)
            close_now = closed & (jax.random.uniform(k_close) >= 0.8)

            choice = jax.random.randint(k_choice, (), 0, 4)
            next_head = jnp.mod(head + moves[choice], N)
            ld = link_dir[choice]
            lpos = jnp.mod(head + link_off[choice], N)

            link_val = dphi[ld, lpos[0], lpos[1]] - TWO_PI * n[ld, lpos[0], lpos[1]]
            dn = change_n[choice]
            dS = (S.kappa / 2) * (-TWO_PI * dn) * (2 * link_val - TWO_PI * dn)
            accept = jax.random.uniform(k_accept, dtype=fdt) < jnp.clip(jnp.exp(-dS), max=1.0)
            accept = accept & ~close_now

            n = n.at[ld, lpos[0], lpos[1]].add(jnp.where(accept, dn, 0))
            head = jnp.where(accept, next_head, head)

            disp = jnp.mod(head - tail, N)
            hist = jnp.where(
                close_now, hist,
                hist.at[disp[0], disp[1]].add(1.0)
            )
            return close_now, t + 1, key, head, n, hist

        hist0 = jnp.zeros((N, N), dtype=fdt)
        closed, _, _, _, n_new, hist = jax.lax.while_loop(
            cond, body, (jnp.zeros((), bool), jnp.zeros((), jnp.int32),
                         k_loop, head, n, hist0))

        if cap is not None and S.W != 1:
            # Truncated (unclosed) worms roll the fields back; at W=1 the open
            # configuration is valid and kept (see class docstring).
            n_new = jnp.where(closed, n_new, n)
            closed_f = closed.astype(fdt)
        else:
            closed_f = jnp.ones((), fdt)

        wl = hist.sum()
        stats = self._tally(stats, wl, wl, closed_f)
        return cfg | {'n': n_new}, stats, {'Vortex_Vortex': hist, 'Worm_Length': wl}

    def report(self, stats=None):
        stats = stats if stats is not None else getattr(self, '_stats', self.init_stats())
        s = stats[self.name]
        worms = max(float(s['sweeps']), 1.0)
        line = (f'{self.name}: {worms:.0f} worms, mean length '
                f'{float(s["accepted"]) / worms:.3f}')
        truncated = worms - float(s['acceptance'])
        if self.max_moves is not None and truncated > 0.5:
            line += f' ({truncated:.0f} truncated at max_moves={self.max_moves})'
        return line


class ChunkedWorm(Generator):
    r"""Bounded-chunk multi-worm batching: the classic worm's move sequence,
    time-sliced into exactly ``moves_per_step`` micro-moves per step, with the
    open-worm state (head, tail, orientation) carried in the configuration
    between steps.  When the 20%-conditional close fires, a *new* worm starts
    immediately (fresh tail/head/orientation) inside the same chunk.

    Villain D=2, **W=1 only**.  At W=1 every configuration is physically valid
    (the dn ≡ 0 mod 1 constraint is trivial), and each micro-move satisfies
    detailed balance with respect to e^{-S(φ,n)} x uniform(head, tail): the
    Metropolis move's forward/reverse proposal probabilities are both
    0.8·(1/4), and the close+restart move resamples (head, tail, orientation)
    uniformly without touching the fields.  The extended chain's stationary
    fields-marginal is therefore exactly the Gibbs measure at *every* move, so
    fixed-stride emission is unbiased — unlike at W>1, where open worms carry
    a constraint defect and only closed configurations may be emitted
    (use :class:`ClassicWorm` there).

    Why this exists: under ``vmap`` over a fleet, :class:`ClassicWorm`'s
    ``while_loop`` runs until the *slowest* chain closes, so every step pays
    max-worm-length x (batched-scatter latency) — measured at ~57% of the full
    Hammer step wall-clock at L=64 with 1024 chains (benchmark/worm_cost.py).
    A fixed trip count removes the divergence entirely and makes the worm's
    cost deterministic and tunable.

    Tallies the same inline ``Vortex_Vortex`` histogram and ``Worm_Length``
    (moves tallied this step); ``sweeps`` in the stats counts completed worms.
    """

    name = 'ClassicWorm'  # same transition-kernel family; same stats tag
    fields = ('phi', 'n')

    _moves = ClassicWorm._moves
    _link_dir = ClassicWorm._link_dir
    _link_off = ClassicWorm._link_off
    _plaquette = ClassicWorm._plaquette

    def __init__(self, action, moves_per_step=8):
        _require_villain(action)
        if action.Lattice.D != 2:
            raise NotImplementedError('ChunkedWorm is only implemented for D=2')
        if action.W != 1:
            raise ValueError(
                'ChunkedWorm emits on a fixed stride, which is only unbiased at W=1 '
                '(open worms are valid configurations there); use ClassicWorm for W>1.')
        self.Action = action
        self.Lattice = action.Lattice
        self.moves_per_step = int(moves_per_step)

    def inline_shapes(self):
        L = self.Lattice
        return {'Vortex_Vortex': ((L.N, L.N), jnp.zeros(()).dtype),
                'Worm_Length': ((), jnp.zeros(()).dtype)}

    def prepare(self, cfg):
        if 'worm' in cfg:
            return cfg
        # Deterministic initial extended state (head = tail = origin, +1
        # orientation): an initial condition, not a kernel move, so it cannot
        # bias the stationary distribution.
        return cfg | {'worm': jnp.array([0, 0, 0, 0, 1], jnp.int32)}

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        N = L.N
        T = self.moves_per_step
        phi, n = cfg['phi'], cfg['n']
        fdt = phi.dtype
        dphi = calc.d(L, 0, phi)
        ws = cfg['worm']

        moves = jnp.asarray(self._moves)
        link_dir = jnp.asarray(self._link_dir)
        link_off = jnp.asarray(self._link_off)
        plaquette = jnp.asarray(self._plaquette, dtype=n.dtype)

        ku, kc, kr, ko = jax.random.split(key, 4)
        u = jax.random.uniform(ku, (T, 2), dtype=fdt)           # close, accept
        choices = jax.random.randint(kc, (T,), 0, 4)
        restarts = jax.random.randint(kr, (T, 4), 0, N)          # tail_t,x, head_t,x
        orients = jnp.where(jax.random.bernoulli(ko, 0.5, (T,)), 1, -1).astype(n.dtype)

        def body(i, state):
            n, ws, hist, closes = state
            head, tail, orientation = ws[:2], ws[2:4], ws[4].astype(n.dtype)
            close_now = u[i, 0] >= 0.8                           # W=1: always closed

            choice = choices[i]
            next_head = jnp.mod(head + moves[choice], N)
            ld = link_dir[choice]
            lpos = jnp.mod(head + link_off[choice], N)
            dn = orientation * plaquette[choice]

            link_val = dphi[ld, lpos[0], lpos[1]] - TWO_PI * n[ld, lpos[0], lpos[1]]
            dS = (S.kappa / 2) * (-TWO_PI * dn) * (2 * link_val - TWO_PI * dn)
            accept = (u[i, 1] < jnp.clip(jnp.exp(-dS), max=1.0)) & ~close_now

            n = n.at[ld, lpos[0], lpos[1]].add(jnp.where(accept, dn, 0))
            head = jnp.where(accept, next_head, head)

            disp = jnp.mod(head - tail, N)
            hist = jnp.where(close_now, hist, hist.at[disp[0], disp[1]].add(1.0))

            # Close + restart: fresh worm within the same chunk.
            tail = jnp.where(close_now, restarts[i, :2], tail)
            head = jnp.where(close_now, restarts[i, 2:], head)
            orientation = jnp.where(close_now, orients[i], orientation)
            ws = jnp.concatenate([head, tail, orientation[None]]).astype(jnp.int32)
            closes = closes + jnp.where(close_now, 1.0, 0.0)
            return n, ws, hist, closes

        hist0 = jnp.zeros((N, N), dtype=fdt)
        n, ws, hist, closes = jax.lax.fori_loop(
            0, T, body, (n, ws, hist0, jnp.zeros((), fdt)))

        wl = hist.sum()
        stats = self._tally(stats, wl, wl, jnp.ones((), fdt), sweeps=closes)
        return cfg | {'n': n, 'worm': ws}, stats, {'Vortex_Vortex': hist, 'Worm_Length': wl}

    def report(self, stats=None):
        stats = stats if stats is not None else getattr(self, '_stats', self.init_stats())
        s = stats[self.name]
        worms = max(float(s['sweeps']), 1.0)
        return (f'ChunkedWorm: {worms:.0f} worms, mean length '
                f'{float(s["accepted"]) / worms:.3f}')


def Hammer(S, worms=1, worm_moves=None, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Villain action (reference villain/__init__.py:10-63):
    Sequentially(Site, [Link if W<∞], Exact, Cohomology, [Worm if D==2]).

    ``worm_moves``: at W=1, replace the data-dependent-length :class:`ClassicWorm`
    with a :class:`ChunkedWorm` doing exactly that many micro-moves per step —
    the fleet-friendly variant whose cost does not scale with the slowest
    chain's worm (see benchmark/worm_cost.py).

    ``fleet``: compose a bounded-step-time worm suitable for vmapping over many
    chains (where an unbounded worm's step waits for the slowest chain):
    :class:`ChunkedWorm` at W=1, :class:`ClassicWorm` with
    ``max_moves=max_worm_moves`` (default 8·N²) at W>1.  ``max_worm_moves`` can
    also be passed without ``fleet`` to cap the bare worm."""
    _require_villain(S)
    parts = [SiteUpdate(S)]
    if S.W < float('inf'):
        parts.append(LinkUpdate(S))
    parts.append(ExactUpdate(S))
    parts.append(CohomologyUpdate(S))
    if S.Lattice.D == 2:
        if worm_moves is not None and S.W == 1:
            parts.append(ChunkedWorm(S, moves_per_step=worm_moves))
        elif fleet and S.W == 1:
            parts.append(ChunkedWorm(S, moves_per_step=worm_moves or 64))
        else:
            cap = max_worm_moves
            if fleet and cap is None:
                cap = 8 * S.Lattice.sites
            worm = ClassicWorm(S, max_moves=cap)
            parts.append(KeepEvery(worms, worm) if worms > 1 else worm)
    return Sequentially(parts)
