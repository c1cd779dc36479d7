"""Monte-Carlo updates for the Worldline (dual) action.

Pure jittable kernels over the field pytree ``{'m', 'v'}`` maintaining the constraint
``δm = 0``.  The reference's input-sparse operators (delta_sparse / coface_sum_at,
/root/reference/supervillain/lattice/compact.py:1042-1285) exist to avoid O(volume)
work on a CPU; on an accelerator the masked *dense* forms are the fast path (everything fuses),
so each (color, component) pass works on full forms with static masks.

Update semantics match the reference generator-for-generator:
    VortexUpdate     /root/reference/supervillain/generator/worldline/vortex.py:12-207
    CoexactUpdate    .../worldline/coexact.py:12-195
    WrappingUpdate   .../worldline/wrapping.py:9-99
    PlaquetteUpdate  .../worldline/plaquette.py:9-113 (recast checkerboard-parallel;
                     the reference's randomized sequential site order is a CPU-ism —
                     same-color same-component plaquettes share no boundary links, so
                     the color-ordered sweep obeys detailed balance exactly like
                     CoexactUpdate's)
    ClassicWorm      .../worldline/worm.py:16-215 (dimension-general)
    Hammer           .../worldline/__init__.py:9-40
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import calculus as calc
from ..models import Worldline
from .base import Generator, uniform_nonzero_int, metropolis
from .combining import Sequentially, KeepEvery


def _require_worldline(action):
    if not isinstance(action, Worldline):
        raise ValueError('Need a Worldline action')


def _single_component(L, comp_idx, values, n_comps):
    """Embed spatial ``values`` as component ``comp_idx`` of a zeroed 2-form."""
    parts = [values if c == comp_idx else jnp.zeros_like(values) for c in range(n_comps)]
    return jnp.stack(parts)


class VortexUpdate(Generator):
    r"""Metropolis update of v alone, per (checkerboard color, 2-form component):
    ``Δv_p ∈ ±{1..interval_v}`` (finite W) or ``U(-interval_v, +interval_v)`` (W=∞).
    δv is maintained incrementally; ΔS is aggregated per plaquette with one
    ``coface_sum`` per (color, component) pass."""

    name = 'VortexUpdate'
    fields = ('m', 'v')

    def __init__(self, action, interval_v=1):
        _require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        # At W=∞ the proposal is continuous U(-interval_v, +interval_v): a
        # float width (e.g. 0.5) is meaningful and must not truncate to 0.
        self.interval_v = (float(interval_v) if action.W == float('inf')
                           else int(interval_v))

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        m, v = cfg['m'], cfg['v']
        W = S._W
        fdt = jnp.promote_types(v.dtype, jnp.float32)

        n_comps = len(L.components[2])
        delta_v = calc.delta(L, 2, v)
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            for comp in range(n_comps):
                mask = jnp.asarray(L.checkerboard_masks[ci])
                k1, k2 = jax.random.split(jax.random.fold_in(key, ci * n_comps + comp))
                if S.W < float('inf'):
                    vals = uniform_nonzero_int(k1, L.dims, self.interval_v, dtype=v.dtype)
                else:
                    vals = jax.random.uniform(k1, L.dims, dtype=v.dtype,
                                              minval=-self.interval_v, maxval=self.interval_v)
                change_v = _single_component(L, comp, jnp.where(mask, vals, 0), n_comps)
                cdv_W = calc.delta(L, 2, change_v) / W
                dS_link = (0.5 / S.kappa) * (-cdv_W) * (2 * (m - delta_v / W) - cdv_W)
                dS = calc.coface_sum(L, 1, dS_link)[comp]
                accept, prob = metropolis(k2, dS, L.dims)
                accept = accept & mask
                applied = _single_component(L, comp, jnp.where(accept, vals, 0), n_comps)
                v = v + applied
                delta_v = delta_v + calc.delta(L, 2, applied)
                accepted = accepted + accept.sum()
                acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        plaquettes = float(L.cells_of_degree[2])
        stats = self._tally(stats, accepted, plaquettes, acceptance / plaquettes)
        return cfg | {'v': v}, stats, {}


class CoexactUpdate(Generator):
    r"""Coordinated update ``Δm = δt`` with t an integer 2-form supported on one
    (component, color), so ``δ(Δm) = δ²t = 0`` and the constraint survives."""

    name = 'CoexactUpdate'
    fields = ('m', 'v')

    def __init__(self, action, interval_t=1):
        _require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_t = int(interval_t)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        m, v = cfg['m'], cfg['v']
        fdt = jnp.promote_types(jnp.asarray(v).dtype, jnp.float32)

        n_comps = len(L.components[2])
        delta_v_by_W = calc.delta(L, 2, v) / S._W  # frozen: only m changes
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            for comp in range(n_comps):
                mask = jnp.asarray(L.checkerboard_masks[ci])
                k1, k2 = jax.random.split(jax.random.fold_in(key, ci * n_comps + comp))
                vals = uniform_nonzero_int(k1, L.dims, self.interval_t, dtype=m.dtype)
                t = _single_component(L, comp, jnp.where(mask, vals, 0), n_comps)
                cm = calc.delta(L, 2, t)
                dS_link = (0.5 / S.kappa) * cm * (2 * (m - delta_v_by_W) + cm)
                dS = calc.coface_sum(L, 1, dS_link)[comp]
                accept, prob = metropolis(k2, dS, L.dims)
                accept = accept & mask
                applied_t = _single_component(L, comp, jnp.where(accept, vals, 0), n_comps)
                m = m + calc.delta(L, 2, applied_t)
                accepted = accepted + accept.sum()
                acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        plaquettes = float(L.cells_of_degree[2])
        stats = self._tally(stats, accepted, plaquettes, acceptance / plaquettes)
        return cfg | {'m': m}, stats, {}


class WrappingUpdate(Generator):
    r"""Coordinated ``Δm ∈ ±{1..interval_w}`` on entire straight cycles around the
    torus (one proposal per direction μ and perpendicular position), the only local
    update able to change the :class:`TorusWrapping`."""

    name = 'WrappingUpdate'
    fields = ('m', 'v')

    def __init__(self, action, interval_w=1):
        _require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_w = int(interval_w)

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        m, v = cfg['m'], cfg['v']
        fdt = jnp.promote_types(jnp.asarray(v).dtype, jnp.float32)

        links = m - calc.delta(L, 2, v) / S._W
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)
        new_m = []

        for mu in range(L.D):
            k1, k2 = jax.random.split(jax.random.fold_in(key, mu))
            perp_shape = tuple(1 if i == mu else L.N for i in range(L.D))
            prop = uniform_nonzero_int(k1, perp_shape, self.interval_w, dtype=m.dtype)
            change = jnp.broadcast_to(prop, L.dims)
            dS_link = (0.5 / S.kappa) * change * (2 * links[mu] + change)
            dS = dS_link.sum(axis=mu, keepdims=True)
            prob = jnp.clip(jnp.exp(-dS), max=1.0)
            draw = jax.random.uniform(k2, perp_shape, dtype=prob.dtype)
            accept = draw < prob
            new_m.append(m[mu] + jnp.where(jnp.broadcast_to(accept, L.dims), change, 0))
            accepted = accepted + accept.sum()
            acceptance = acceptance + prob.sum()

        n_cycles = float(L.D * L.N ** (L.D - 1))
        stats = self._tally(stats, accepted, n_cycles, acceptance / n_cycles)
        return cfg | {'m': jnp.stack(new_m)}, stats, {}


class PlaquetteUpdate(Generator):
    r"""Coordinated ±1 on the 4 boundary links of each plaquette together with
    ``Δv ∈ {-1, 0, +1}`` on the plaquette itself (Gattringer-style).  The boundary
    change is exactly ``δt``, so δm stays 0.  Swept per (color, component) exactly as
    :class:`CoexactUpdate` — same-color same-component plaquettes share no links.
    Not ergodic alone (cannot change the wrapping)."""

    name = 'PlaquetteUpdate'
    fields = ('m', 'v')

    def __init__(self, action):
        _require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        m, v = cfg['m'], cfg['v']
        W = S._W
        fdt = jnp.promote_types(jnp.asarray(v).dtype, jnp.float32)

        n_comps = len(L.components[2])
        f = m - calc.delta(L, 2, v) / W   # maintained incrementally
        accepted = jnp.zeros((), fdt)
        acceptance = jnp.zeros((), fdt)

        for ci in range(L.n_colors):
            for comp in range(n_comps):
                mask = jnp.asarray(L.checkerboard_masks[ci])
                k1, k2, k3 = jax.random.split(jax.random.fold_in(key, ci * n_comps + comp), 3)
                cm_vals = jnp.where(jax.random.bernoulli(k1, shape=L.dims), 1, -1).astype(m.dtype)
                cv_vals = jax.random.randint(k2, L.dims, -1, 2).astype(v.dtype)
                t = _single_component(L, comp, jnp.where(mask, cm_vals, 0), n_comps)
                change_v = _single_component(L, comp, jnp.where(mask, cv_vals, 0), n_comps)
                # Δf on the boundary links: δ(t) - δ(Δv)/W, supported on this
                # plaquette's 4 links only.
                change_f = calc.delta(L, 2, t) - calc.delta(L, 2, change_v) / W
                dS_link = (0.5 / S.kappa) * change_f * (2 * f + change_f)
                dS = calc.coface_sum(L, 1, dS_link)[comp]
                accept, prob = metropolis(k3, dS, L.dims)
                accept = accept & mask
                applied_t = _single_component(L, comp, jnp.where(accept, cm_vals, 0), n_comps)
                applied_v = _single_component(L, comp, jnp.where(accept, cv_vals, 0), n_comps)
                m = m + calc.delta(L, 2, applied_t)
                v = v + applied_v
                f = f + calc.delta(L, 2, applied_t) - calc.delta(L, 2, applied_v) / W
                accepted = accepted + accept.sum()
                acceptance = acceptance + jnp.where(mask, prob, 0).sum()

        plaquettes = float(L.cells_of_degree[2])
        stats = self._tally(stats, accepted, plaquettes, acceptance / plaquettes)
        return cfg | {'m': m, 'v': v}, stats, {}


class ClassicWorm(Generator):
    r"""Prokof'ev–Svistunov worm on sites, dimension-general: the head moves in one of
    2D directions, crossing links ±1 in m and keeping δm = 0 while open; a
    (2D+1)-th close move (when head == tail) returns to the z sector.  Tallies the
    inline ``Spin_Spin`` histogram and ``Worm_Length``.

    Standalone-ergodic at W=1 (any v can be absorbed into m); at W>1 it never changes
    v so it must be composed with other updates.

    ``max_moves`` bounds the trip count (fleet safety: under ``vmap`` every step
    waits for the slowest chain's worm).  A worm that has not closed after
    ``max_moves`` moves is rolled back — an open worldline worm violates δm = 0
    at head/tail for any W, so the rollback applies always.  Exactness: each
    micro-move satisfies detailed balance in the extended space, trajectories
    pair with equal-length reversals, so the symmetric length restriction
    preserves detailed balance and the *field*-sector chain is exact.  The
    inline ``Spin_Spin``/``Worm_Length`` estimators, however, lose the visits a
    long excursion would have contributed beyond the cap: when truncation
    actually fires they are biased toward short head–tail separations.
    :meth:`report` surfaces the truncated fraction — keep it ≲ a per-mille of
    worms before using the inline correlator quantitatively."""

    name = 'ClassicWorm'
    fields = ('m', 'v')

    def __init__(self, action, max_moves=None):
        _require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.max_moves = None if max_moves is None else int(max_moves)

    def inline_shapes(self):
        L = self.Lattice
        return {'Spin_Spin': (L.dims, jnp.zeros(()).dtype),
                'Worm_Length': ((), jnp.zeros(()).dtype)}

    def step(self, key, cfg, stats):
        S, L = self.Action, self.Lattice
        D, N = L.D, L.N
        m, v = cfg['m'], cfg['v']
        fdt = jnp.promote_types(jnp.asarray(v).dtype, jnp.float32)

        dvW = (calc.delta(L, 2, v) / S._W).astype(fdt)

        k_orient, k_tail, k_loop = jax.random.split(key, 3)
        orientation = jnp.where(jax.random.bernoulli(k_orient), 1, -1).astype(m.dtype)
        # Moving +e_k crosses the link at the head (Δm = +1); -e_k crosses the link
        # behind the head with the opposite sign.
        divergence = jnp.concatenate([jnp.ones(D, m.dtype), -jnp.ones(D, m.dtype)])
        change_m = orientation * divergence

        tail = jax.random.randint(k_tail, (D,), 0, N)

        # Unit moves for each of the 2D choices, as array-coordinate offsets.
        moves = np.concatenate([np.eye(D, dtype=int), -np.eye(D, dtype=int)])
        moves = jnp.asarray(moves)

        cap = self.max_moves

        def cond(state):
            out = ~state[0]
            if cap is not None:
                out = out & (state[1] < cap)
            return out

        def body(state):
            done, t, key, head, m, hist = state
            key, k_close, k_choice, k_accept = jax.random.split(key, 4)

            same = jnp.all(head == tail)
            close_now = same & (jax.random.uniform(k_close) < 1.0 / (2 * D + 1))

            choice = jax.random.randint(k_choice, (), 0, 2 * D)
            axis = jnp.mod(choice, D)
            next_head = jnp.mod(head + moves[choice], N)
            # +e_k crosses the link at head; -e_k crosses the link at next_head.
            lpos = jnp.where(choice < D, head, next_head)
            lidx = (axis,) + tuple(lpos[i] for i in range(D))

            link_val = m[lidx].astype(fdt) - dvW[lidx]
            dm = change_m[choice]
            dS = (0.5 / S.kappa) * dm * (2 * link_val + dm)
            accept = jax.random.uniform(k_accept, dtype=fdt) < jnp.clip(jnp.exp(-dS), max=1.0)
            accept = accept & ~close_now

            m = m.at[lidx].add(jnp.where(accept, dm, 0))
            head = jnp.where(accept, next_head, head)

            disp = jnp.mod(head - tail, N)
            hist = jnp.where(close_now, hist,
                             hist.at[tuple(disp[i] for i in range(D))].add(1.0))
            return close_now, t + 1, key, head, m, hist

        hist0 = jnp.zeros(L.dims, dtype=fdt)
        closed, _, _, _, m_new, hist = jax.lax.while_loop(
            cond, body, (jnp.zeros((), bool), jnp.zeros((), jnp.int32),
                         k_loop, tail, m, hist0))

        if cap is not None:
            # An unclosed worm violates δm = 0: roll the fields back.
            m_new = jnp.where(closed, m_new, m)
            closed_f = closed.astype(fdt)
        else:
            closed_f = jnp.ones((), fdt)

        wl = hist.sum()
        stats = self._tally(stats, wl, wl, closed_f)
        return cfg | {'m': m_new}, stats, {'Spin_Spin': hist, 'Worm_Length': wl}

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


def Hammer(S, worms=1, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Worldline action (reference worldline/__init__.py:9-40):
    Sequentially(Vortex, Coexact, Wrapping, Worm).

    ``fleet``: bound the worm's step time for vmapping over many chains
    (``max_moves=max_worm_moves``, default 8·sites); ``max_worm_moves`` can also
    be passed without ``fleet``."""
    _require_worldline(S)
    cap = max_worm_moves
    if fleet and cap is None:
        cap = 8 * S.Lattice.sites
    worm = ClassicWorm(S, max_moves=cap)
    return Sequentially((
        VortexUpdate(S),
        CoexactUpdate(S),
        WrappingUpdate(S),
        KeepEvery(worms, worm) if worms > 1 else worm,
    ))
