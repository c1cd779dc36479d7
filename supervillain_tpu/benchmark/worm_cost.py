"""Worm wall-clock share in a vmapped Hammer fleet.

The Villain ClassicWorm is a ``lax.while_loop`` with a data-dependent trip
count; vmapped over a chain batch every iteration advances *all* chains, so a
fleet step costs the max worm length over chains.  At W=1 the close move fires
with probability 0.2 each iteration (geometric, mean ~5 moves — reference
villain/worm.py:136-196 semantics), so the tail is light; at W>1 the worm must
random-walk the head back to the tail, whose return time on an N x N torus is
heavy-tailed (~N^2 log N), and the max over B chains can dominate the fleet
step.  This harness measures that share directly: wall-clock of the full
Hammer fleet step vs the same stack without the worm, plus the worm-length
distribution (mean and max over chains x steps).

``--formulation worldline`` measures the Worldline twin: the Hammer against
its local stack (Vortex, Coexact, Wrapping), whose worm's inline histogram is
the spin correlator.  ``--max-moves`` caps every worm (truncated worms roll
back); the Worldline worm needs it in the critical phase, where worms span
the lattice.

Run: ``python -m supervillain_tpu.benchmark.worm_cost --L 64 256 --chains 1024``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp


def _timed_fleet(generator, action, chains, steps, reps=2, seed=0,
                 collect_inline=None):
    """Wall-clock of `reps` launches of a `steps`-step vmapped fleet scan, the
    first (compiling) launch excluded; each timed launch ends in a host
    readback.  Returns (seconds_per_launch, inline_stack or None)."""
    cfg0 = generator.prepare(action.initial())
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape),
                         generator.init_stats())

    def one(k, c, s):
        c, s, inline = generator.step(k, c, s)
        keep = ({name: inline[name] for name in collect_inline}
                if collect_inline else {})
        return c, s, keep

    @jax.jit
    def run(key, cfgs, stats):
        def body(carry, k):
            cfgs, stats = carry
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            cfgs, stats, keep = jax.vmap(one)(keys, cfgs, stats)
            return (cfgs, stats), keep
        (cfgs, stats), keeps = jax.lax.scan(body, (cfgs, stats),
                                            jax.random.split(key, steps))
        return jax.tree.map(lambda x: x.sum(), cfgs), stats, keeps

    out, stats, keeps = run(jax.random.key(seed), cfgs, stats)
    float(jax.tree.leaves(out)[0])  # warmup + compile gate
    start = time.perf_counter()
    for r in range(reps):
        out, stats, keeps = run(jax.random.key(seed + 1 + r), cfgs, stats)
    float(jax.tree.leaves(out)[0])
    elapsed = (time.perf_counter() - start) / reps
    return elapsed, keeps


def worm_share(N, chains, steps=5, kappa=0.5, W=1, seed=0, reps=2,
               worm_moves=None, formulation='villain', max_moves=None):
    """Measure the worm's share of a Hammer fleet step at (N, chains).

    ``worm_moves``: measure the fixed-trip-count :class:`ChunkedWorm` variant
    (Villain, W=1 only) instead of the data-dependent-length ClassicWorm.
    ``max_moves``: cap each ClassicWorm at that many moves."""
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv, worldline as gw
    from supervillain_tpu.generators.combining import Sequentially

    if formulation == 'villain':
        S = sv.Villain(sv.Lattice2D(N), kappa, W)
        full = gv.Hammer(S, worm_moves=worm_moves, max_worm_moves=max_moves)
        parts = [gv.SiteUpdate(S)]
        if S.W < float('inf'):
            parts.append(gv.LinkUpdate(S))
        parts += [gv.ExactUpdate(S), gv.CohomologyUpdate(S)]
    elif formulation == 'worldline':
        S = sv.Worldline(sv.Lattice2D(N), kappa, W)
        full = gw.Hammer(S, max_worm_moves=max_moves)
        parts = [gw.VortexUpdate(S), gw.CoexactUpdate(S), gw.WrappingUpdate(S)]
    else:
        raise ValueError(f"formulation must be 'villain' or 'worldline', got {formulation!r}")
    local = Sequentially(parts)

    t_full, keeps = _timed_fleet(full, S, chains, steps, seed=seed, reps=reps,
                                 collect_inline=('Worm_Length',))
    t_local, _ = _timed_fleet(local, S, chains, steps, seed=seed, reps=reps)

    wl = np.asarray(keeps['Worm_Length'])  # (steps, chains)
    t_worm = max(0.0, t_full - t_local)
    # Under vmap every while-loop iteration advances all chains, so a step
    # costs its slowest chain's worm: per lock-step move, and per move done.
    lockstep_moves = float(wl.max(axis=1).sum())
    return {
        'formulation': formulation, 'N': N, 'chains': chains, 'steps': steps,
        'kappa': kappa, 'W': W, 'max_moves': max_moves,
        'worm': 'classic' if worm_moves is None else f'chunked({worm_moves})',
        't_full_s': t_full, 't_local_s': t_local,
        'local_site_steps_per_s': chains * S.Lattice.sites * steps / t_local,
        'worm_share': max(0.0, 1.0 - t_local / t_full),
        'worm_length_mean': float(wl.mean()),
        'worm_length_max': float(wl.max()),
        'worm_s_per_lockstep_move': t_worm / max(lockstep_moves, 1.0),
        'worm_s_per_chain_move': t_worm / max(float(wl.sum()), 1.0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, nargs='+', default=[64, 256])
    ap.add_argument('--chains', type=int, default=1024)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--kappa', type=float, default=0.5)
    ap.add_argument('--W', type=int, nargs='+', default=[1, 2])
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--chunked', type=int, default=None, metavar='T',
                    help='measure ChunkedWorm(T) instead of ClassicWorm (Villain, W=1 only)')
    ap.add_argument('--formulation', choices=('villain', 'worldline'), default='villain')
    ap.add_argument('--max-moves', type=int, default=None,
                    help='cap each ClassicWorm at this many moves')
    args = ap.parse_args(argv)

    from ..utils.device import enable_compile_cache, card
    enable_compile_cache()
    print(f'# device {jax.devices()[0].device_kind!r} x{len(jax.devices())} | {card()}',
          flush=True)
    for N in args.L:
        for W in args.W:
            if args.chunked is not None and (W != 1 or args.formulation != 'villain'):
                continue
            res = worm_share(N, args.chains, steps=args.steps,
                             kappa=args.kappa, W=W, reps=args.reps,
                             worm_moves=args.chunked, formulation=args.formulation,
                             max_moves=args.max_moves)
            print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
