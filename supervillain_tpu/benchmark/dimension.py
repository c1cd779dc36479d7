"""Steady-state D>2 throughput: su/s vs chain count for the XLA generator path.

The sampler is the dimension-general XLA roll-stencil path in every D.  This
harness measures what the reference's profiling methodology asks for (/root/reference/docs/superpowers/specs/
2026-06-25-numba-form-kernels-design.md:19-44): the compile-excluded
steady-state rate, its saturation in chain count, and which roof binds.

Roofline bookkeeping for the D-dimensional XLA NeighborhoodUpdate sweep: each
of the 2^1 checkerboard colors materializes ~(8D+10) HBM-resident f32/i32
arrays of Λ = N^D sites per color pass (proposals, ΔS partials per direction,
accept masks, applied fields — XLA fuses elementwise chains but each fusion
boundary writes one array).  At 8⁴ the whole state is ~100 kB so everything is
cache/HBM-bandwidth-light; the binding resource is LAUNCH/dispatch overhead
until the chain batch makes each fused kernel big enough, after which the
per-site arithmetic and memory traffic bind, as in the D=2 path.  The measured curve below shows which
regime each batch size is in.

Run: ``python -m supervillain_tpu.benchmark.dimension`` (on a GPU; a CPU run
measures the host).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp


def steady_state_rate(D=4, N=8, chains=256, thin=16, reps=3, kappa=0.4, W=1,
                      seed=0):
    """Compile-excluded su/s for a vmapped XLA NeighborhoodUpdate fleet.

    One jitted program advances every chain ``thin`` sweeps (scan); the timed
    region chains ``reps`` such calls through a data dependency and gates on a
    host readback (the backend returns from dispatch early — see bench.py).
    Buffer donation keeps the steady state allocation-free.
    """
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv

    S = sv.Villain(sv.Lattice(D, N), kappa, W=W)
    G = gv.NeighborhoodUpdate(S)

    cfg0 = S.initial(float_dtype=jnp.float32, int_dtype=jnp.int32)
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    cfgs = jax.tree.map(jnp.array, cfgs)  # donatable (broadcast views are not)

    def one(k, c):
        c, _, _ = G.step(k, c, G.init_stats())
        return c

    @jax.jit
    def advance(key, cfgs):
        def body(cfgs, k):
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            return jax.vmap(one)(keys, cfgs), None
        cfgs, _ = jax.lax.scan(body, cfgs, jax.random.split(key, thin))
        return cfgs

    advance = jax.jit(advance, donate_argnums=(1,))
    key = jax.random.key(seed)
    key, k = jax.random.split(key)
    cfgs = advance(k, cfgs)
    float(jax.tree.leaves(cfgs)[0].sum())   # compile + thermalize gate

    start = time.perf_counter()
    for _ in range(reps):
        key, k = jax.random.split(key)
        cfgs = advance(k, cfgs)
    float(jax.tree.leaves(cfgs)[0].sum())
    elapsed = time.perf_counter() - start
    su = reps * chains * (N ** D) * thin
    return su / elapsed, elapsed


def saturation_curve(D=4, N=8, chain_counts=(32, 128, 512, 2048, 8192),
                     thin=16, reps=3, kappa=0.4, W=1, samples=3):
    """Median steady-state su/s per chain count, stopping once the last
    doubling gains <= 5% (the saturation knee)."""
    curve = {}
    prev = None
    for B in chain_counts:
        rates = sorted(steady_state_rate(D=D, N=N, chains=B, thin=thin,
                                         reps=reps, kappa=kappa, W=W, seed=s)[0]
                       for s in range(samples))
        r = rates[samples // 2]
        curve[f'chains={B}'] = r
        print(f'D={D} N={N} chains={B:>6}: {r:.3e} su/s', flush=True)
        if prev is not None and r < prev * 1.05:
            break
        prev = r
    return curve


if __name__ == '__main__':
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument('--D', type=int, default=4)
    ap.add_argument('--N', type=int, default=8)
    ap.add_argument('--thin', type=int, default=16)
    ap.add_argument('--kappa', type=float, default=0.4)
    ap.add_argument('--json', type=str, default=None)
    args = ap.parse_args()

    curve = saturation_curve(D=args.D, N=args.N, thin=args.thin,
                             kappa=args.kappa)
    payload = {'config': vars(args), 'steady_state_su_per_s': curve,
               'device': str(jax.devices()[0])}
    print(json.dumps(payload))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(payload, f, indent=1)
