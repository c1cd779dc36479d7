"""Headline benchmark: site-updates/s of the Villain NeighborhoodUpdate sweep
(the reference's default end-to-end generator) over a fleet of 512 chains at
L=256, on one GPU.

    python bench.py

Prints the device (platform, kind, count) and the card's name and power
limit, then ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The fleet is the XLA path users get from ``sample_fleet``: ``vmap`` over
chains of ``NeighborhoodUpdate.step``, ``lax.scan`` over steps, per-chain keys
folded from the chain index.  The first call compiles and is not timed; each
timed call ends in a host readback of the state.  Exits non-zero where JAX
finds no GPU.

``vs_baseline`` compares against a single-chain vectorized-NumPy
implementation of the same checkerboarded sweep — the reference's execution
model (NumPy array ops per color) — measured in the same process on the
host's CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np


def numpy_baseline_sweep(N, kappa, W, steps, rng):
    """Single-chain checkerboarded neighborhood sweep in vectorized NumPy (the
    reference's execution model).  Returns elapsed seconds."""
    D = 2
    dims = (N, N)
    phi = np.zeros((1,) + dims)
    n = np.zeros((D,) + dims, dtype=np.int64)

    coords = np.indices(dims)
    parity = coords.sum(axis=0) % 2
    masks = [parity == c for c in (0, 1)]

    def d0(f):
        return np.stack([np.roll(f[0], -1, axis=k) - f[0] for k in range(D)])

    def face_sum1(f):
        return sum(f[k] + np.roll(f[k], +1, axis=k) for k in range(D))

    start = time.perf_counter()
    r = d0(phi) - 2 * np.pi * n
    for _ in range(steps):
        for mask in masks:
            change_phi = np.where(mask, rng.uniform(-np.pi, np.pi, dims), 0)[None]
            fwd = W * rng.integers(-1, 2, (D,) + dims)
            bwd = W * rng.integers(-1, 2, (D,) + dims)
            change_n = np.empty_like(n)
            for mu in range(D):
                bwd_mask = np.roll(mask, -1, axis=mu)
                change_n[mu] = np.where(mask, fwd[mu], 0) + np.where(bwd_mask, bwd[mu], 0)
            change_r = d0(change_phi) - 2 * np.pi * change_n
            dS = face_sum1((kappa / 2) * change_r * (2 * r + change_r))
            accept = (rng.uniform(0, 1, dims) < np.exp(-np.clip(dS, -50, 50))) & mask
            applied_phi = np.where(accept, change_phi[0], 0)[None]
            applied_n = np.empty_like(n)
            for mu in range(D):
                acc_bwd = np.roll(accept, -1, axis=mu)
                applied_n[mu] = np.where(accept, change_n[mu] * mask, 0) \
                    + np.where(acc_bwd, change_n[mu] * np.roll(mask, -1, axis=mu), 0)
            phi = phi + applied_phi
            n = n + applied_n
            r = r + d0(applied_phi) - 2 * np.pi * applied_n
    return time.perf_counter() - start


def main():
    import jax
    import jax.numpy as jnp
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv
    from supervillain_tpu.utils.device import enable_compile_cache, require_gpu, card

    enable_compile_cache()
    require_gpu('bench.py')
    device = jax.devices()[0]
    print(f'# device platform={device.platform} kind={device.device_kind!r} '
          f'count={len(jax.devices())} | {card()}', flush=True)

    N, kappa, chains = 256, 0.5, 512
    steps, reps = 50, 5
    L = sv.Lattice2D(N)
    S = sv.Villain(L, kappa, W=1)
    G = gv.NeighborhoodUpdate(S)

    cfg0 = S.initial(float_dtype=jnp.float32, int_dtype=jnp.int32)
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape).astype(jnp.float32),
                         G.init_stats())

    def one(k, c, s):
        c, s, _ = G.step(k, c, s)
        return c, s

    @jax.jit
    def fleet_steps(key, cfgs, stats):
        def body(carry, k):
            cfgs, stats = carry
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            return jax.vmap(one)(keys, cfgs, stats), None
        (cfgs, stats), _ = jax.lax.scan(body, (cfgs, stats), jax.random.split(key, steps))
        return cfgs, stats

    start = time.perf_counter()
    cfgs, stats = fleet_steps(jax.random.key(0), cfgs, stats)
    float(cfgs['phi'].sum())
    compile_s = time.perf_counter() - start

    times = []
    for r in range(reps):
        start = time.perf_counter()
        cfgs, stats = fleet_steps(jax.random.key(1 + r), cfgs, stats)
        float(cfgs['phi'].sum())
        times.append(time.perf_counter() - start)
    elapsed = float(np.median(times))
    rate = chains * L.sites * steps / elapsed

    base_steps = 5
    base_elapsed = numpy_baseline_sweep(N, kappa, 1, base_steps, np.random.default_rng(0))
    base_rate = (L.sites * base_steps) / base_elapsed

    print(json.dumps({
        'metric': f'site-updates/s (Villain NeighborhoodUpdate, XLA fleet, L={N}, '
                  f'{chains} chains)',
        'value': rate,
        'unit': 'site-updates/s',
        'vs_baseline': rate / base_rate,
        'detail': {
            'seconds_per_call': times,
            'timing': f'median of {reps} calls of {steps} steps, first call '
                      '(compile) excluded',
            'first_call_s': compile_s,
            'steps_per_call': steps,
            'chains': chains,
            'L': N,
            'baseline_rate_numpy_1chain_host_cpu': base_rate,
            'device': {'platform': device.platform, 'kind': device.device_kind,
                       'count': len(jax.devices())},
            'card': card(),
        },
    }))


if __name__ == '__main__':
    main()
