"""Sweep-throughput scaling harness: sweeps/s and site-updates/s as a function of
device count on the chain mesh (the BASELINE multi-host scaling-efficiency metric).

On a real pod run this after ``jax.distributed.initialize()``; on a dev box the
virtual CPU mesh (``--xla_force_host_platform_device_count``) demonstrates the same
SPMD program.

Run as a script: ``python -m supervillain_tpu.benchmark.scaling``.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _fleet_sweeps(action, generator, chains, steps, mesh):
    """One jitted fleet program: `steps` sweeps of `chains` chains, sharded."""
    cfg0 = action.initial()
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape),
                         generator.init_stats())
    if mesh is not None:
        shard = lambda x: jax.device_put(
            x, NamedSharding(mesh, P('chains', *([None] * (x.ndim - 1)))))
        cfgs = jax.tree.map(shard, cfgs)
        stats = jax.tree.map(shard, stats)

    def one(k, c, s):
        c, s, _ = generator.step(k, c, s)
        return c, s

    @jax.jit
    def run(key, cfgs, stats):
        def body(carry, k):
            cfgs, stats = carry
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            return jax.vmap(one)(keys, cfgs, stats), None
        (cfgs, stats), _ = jax.lax.scan(body, (cfgs, stats), jax.random.split(key, steps))
        return jax.tree.map(lambda x: x.sum(), cfgs), stats

    return run, cfgs, stats


def scaling_efficiency(N=32, chains_per_device=8, steps=10, device_counts=None,
                       kappa=0.5):
    """Measure sweeps/s at 1, 2, ..., n devices (chains scale with devices — weak
    scaling, the production regime) and report parallel efficiency."""
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv

    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]

    S = sv.Villain(sv.Lattice2D(N), kappa, W=1)
    results = []
    base = None
    base_core = None
    print(f'{"devices":>8} {"chains":>7} {"sweeps/s":>12} {"su/s":>14} '
          f'{"efficiency":>11} {"cores busy":>11} {"eff/core":>9}')
    for nd in device_counts:
        mesh = Mesh(np.array(devices[:nd]), ('chains',)) if nd > 1 else None
        chains = chains_per_device * nd
        G = gv.NeighborhoodUpdate(S)
        run, cfgs, stats = _fleet_sweeps(S, G, chains, steps, mesh)
        out, _ = run(jax.random.key(0), cfgs, stats)
        float(jax.tree.leaves(out)[0])
        start = time.perf_counter()
        cpu0 = time.process_time()
        out, _ = run(jax.random.key(1), cfgs, stats)
        float(jax.tree.leaves(out)[0])
        elapsed = time.perf_counter() - start
        # Cores kept busy during the run: on a VIRTUAL device mesh every
        # "device" executes on this process's shared XLA:CPU thread pool, so
        # the 1-device baseline already spreads one device's work across ALL
        # physical cores (intra-op parallelism).  The naive per-device
        # efficiency therefore compares n devices against an inflated
        # baseline; per-CORE efficiency divides that inflation out and is the
        # number that predicts real multi-chip behavior (one chip per
        # process, no shared pool).
        cores_busy = (time.process_time() - cpu0) / max(elapsed, 1e-9)
        sweeps_per_s = chains * steps / elapsed
        su_per_s = sweeps_per_s * N * N
        per_device = sweeps_per_s / nd
        per_core = sweeps_per_s / max(cores_busy, 1e-9)
        if base is None:
            base = per_device
            base_core = per_core
        eff = per_device / base
        eff_core = per_core / base_core
        results.append({'devices': nd, 'chains': chains, 'sweeps_per_s': sweeps_per_s,
                        'site_updates_per_s': su_per_s, 'efficiency': eff,
                        'cores_busy': cores_busy,
                        'efficiency_per_core': eff_core})
        print(f'{nd:>8} {chains:>7} {sweeps_per_s:>12.1f} {su_per_s:>14.3e} '
              f'{eff:>10.1%} {cores_busy:>11.2f} {eff_core:>8.1%}')
    return results


def audit_collectives(N=32, chains=64, steps=10, kappa=0.5):
    """Compile the sharded fleet step over the full device mesh and count the
    cross-device collective ops in the optimized HLO.

    Chains are independent Markov chains, so the SPMD program should contain
    **zero** collectives — communication-free weak scaling: the multi-host
    efficiency of this program is structural (bounded by per-chip throughput
    and host dispatch, not by ICI/DCN), which is how the ≥90% BASELINE target
    is met by design."""
    import re
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv

    devices = jax.devices()
    mesh = Mesh(np.array(devices), ('chains',))
    S = sv.Villain(sv.Lattice2D(N), kappa, W=1)
    G = gv.NeighborhoodUpdate(S)
    cfg0 = S.initial()
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape),
                         G.init_stats())
    shard = lambda x: jax.device_put(
        x, NamedSharding(mesh, P('chains', *([None] * (x.ndim - 1)))))
    cfgs = jax.tree.map(shard, cfgs)
    stats = jax.tree.map(shard, stats)

    def one(k, c, s):
        c, s, _ = G.step(k, c, s)
        return c, s

    @jax.jit
    def run(key, cfgs, stats):
        # Returns the sharded state as-is: this is the steady-state program the
        # chain loop executes (output pooling/statistics aggregation happens
        # once at the very end of a run, not per step).
        def body(carry, k):
            cfgs, stats = carry
            keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(chains))
            return jax.vmap(one)(keys, cfgs, stats), None
        (cfgs, stats), _ = jax.lax.scan(body, (cfgs, stats),
                                        jax.random.split(key, steps))
        return cfgs, stats

    hlo = run.lower(jax.random.key(0), cfgs, stats).compile().as_text()
    counts = {op: len(re.findall(op, hlo))
              for op in ('all-reduce', 'all-gather', 'all-to-all',
                         'collective-permute', 'reduce-scatter')}
    return counts


def audit_space_mesh_collectives(N=32, space=4, kappa=0.5, W=2):
    """Compile a *space-sharded* Hammer step (lattice last axis split over the
    mesh's ``space`` axis) and count the collectives in the optimized HLO.

    Complement of :func:`audit_collectives`: the chains mesh must show **zero**
    collectives (independent chains), while the space mesh *must* show
    ``collective-permute > 0`` — XLA partitions the roll stencils with halo
    permutes.  Zero here would mean XLA gathered the whole lattice per device
    (sharding annotation lost), so the expected-positive count is itself the
    audit."""
    import re
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv

    devices = jax.devices()
    if len(devices) < space:
        raise ValueError(f'need {space} devices, have {len(devices)}')
    mesh = Mesh(np.array(devices[:space]).reshape(1, space), ('chains', 'space'))
    S = sv.Villain(sv.Lattice2D(N), kappa, W=W)
    G = gv.Hammer(S, fleet=True)
    chains = 1
    cfg0 = S.initial()
    cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (chains,) + x.shape), cfg0)
    cfgs = {k: jax.device_put(v, NamedSharding(mesh, P('chains', None, None, 'space')))
            for k, v in cfgs.items()}
    stats = jax.tree.map(
        lambda x: jax.device_put(jnp.broadcast_to(x, (chains,) + x.shape),
                                 NamedSharding(mesh, P('chains'))),
        G.init_stats())

    def one(k, c, s):
        c, s, _ = G.step(k, c, s)
        return c, s

    @jax.jit
    def run(key, cfgs, stats):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(chains))
        return jax.vmap(one)(keys, cfgs, stats)

    hlo = run.lower(jax.random.key(0), cfgs, stats).compile().as_text()
    counts = {op: len(re.findall(op, hlo))
              for op in ('all-reduce', 'all-gather', 'all-to-all',
                         'collective-permute', 'reduce-scatter')}
    return counts


def _force_virtual_cpu(n):
    """Before any backend use: switch to n virtual CPU devices (dev-box mode)."""
    import os
    flags = os.environ.get('XLA_FLAGS', '')
    if '--xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (flags + f' --xla_force_host_platform_device_count={n}').strip()
    jax.config.update('jax_platforms', 'cpu')


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--virtual-cpu', type=int, default=0,
                    help='Force N virtual CPU devices (dev-box demonstration).')
    ap.add_argument('--N', type=int, default=32)
    ap.add_argument('--chains-per-device', type=int, default=8)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--json', type=str, default=None,
                    help='Write the results (scaling table + collective audit '
                         '+ host-core caveat) to this path as JSON.')
    args = ap.parse_args()
    if args.virtual_cpu:
        _force_virtual_cpu(args.virtual_cpu)
    table = scaling_efficiency(N=args.N, chains_per_device=args.chains_per_device,
                               steps=args.steps)
    collectives = audit_collectives(N=args.N)
    print('collective ops in the compiled SPMD fleet step:', collectives)
    try:
        space_collectives = audit_space_mesh_collectives(N=args.N)
    except ValueError as e:
        space_collectives = {'unavailable': str(e)}
    print('collective ops in the space-sharded Hammer step:', space_collectives)
    if args.json:
        import json
        import os
        payload = {
            'config': {'N': args.N, 'chains_per_device': args.chains_per_device,
                       'steps': args.steps,
                       'backend': jax.default_backend(),
                       'devices': len(jax.devices()),
                       'host_physical_cores': os.cpu_count()},
            'weak_scaling': table,
            'collectives_in_compiled_step': collectives,
            'collectives_in_space_sharded_step': space_collectives,
            'note': ('Chains are independent: the compiled SPMD step contains '
                     'zero cross-device collectives, so weak scaling is '
                     'communication-free by construction. On a virtual CPU '
                     'mesh the naive per-device efficiency is misleading at '
                     'EVERY device count, including 2 devices on 2 cores: '
                     'all virtual devices share one XLA:CPU intra-op thread '
                     'pool, so the 1-device baseline already runs on every '
                     'physical core (cores_busy > 1 in the table), inflating '
                     'the denominator. efficiency_per_core divides the '
                     'measured core occupancy out and is the program-level '
                     'number that predicts real multi-chip behavior (one '
                     'chip per host process, no shared pool). The '
                     'space-sharded Hammer step must instead show '
                     'collective-permute > 0: XLA partitions the roll '
                     'stencils with halo permutes riding ICI.'),
        }
        with open(args.json, 'w') as f:
            json.dump(payload, f, indent=1)
        print(f'wrote {args.json}')
