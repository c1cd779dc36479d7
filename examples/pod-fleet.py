#!/usr/bin/env python
"""The BASELINE pod-scale workload: 10k+ chains as one SPMD program, with
autocorrelation + bootstrap analysis and HDF5 output.

The 10,240-chain L=64 fleet runs ``sample_fleet`` over the zero-inflated
neighborhood update; every kept record measures ActionDensity and
WindingSquared on the device, so the host receives two scalars per chain per
record and no fields.  On several devices ``--mesh`` shards the chain axis
over ``jax.devices()`` with zero cross-device collectives in the step.

Defaults are sized for a GPU; on a CPU backend they shrink to a smoke-test
fleet.
"""

# Allow running this script directly from anywhere.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu').is_dir():
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import time

import numpy as np
import jax
import jax.numpy as jnp

import supervillain_tpu as sv
from supervillain_tpu.analysis import Bootstrap, Uncertain, autocorrelation_time
from supervillain_tpu.generators import Generator, villain as gv
from supervillain_tpu.ops import calculus as calc
from supervillain_tpu.parallel import sample_fleet, chain_mesh
from supervillain_tpu.ensemble import Ensemble
from supervillain_tpu.configurations import Configurations
from supervillain_tpu.utils import sized


class WithDensities(Generator):
    """Wrap a Villain generator so each step also reports ActionDensity and
    WindingSquared inline (the fleet then keeps no fields)."""

    def __init__(self, generator):
        self.generator = generator
        self.Action = generator.Action
        self.name = generator.name

    def init_stats(self):
        return self.generator.init_stats()

    def step(self, key, cfg, stats):
        S = self.Action
        cfg, stats, inline = self.generator.step(key, cfg, stats)
        dn = calc.d(S.Lattice, 1, cfg['n']).astype(cfg['phi'].dtype)
        return cfg, stats, inline | {
            'ActionDensity': S(cfg['phi'], cfg['n']) / S.Lattice.sites,
            'WindingSquared': jnp.mean(dn ** 2)}


def main():
    sv.utils.enable_compile_cache()
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, default=sized(64, 8))
    ap.add_argument('--chains', type=int, default=sized(10240, 16))
    ap.add_argument('--kappa', type=float, default=0.74)
    ap.add_argument('--therm', type=int, default=sized(2048, 32))
    ap.add_argument('--steps', type=int, default=sized(128, 16))
    ap.add_argument('--thin', type=int, default=16)
    ap.add_argument('--mesh', action='store_true',
                    help='shard the chain batch over all jax.devices()')
    ap.add_argument('--h5', type=str, default='pod-fleet.h5')
    args = ap.parse_args()

    S = sv.Villain(sv.Lattice2D(args.L), args.kappa, W=1)
    mesh = chain_mesh() if args.mesh else chain_mesh(jax.devices()[:1])
    G = WithDensities(gv.NeighborhoodUpdate(S, interval_phi=0.7, p_n=0.05))

    t0 = time.perf_counter()
    # Thermalize inside the first records: run therm as extra leading records
    # and cut them in the analysis (keeps the driver a single loop).
    lead = max(1, args.therm // args.thin)
    fleet = sample_fleet(S, G, chains=args.chains, steps=lead + args.steps,
                         thin=args.thin, seed=20260821, mesh=mesh, keep_fields=False)
    seconds = time.perf_counter() - t0
    su = args.chains * S.Lattice.sites * args.thin * (lead + args.steps)

    # Autocorrelation of the per-chain ActionDensity series (the records are
    # `thin` sweeps apart; τ is reported in kept-record units).
    cols = fleet.columns['ActionDensity'][lead:]           # (steps, chains)
    taus = [float(autocorrelation_time(cols[:, c]))
            for c in range(0, cols.shape[1], max(1, cols.shape[1] // 32))]
    tau = float(np.mean(taus))

    # Bootstrap over independent chains of their time-means.
    e = Ensemble(S).from_configurations(Configurations({
        'ActionDensity': cols.mean(axis=0),
        'WindingSquared': fleet.columns['WindingSquared'][lead:].mean(axis=0),
    }))
    b = Bootstrap(e, draws=200)
    mS, eS = b.estimate('ActionDensity')
    mW, eW = b.estimate('WindingSquared')

    print(f'# pod-fleet: {args.chains} chains, L={args.L}, κ={args.kappa}, '
          f'{mesh.devices.size}-device mesh, {jax.devices()[0].device_kind}')
    print(f'records {args.steps}×thin={args.thin} after {lead} lead records; '
          f'{seconds:.1f} s total (compile included) = {su / seconds:.3g} site-updates/s')
    print(f'ActionDensity  = {Uncertain(mS, eS)}')
    print(f'WindingSquared = {Uncertain(mW, eW)}')
    print(f'autocorrelation time ≈ {tau:.2f} kept records '
          f'({tau * args.thin:.0f} sweeps)')

    if args.h5:
        import h5py
        with h5py.File(args.h5, 'w') as f:
            fleet.to_h5(f.create_group('fleet'))
        print(f'wrote {args.h5}')
    return fleet


if __name__ == '__main__':
    main()
