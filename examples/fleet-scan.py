#!/usr/bin/env python
"""Capability the reference lacks: a fleet of independent chains sharded
over the device mesh, scanning κ across the BKT transition with inline observables
and pooled bootstrap analysis + HDF5 output (the BASELINE "pod-scale" workload shape,
scaled to the available devices)."""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu package) on sys.path.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu').is_dir():
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import numpy as np
import h5py

import supervillain_tpu as sv
from supervillain_tpu.analysis import Bootstrap, Uncertain
from supervillain_tpu.generators import villain as gvillain
from supervillain_tpu.parallel import chain_mesh, sample_fleet

parser = sv.cli.ArgumentParser(description='Sharded multi-chain κ scan.')
parser.add_argument('--N', type=int, default=32)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--chains', type=int, default=64)
parser.add_argument('--steps', type=int, default=100)
parser.add_argument('--thin', type=int, default=4)
parser.add_argument('--cut', type=int, default=25)
parser.add_argument('--kappas', nargs='*', type=float, default=(0.5, 0.74, 1.0))
parser.add_argument('--h5', default='')
args = parser.parse_args()

import jax
mesh = chain_mesh() if len(jax.devices()) > 1 else None
L = sv.Lattice2D(args.N)

print(f'{len(jax.devices())} devices; {args.chains} chains of {args.steps}x{args.thin} '
      f'sweeps at N={args.N}')
print(f'{"kappa":>8s} {"ActionDensity":>16s} {"WindingSquared":>18s} {"acc(site)":>10s}')

results = {}
for kappa in args.kappas:
    S = sv.Villain(L, kappa, W=args.W)
    # fleet=True composes bounded worms (ChunkedWorm at W=1, max_moves-capped
    # ClassicWorm at W>1) so no step waits on the slowest chain's worm.
    G = gvillain.Hammer(S, fleet=True)
    fleet = sample_fleet(S, G, chains=args.chains, steps=args.steps, thin=args.thin,
                         seed=int(kappa * 1000), mesh=mesh)
    pooled = fleet.pooled_ensemble(cut=args.cut)
    b = Bootstrap(pooled, draws=100)
    sa = fleet.stats['SiteUpdate']
    results[kappa] = (fleet, b)
    print(f'{kappa:8.3f} {str(Uncertain(*b.estimate("ActionDensity"))):>16s} '
          f'{str(Uncertain(*b.estimate("WindingSquared"))):>18s} '
          f'{float(sa["accepted"]) / float(sa["proposed"]):>10.4f}')

if args.h5:
    with h5py.File(args.h5, 'w') as f:
        for kappa, (fleet, b) in results.items():
            fleet.to_h5(f.create_group(f'kappa={kappa}'))
    print(f'wrote {args.h5}')
