#!/usr/bin/env python
"""D=4 topological-sector workload: fleet-run the 4-dimensional
Villain model and measure the observables that make D=4 the reference's
distinctive sector — the topological charge density
Q = (1/(2π)² · 1/4!) εᵐⁿᵖᑫ dn_mn dn_pq and its square, plus the winding
correlations (reference /root/reference/supervillain/observable/topological.py:
110-157 and test/test_topological_charge.py).

The sampler is the dimension-general XLA roll-stencil path (masked dense
color passes that XLA fuses into a handful of kernels); the worm is D=2-only,
so the D=4 Hammer is Site+Link+Exact+Cohomology.

At W=1 vortices are unconstrained and ⟨Q²⟩ > 0; at W=∞ dn = 0 exactly so
Q ≡ 0 identically — both are checked.  Defaults are sized for a GPU (8⁴;
--N 12 scales to 12⁴) and shrink to 3⁴ on a CPU backend.
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

import supervillain_tpu as sv
from supervillain_tpu.analysis import Bootstrap, Uncertain
from supervillain_tpu.generators import villain as gv
from supervillain_tpu.parallel import sample_fleet
from supervillain_tpu.utils import sized


def main():
    sv.utils.enable_compile_cache()
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--N', type=int, default=sized(8, 3))
    ap.add_argument('--chains', type=int, default=sized(32, 4))
    ap.add_argument('--steps', type=int, default=sized(60, 10))
    ap.add_argument('--thin', type=int, default=2)
    ap.add_argument('--cut', type=int, default=sized(20, 4))
    ap.add_argument('--kappas', type=float, nargs='+', default=[0.2, 0.4, 0.6])
    ap.add_argument('--W', type=sv.cli.W, default=1)
    ap.add_argument('--bootstraps', type=int, default=100)
    ap.add_argument('--h5', type=str, default=None)
    args = ap.parse_args()

    D = 4
    L = sv.Lattice(D, args.N)
    print(f'# D=4 Villain, {args.N}^4, W={args.W}, {args.chains} chains × '
          f'{args.steps}×{args.thin} Hammer steps, backend={jax.default_backend()}')
    print(f'{"κ":>6} {"ActionDensity":>16} {"WindingSquared":>16} '
          f'{"⟨Q²⟩·Λ":>16} {"su/s":>10}')

    results = {}
    for kappa in args.kappas:
        S = sv.Villain(L, kappa, W=args.W)
        G = gv.Hammer(S)   # Site[+Link]+Exact+Cohomology (worm is D=2-only)
        t0 = time.perf_counter()
        fleet = sample_fleet(S, G, chains=args.chains, steps=args.steps,
                             thin=args.thin, seed=int(kappa * 1000) + 7)
        seconds = time.perf_counter() - t0
        # su/s: sites touched by the Hammer's site-proposing passes (Site +
        # Exact both sweep every site once per application).
        su = 2 * args.chains * L.sites * args.thin * args.steps
        pooled = fleet.pooled_ensemble(cut=args.cut)
        b = Bootstrap(pooled, draws=args.bootstraps)
        mS, eS = b.estimate('ActionDensity')
        mW, eW = b.estimate('WindingSquared')
        q2 = np.asarray(pooled.TopologicalChargeDensitySquared) * L.sites
        mQ, eQ = q2.mean(), q2.std(ddof=1) / np.sqrt(len(q2))
        if args.W == float('inf'):
            assert abs(mQ) < 1e-20, 'Q must vanish identically at W=inf (dn=0)'
        results[kappa] = dict(S=(mS, eS), W2=(mW, eW), Q2V=(float(mQ), float(eQ)),
                              su_per_s=su / seconds, seconds=seconds)
        print(f'{kappa:>6.2f} {str(Uncertain(mS, eS)):>16} '
              f'{str(Uncertain(mW, eW)):>16} {str(Uncertain(mQ, eQ)):>16} '
              f'{su / seconds:>10.3g}', flush=True)

    if args.h5:
        import h5py
        with h5py.File(args.h5, 'w') as f:
            for kappa, res in results.items():
                g = f.create_group(f'kappa_{kappa}')
                for k, v in res.items():
                    g[k] = np.asarray(v)
    return results


if __name__ == '__main__':
    main()
