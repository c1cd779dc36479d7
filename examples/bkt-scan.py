#!/usr/bin/env python
"""BKT scan at L=256 (BASELINE config #4): a fleet κ-scan across the W=1
critical coupling κ_c ≈ 0.74 (reference publication/generalized-bkt.rst:13)
driven by ``sample_fleet`` over the neighborhood update, with

* ActionDensity / WindingSquared measured on every kept record,
* periodic spin-correlator measurements: Spin_Spin = correlation(e^{iφ}, e^{iφ})
  (same math as observables/spin.py:Spin_Spin.Villain), bootstrapped into
  SpinSusceptibility / SpinSusceptibilityScaled (Δ = W²/8 at finite W), and
* at W>1, classic worms after the sweeps of every record: they restore
  ergodicity across the Z_W winding sectors and supply the inline vortex
  correlator.

Across the scan the scaled susceptibility χ_S/L^{D−2Δ} rises steeply through
κ_c as the spin correlator turns from exponential decay to the critical
power law — the generalized-BKT signature this framework exists to measure.

Defaults are sized for a GPU; on a CPU backend they shrink to L=64 and 8
chains so the script stays runnable end-to-end anywhere.  Scale
--chains/--records up for physics-grade error bars.
"""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu package) on sys.path.
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
from supervillain_tpu.analysis import Bootstrap, Uncertain
from supervillain_tpu.ensemble import Ensemble
from supervillain_tpu.configurations import Configurations
from supervillain_tpu.generators import KeepEvery, Sequentially, villain as gv
from supervillain_tpu.parallel import sample_fleet, check_truncation_budget
from supervillain_tpu.utils import sized


def main():
    sv.utils.enable_compile_cache()
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, default=sized(256, 64))
    ap.add_argument('--chains', type=int, default=sized(32, 8))
    ap.add_argument('--therm-sweeps', type=int, default=400)
    ap.add_argument('--records', type=int, default=24)
    ap.add_argument('--thin', type=int, default=25, help='sweeps per record')
    ap.add_argument('--kappas', type=float, nargs='+',
                    default=[0.55, 0.65, 0.74, 0.85, 1.00])
    ap.add_argument('--p_n', type=float, default=0.05,
                    help='zero-inflated Δn proposal probability (mixing at scale)')
    ap.add_argument('--bootstraps', type=int, default=100)
    ap.add_argument('--h5', type=str, default=None, help='write per-κ results here')
    ap.add_argument('--save-hist', action='store_true',
                    help='also store the per-chain summed worm histogram '
                         '(Vortex_Vortex, (chains, L, L)) in the h5 — enables '
                         'offline shape fits G_V(r) ~ r^{-η} at criticality, '
                         'which beat the origin-normalized susceptibility '
                         'ratio on η precision')
    ap.add_argument('--W', type=int, default=1,
                    help='finite vortex constraint; Δ = W²/8 scales the '
                         'susceptibility, Δn proposals come in multiples of W')
    ap.add_argument('--worms', type=int, default=None,
                    help='classic worms per record, after its sweeps.  '
                         'Default: 1 at W>1, 0 at W=1.  At W>1 the bare '
                         'neighborhood update only changes n in multiples of '
                         'W, freezing the Z_W winding sectors at their '
                         'cold-start value — worms restore ergodicity there '
                         'AND supply the inline vortex correlator.')
    args = ap.parse_args()

    N, B = args.L, args.chains
    L = sv.Lattice2D(N)
    W = args.W
    worms = args.worms if args.worms is not None else (0 if W == 1 else 1)
    Delta = W ** 2 / 8
    scale = N ** (L.D - 2 * Delta)
    # Dual (vortex-sector) exponent: Δ_V = 2/W² — the generalized-BKT pair
    # (reference publication/generalized-bkt.rst: the W² / 4-over-W² duality).
    DeltaV = 2 / W ** 2
    scaleV = N ** (L.D - 2 * DeltaV)

    def generator(S):
        """One application per worm (or per record without worms): the
        record's share of sweeps, then a worm capped at 64·N² moves (an exact
        truncation-rollback; the recorded truncation fraction bounds the
        χ_V-estimator-only bias)."""
        sweep = gv.NeighborhoodUpdate(S, interval_phi=0.7, interval_n=1, p_n=args.p_n)
        if worms == 0:
            return sweep, args.thin
        per_worm = max(1, args.thin // worms)
        sweeps = KeepEvery(per_worm, sweep) if per_worm > 1 else sweep
        return Sequentially([sweeps, gv.ClassicWorm(S, max_moves=64 * N * N)]), worms

    @jax.jit
    def winding_sectors(n):
        """Per-chain Z_W holonomy bits (w_t, w_x) mod W — the homological
        sectors only torus-wrapping worms can change.  Recorded so the scan
        artifact carries *measured* sector populations per κ (mobility is
        physical: free in the vortex-plasma phase, exponentially slow past
        the transition — for the reference's local stack identically)."""
        wt = jnp.sum(n[:, 0, :, 0], axis=1) % W
        wx = jnp.sum(n[:, 1, 0, :], axis=1) % W
        return wt, wx

    @jax.jit
    def spin_correlator(phi):
        """Per-chain Spin_Spin (N, N) real part, from the current φ."""
        cdtype = jnp.complex64
        spin = jnp.exp(1j * phi[:, 0].astype(cdtype))
        return jax.vmap(lambda s: L.correlation(s, s))(spin).real

    expect = '  (κ_c ≈ 0.74 expected)' if W == 1 else ''
    print(f'# L={N} chains={B} W={W} Δ={Delta} Δ_V={DeltaV} worms/record={worms}{expect}')
    head = (f'{"κ":>6} {"acc":>6} {"ActionDensity":>16} {"WindingSq":>14} '
            f'{"χ_S":>14} {"χ_S/L^(D-2Δ)":>14}')
    if worms > 0:
        head += f' {"χ_V/L^(D-2Δ_V)":>15}'
    print(head)

    results = {}
    for kappa in args.kappas:
        t0 = time.perf_counter()
        S_action = sv.Villain(L, kappa, W)
        G, per_record = generator(S_action)
        # Thermalize inside the first records, then cut them.
        lead = -(-args.therm_sweeps // args.thin)
        fleet = sample_fleet(S_action, G, chains=B, steps=lead + args.records,
                             thin=per_record, seed=20260820)
        phi = fleet.columns['phi'][lead:]                  # (records, B, 1, N, N)
        kept = fleet.pooled_ensemble(cut=lead)
        S_col = np.asarray(kept.ActionDensity).reshape(args.records, B)
        W2_col = np.asarray(kept.WindingSquared).reshape(args.records, B)
        chi_col = np.empty((args.records, B))
        for r in range(args.records):
            corr = np.asarray(spin_correlator(phi[r]))     # (B, N, N)
            chi_col[r] = corr.sum(axis=(1, 2)) / corr[:, 0, 0]
        histV = (fleet.columns['Vortex_Vortex'][lead:].sum(axis=0)
                 if worms > 0 else None)                  # (B, N, N)
        wt, wx = winding_sectors(fleet.final['n'])
        nontrivial_sectors = float((np.asarray(wt) != 0).mean()
                                   + (np.asarray(wx) != 0).mean()) / 2
        sweep_stats = fleet.stats['NeighborhoodUpdate']
        acc_frac = float(sweep_stats['accepted']) / float(sweep_stats['proposed'])

        # Bootstrap over per-chain means: chains are independent by
        # construction, while records within one chain stay correlated
        # whenever thin < τ — pooling them would understate errors.
        # Truncation budget: record the truncated fraction of worms per scan
        # point, and warn loudly past ~1e-3 — the worm-inclusive inline
        # correlator carries a documented short-separation bias whenever
        # truncation fires, so a silently truncation-heavy point must not be
        # used quantitatively.
        truncated, trunc_frac = 0.0, 0.0
        if worms > 0:
            worm_stats = fleet.stats['ClassicWorm']
            total = float(worm_stats['sweeps'])
            truncated = total - float(worm_stats['acceptance'])
            trunc_frac = check_truncation_budget(truncated, total,
                                                 context=f'kappa={kappa}: ')

        cols = {'SpinSusceptibility': chi_col.mean(axis=0)}
        if worms > 0:
            origin = np.maximum(histV[:, 0, 0], 1e-30)
            cols['VortexSusceptibility'] = histV.sum(axis=(1, 2)) / origin
        e = Ensemble(S_action).from_configurations(Configurations(cols))
        b = Bootstrap(e, draws=args.bootstraps)
        ep = Ensemble(S_action).from_configurations(Configurations({
            'ActionDensity': S_col.mean(axis=0),
            'WindingSquared': W2_col.mean(axis=0),
        }))
        bp = Bootstrap(ep, draws=args.bootstraps)
        mS, eS = bp.estimate('ActionDensity')
        mW, eW = bp.estimate('WindingSquared')
        mX, eX = b.estimate('SpinSusceptibility')
        results[kappa] = dict(acc=acc_frac, S=(mS, eS), W2=(mW, eW),
                              chi=(mX, eX), chi_scaled=(mX / scale, eX / scale),
                              nontrivial_sector_frac=nontrivial_sectors,
                              worms_truncated=truncated,
                              trunc_frac=trunc_frac,
                              seconds=time.perf_counter() - t0)
        line = (f'{kappa:>6.2f} {acc_frac:>6.1%} {str(Uncertain(mS, eS)):>16} '
                f'{str(Uncertain(mW, eW)):>14} {str(Uncertain(mX, eX)):>14} '
                f'{str(Uncertain(mX / scale, eX / scale)):>14}')
        if worms > 0:
            mV, eV = b.estimate('VortexSusceptibility')
            results[kappa]['chiV'] = (mV, eV)
            results[kappa]['chiV_scaled'] = (mV / scaleV, eV / scaleV)
            if args.save_hist:
                results[kappa]['Vortex_Vortex_hist'] = histV
            line += f' {str(Uncertain(mV / scaleV, eV / scaleV)):>15}'
            line += f'  sect={nontrivial_sectors:.2f}'
        print(line, flush=True)

        if args.h5:
            # Write incrementally (one group per finished κ): a fleet scan is
            # hours of chip time, and a crash at κ_i must not lose κ_{<i}.
            import h5py
            with h5py.File(args.h5, 'a') as f:
                name = f'kappa_{kappa}'
                if name in f:
                    del f[name]
                g = f.create_group(name)
                for k, v in results[kappa].items():
                    g[k] = np.asarray(v)
    return results


if __name__ == '__main__':
    main()
