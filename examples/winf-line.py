#!/usr/bin/env python
"""The W=∞ line of fixed points: continuously varying critical exponent.

With vortices forbidden (dn = 0 exactly) the model is a free massless compact
boson at EVERY κ — a line of fixed points with continuously varying spin
exponent.  For the Villain normalization S = (κ/2)Σ(dφ − 2πn)² the Gaussian
correlator gives the exact power law

    ⟨e^{iφ(x)} e^{-iφ(0)}⟩ ~ r^{-η(κ)},   η(κ) = 1/(2πκ)

with no BKT-style logarithmic corrections (there is no marginal operator —
nothing to run).  So the two-volume effective exponent of the spin
susceptibility must land on 1/(2πκ) at every κ — measured here at three
volumes per κ with ``sample_fleet`` over the W=∞ stack: z-mode neighborhood
sweeps (compound Δφ, Δz with Δn = dΔz, so dn = 0 exactly) and one worm per
record (worms keep the winding sectors formally ergodic, cf.
docs/physics-results.md §5).

(The reference quotes the scaling dimension in a different R-normalization —
supervillain/observable/spin.py:234 — but the measurable power of the
two-point function is convention-free, which is what this workload checks.)

Defaults are sized for a GPU; on a CPU backend they shrink to a smoke test.
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
from supervillain_tpu.analysis import Uncertain
from supervillain_tpu.analysis.scaling import (effective_exponent,
                                               effective_exponent_error)
from supervillain_tpu.generators import Generator, KeepEvery, Sequentially, villain as gv
from supervillain_tpu.parallel import sample_fleet, chain_mesh
from supervillain_tpu.utils import sized


class WithSpinSusceptibility(Generator):
    """Wrap a Villain generator so each step also reports the spin
    susceptibility ratio Σ_r C(r) / C(0) of its configuration inline."""

    def __init__(self, generator, action):
        self.generator, self.Action, self.name = generator, action, generator.name

    def init_stats(self):
        return self.generator.init_stats()

    def step(self, key, cfg, stats):
        cfg, stats, inline = self.generator.step(key, cfg, stats)
        spin = jnp.exp(1j * cfg['phi'][0].astype(jnp.complex64))
        corr = self.Action.Lattice.correlation(spin, spin).real
        return cfg, stats, inline | {'chi': corr.sum() / corr[0, 0]}


def main():
    sv.utils.enable_compile_cache()
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--Ls', type=int, nargs='+', default=sized([64, 128, 256], [4, 8]))
    ap.add_argument('--kappas', type=float, nargs='+',
                    default=sized([0.5 / np.pi, 1.0 / np.pi, 2.0 / np.pi], [1.0 / np.pi]))
    ap.add_argument('--records', type=int, default=sized(24, 4))
    ap.add_argument('--therm-factor', type=int, default=8)
    args = ap.parse_args()

    def chi_at(N, kappa):
        B = max(16, 4096 // N)
        S = sv.Villain(sv.Lattice2D(N), kappa, W=float('inf'))
        thin = max(64, N * N // 8)
        sweeps = KeepEvery(thin, gv.ExactNeighborhoodUpdate(S, interval_phi=1.5))
        G = WithSpinSusceptibility(
            Sequentially([sweeps, gv.ClassicWorm(S, max_moves=64 * N * N)]), S)
        lead = -(-args.therm_factor * N * N // thin)
        fleet = sample_fleet(S, G, chains=B, steps=lead + args.records, seed=20260822,
                             mesh=chain_mesh(jax.devices()[:1]), keep_fields=False)
        per_chain = fleet.columns['chi'][lead:].mean(axis=0)
        return per_chain.mean(), per_chain.std(ddof=1) / np.sqrt(B)

    print(f'# W=inf line of fixed points: eta(kappa) = 1/(2 pi kappa) exactly '
          f'(free boson, no vortices, no log corrections)')
    print(f'{"κ":>8} {"η exact":>8} ' +
          ' '.join(f'{f"χ_S(L={L})":>16}' for L in args.Ls) +
          '  η_eff per volume pair')
    for kappa in args.kappas:
        t0 = time.perf_counter()
        vals = {L: chi_at(L, kappa) for L in args.Ls}
        eta_exact = 1.0 / (2 * np.pi * kappa)
        cells = ' '.join(f'{str(Uncertain(*vals[L])):>16}' for L in args.Ls)
        etas = []
        for La, Lb in zip(args.Ls[:-1], args.Ls[1:]):
            (ma, ea), (mb, eb) = vals[La], vals[Lb]
            _, eta = effective_exponent(La, ma, Lb, mb)
            err = effective_exponent_error(La, ma, ea, Lb, mb, eb)
            etas.append(f'{eta:.3f}({err:.3f})')
        print(f'{kappa:>8.4f} {eta_exact:>8.3f} {cells}  ' + ' '.join(etas)
              + f'   [{time.perf_counter() - t0:.0f} s]', flush=True)


if __name__ == '__main__':
    main()
