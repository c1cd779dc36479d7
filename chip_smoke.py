#!/usr/bin/env python
"""Drive the sampler's main path once on a GPU and check what comes out.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded-fleet comparison only

Phases (one informational line each, with wall time, compile time, rate and
the card's name and power limit):

* device      — fail unless JAX's first device is a GPU;
* villain     — ``sample_fleet`` of the Villain Hammer at L=256, 512 chains,
  W=1 and W=2 (the bkt-scan deployment): every chain keeps dn ≡ 0 mod W and
  the inline worm observables are finite;
* worldline   — the Worldline Hammer at L=256, κ=0.5, W=2, 512 chains: δm = 0.
  κ=0.5 lies in the W=2 critical phase, where worms span the lattice; each
  worm is capped at 16·L moves (truncated worms roll back exactly) so the
  phase takes seconds, and the truncated fraction is printed;
* d4          — the d4-topology fleet, 8⁴ with 512 chains;
* reference   — ActionDensity, WindingSquared and Spin_Spin through the
  observables registry on the card in float32, against the float64 NumPy
  reference on the host;
* statistics  — 5×5, κ=0.5: Villain and Worldline ⟨ActionDensity⟩ agree
  within 4σ;
* four        — (``--four`` only) the same fleet sharded over four cards and
  on one card, compared bitwise; and the 2×2 (chains × space) mesh Hammer
  step against the unsharded step.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: Densities: float32 sums of O(10⁵) terms against float64.
DENSITY_RTOL = 1e-5
#: Correlators, relative to the correlator's maximum: cuFFT sums in another
#: order than NumPy's FFT.
CORRELATOR_RTOL = 1e-5
#: Villain vs Worldline ⟨ActionDensity⟩ agreement, in combined standard errors.
STATISTICS_SIGMA = 4.0


class CompileClock:
    """Seconds JAX has spent tracing, lowering and compiling since creation."""

    EVENTS = {'/jax/core/compile/jaxpr_trace_duration',
              '/jax/core/compile/jaxpr_to_mlir_module_duration',
              '/jax/core/compile/backend_compile_duration'}

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, seconds, **kwargs):
        if event in self.EVENTS:
            self.seconds += seconds


class Phase:
    """Wall time of a phase with its compile time counted apart."""

    def __init__(self, name, card, clock):
        self.name, self.card, self.clock = name, card, clock

    def __enter__(self):
        self.start, self.compile0 = time.perf_counter(), self.clock.seconds
        return self

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.start
        self.compile = self.clock.seconds - self.compile0
        return False

    def report(self, work=None, unit='', **fields):
        run = max(self.wall - self.compile, 1e-9)
        text = ' '.join(f'{k}={v}' for k, v in fields.items())
        rate = f' rate={work / run:.6g} {unit}' if work is not None else ''
        print(f'phase={self.name} {text} wall_s={self.wall:.3f} '
              f'compile_s={self.compile:.3f}{rate} | {self.card}', flush=True)


# -- checks ---------------------------------------------------------------

def check(ok, message):
    """Fail the run (never an ``assert``: those vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def constraint_violations(S, fields):
    """Number of chains whose fields break the action's constraint:
    dn ≡ 0 mod W (dn = 0 at W=∞) for Villain, δm = 0 for Worldline."""
    import jax
    import supervillain_tpu as sv
    from supervillain_tpu.ops import calculus as calc
    L = S.Lattice
    if isinstance(S, sv.Villain):
        defect = np.asarray(jax.jit(jax.vmap(lambda n: calc.d(L, 1, n)))(fields['n']))
        if S.W < float('inf'):
            defect = np.mod(defect, S.W)
    else:
        defect = np.asarray(jax.jit(jax.vmap(lambda m: calc.delta(L, 1, m)))(fields['m']))
    return int((defect.reshape(len(defect), -1) != 0).any(axis=1).sum())


def check_fleet(S, fleet):
    bad = constraint_violations(S, fleet.final)
    check(bad == 0, f'{S}: {bad} chains break the constraint')
    for name, column in fleet.columns.items():
        check(np.isfinite(column).all(), f'{S}: inline {name} is not finite')


# -- phases ---------------------------------------------------------------

def hammer_fleet(S, chains, records, thin, seed, mesh=None, max_worm_moves=None):
    """``sample_fleet`` of the formulation's fleet Hammer; returns the fleet and
    its work in chain-site Hammer steps."""
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv, worldline as gw
    from supervillain_tpu.parallel import sample_fleet
    family = gv if isinstance(S, sv.Villain) else gw
    G = family.Hammer(S, fleet=True, max_worm_moves=max_worm_moves)
    fleet = sample_fleet(S, G, chains=chains, steps=records, thin=thin, seed=seed,
                         mesh=mesh, keep_fields=False)
    return fleet, chains * S.Lattice.sites * records * thin


def villain_phase(L=256, chains=512, records=3, thin=2, W=1, kappa=0.5, seed=1):
    import supervillain_tpu as sv
    S = sv.Villain(sv.Lattice2D(L), kappa, W=W)
    fleet, work = hammer_fleet(S, chains, records, thin, seed)
    check_fleet(S, fleet)
    return S, fleet, work


def worldline_phase(L=256, chains=512, records=3, thin=1, W=2, kappa=0.5, seed=2):
    import supervillain_tpu as sv
    S = sv.Worldline(sv.Lattice2D(L), kappa, W=W)
    fleet, work = hammer_fleet(S, chains, records, thin, seed, max_worm_moves=16 * L)
    check_fleet(S, fleet)
    return S, fleet, work


def truncated_fraction(fleet):
    """Fraction of the fleet's worms that hit their move cap and rolled back."""
    s = fleet.stats['ClassicWorm']
    return 1.0 - float(s['acceptance']) / max(float(s['sweeps']), 1.0)


def d4_phase(N=8, chains=512, records=3, thin=2, kappa=0.4, W=1, seed=3):
    """The d4-topology deployment: Site+Link+Exact+Cohomology Hammer in D=4."""
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv
    from supervillain_tpu.parallel import sample_fleet
    S = sv.Villain(sv.Lattice(4, N), kappa, W=W)
    fleet = sample_fleet(S, gv.Hammer(S), chains=chains, steps=records, thin=thin,
                         seed=seed, keep_fields=False)
    check_fleet(S, fleet)
    return S, fleet, chains * S.Lattice.sites * records * thin


def reference_phase(samples, per_fleet=8):
    """Evaluate ActionDensity, WindingSquared and Spin_Spin through the
    observables registry on the default device, and compare each with the
    float64 NumPy reference.  ``samples`` is a list of (Villain action, fields)
    with chain-batched fields.  Returns the worst relative errors."""
    import supervillain_tpu as sv
    from supervillain_tpu.observables.reference_implementation import villain_numpy
    worst = {'density': 0.0, 'correlator': 0.0}
    for S, fields in samples:
        phi = np.asarray(fields['phi'][:per_fleet])
        n = np.asarray(fields['n'][:per_fleet])
        e = sv.Ensemble(S).from_configurations(sv.Configurations({'phi': phi, 'n': n}))
        device = {name: np.asarray(getattr(e, name))
                  for name in ('ActionDensity', 'WindingSquared', 'Spin_Spin')}
        for i in range(len(phi)):
            ref = villain_numpy(S.kappa, phi[i], n[i])
            for name in ('ActionDensity', 'WindingSquared'):
                err = abs(device[name][i] - ref[name]) / max(abs(ref[name]), 1e-30)
                worst['density'] = max(worst['density'], float(err))
            corr = ref['Spin_Spin']
            err = np.abs(device['Spin_Spin'][i] - corr).max() / np.abs(corr).max()
            worst['correlator'] = max(worst['correlator'], float(err))
    check(worst['density'] <= DENSITY_RTOL, worst)
    check(worst['correlator'] <= CORRELATOR_RTOL, worst)
    return worst


def statistics_phase(N=5, kappa=0.5, W=1, chains=256, records=200, cut=50, seed=4):
    """Villain and Worldline fleets on the same lattice: ⟨ActionDensity⟩ must
    agree (the two formulations are exactly dual).  Chains are independent, so
    the error is the spread of per-chain means.  Returns (pull, villain, worldline)."""
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv, worldline as gw
    from supervillain_tpu.parallel import sample_fleet
    estimates = []
    for model, family in ((sv.Villain, gv), (sv.Worldline, gw)):
        S = model(sv.Lattice2D(N), kappa, W=W)
        fleet = sample_fleet(S, family.Hammer(S, fleet=True), chains=chains,
                             steps=records, seed=seed)
        check_fleet(S, fleet)
        density = np.asarray(fleet.pooled_ensemble(cut=cut).ActionDensity)
        per_chain = density.reshape(records - cut, chains).mean(axis=0)
        estimates.append((per_chain.mean(), per_chain.std(ddof=1) / np.sqrt(chains)))
    (mv, ev), (mw, ew) = estimates
    pull = (mv - mw) / np.hypot(ev, ew)
    check(abs(pull) < STATISTICS_SIGMA, f'Villain {mv}({ev}) vs Worldline {mw}({ew})')
    return pull, estimates[0], estimates[1]


def compare_fields(a, b):
    """{name: number of differing entries} over the keys both dicts hold."""
    return {k: int((np.asarray(a[k]) != np.asarray(b[k])).sum()) for k in a if k in b}


def four_phase(devices, L=256, chains=512, records=2, thin=2, W=2, space_N=64,
               seed=5):
    """One fleet sharded over four devices against the same fleet on one.
    Per-chain keys fold from chain indices, so every field and inline column
    must match bitwise.  Then the (chains × space) 2×2 mesh Hammer step against
    the unsharded step, also bitwise.  Returns the differing-entry counts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import supervillain_tpu as sv
    from supervillain_tpu.generators import villain as gv
    from supervillain_tpu.parallel import chain_mesh, chain_space_mesh
    devices = list(devices)[:4]
    check(len(devices) == 4, f'--four needs four devices, found {len(devices)}')
    S = sv.Villain(sv.Lattice2D(L), 0.5, W=W)
    four, _ = hammer_fleet(S, chains, records, thin, seed, mesh=chain_mesh(devices))
    one, _ = hammer_fleet(S, chains, records, thin, seed, mesh=chain_mesh(devices[:1]))
    check_fleet(S, four)
    diffs = {f'fleet.final.{k}': v for k, v in compare_fields(four.final, one.final).items()}
    diffs.update({f'fleet.columns.{k}': v
                  for k, v in compare_fields(four.columns, one.columns).items()})

    SS = sv.Villain(sv.Lattice2D(space_N), 0.5, W=W)
    G = gv.Hammer(SS, fleet=True)
    mesh = chain_space_mesh(2, 2, devices)
    batch = 4

    def run(shard):
        cfgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), SS.initial())
        stats = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
                             G.init_stats())
        if shard:
            cfgs = {k: jax.device_put(v, NamedSharding(mesh, P('chains', None, None, 'space')))
                    for k, v in cfgs.items()}
            stats = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh, P('chains'))), stats)
        else:
            cfgs, stats = jax.device_put((cfgs, stats), devices[0])

        @jax.jit
        def step(key, cfgs, stats):
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(batch))
            return jax.vmap(lambda k, c, s: G.step(k, c, s)[:2])(keys, cfgs, stats)

        for i in range(3):
            cfgs, stats = step(jax.random.key(i), cfgs, stats)
        return {k: np.asarray(v) for k, v in cfgs.items()}

    sharded = run(True)
    check(constraint_violations(SS, sharded) == 0, f"{SS}: space-sharded step breaks the constraint")
    diffs.update({f'space_mesh.{k}': v for k, v in compare_fields(sharded, run(False)).items()})
    return diffs


# -- main -----------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-GPU sharded-fleet comparison')
    args = ap.parse_args(argv)

    import jax
    from supervillain_tpu.utils.device import enable_compile_cache, require_gpu, card
    enable_compile_cache()
    require_gpu('chip_smoke.py')
    devices = jax.devices()
    name, clock = card(), CompileClock()

    with Phase('device', name, clock) as p:
        pass
    p.report(platform=devices[0].platform, kind=repr(devices[0].device_kind),
             count=len(devices))

    if args.four:
        with Phase('four', name, clock) as p:
            diffs = four_phase(devices)
        p.report(devices=4, differing=json.dumps(diffs, separators=(',', ':')))
        bad = {k: v for k, v in diffs.items() if v}
        check(not bad, 'sharded and single-device runs differ (tolerance: bitwise, '
                       f'since per-chain keys do not depend on the layout): {bad}')
    else:
        samples = []
        for W in (1, 2):
            with Phase('villain', name, clock) as p:
                S, fleet, work = villain_phase(W=W)
            p.report(work, 'site-steps/s', L=S.Lattice.N, W=W, chains=fleet.chains,
                     hammer_steps=work // (fleet.chains * S.Lattice.sites))
            samples.append((S, fleet.final))
        with Phase('worldline', name, clock) as p:
            S, fleet, work = worldline_phase()
        p.report(work, 'site-steps/s', L=S.Lattice.N, W=S.W, chains=fleet.chains,
             worms_truncated=f'{truncated_fraction(fleet):.4f}')
        with Phase('d4', name, clock) as p:
            S, fleet, work = d4_phase()
        p.report(work, 'site-steps/s', N=S.Lattice.N, D=4, chains=fleet.chains)
        samples.append((S, fleet.final))
        with Phase('reference', name, clock) as p:
            worst = reference_phase(samples)
        p.report(density_worst=f"{worst['density']:.3g}", density_limit=DENSITY_RTOL,
                 correlator_worst=f"{worst['correlator']:.3g}",
                 correlator_limit=CORRELATOR_RTOL)
        with Phase('statistics', name, clock) as p:
            pull, (mv, ev), (mw, ew) = statistics_phase()
        p.report(villain=f'{mv:.6f}({ev:.6f})', worldline=f'{mw:.6f}({ew:.6f})',
                 pull=f'{pull:+.2f}', limit=STATISTICS_SIGMA)

    print(json.dumps({'ok': True, 'device': {'platform': devices[0].platform,
                                             'kind': devices[0].device_kind,
                                             'count': len(devices)}}))


if __name__ == '__main__':
    main()
