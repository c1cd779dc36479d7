"""chip_smoke.py's phases at tiny sizes on the CPU backend, and the refusal of
chip_smoke.py and bench.py to report anything where JAX finds no GPU."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax

import supervillain_tpu as sv

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

WS = [1, 2, float('inf')]


@pytest.mark.parametrize('W', WS)
def test_villain_phase(W):
    S, fleet, work = chip_smoke.villain_phase(L=6, chains=8, records=2, thin=1, W=W)
    assert S.W == W and fleet.chains == 8
    assert work == 8 * 36 * 2
    assert set(fleet.columns) == {'Vortex_Vortex', 'Worm_Length'}


@pytest.mark.parametrize('W', WS)
def test_worldline_phase(W):
    S, fleet, work = chip_smoke.worldline_phase(L=6, chains=8, records=2, thin=1, W=W)
    assert isinstance(S, sv.Worldline) and S.W == W
    assert set(fleet.columns) == {'Spin_Spin', 'Worm_Length'}
    assert 0.0 <= chip_smoke.truncated_fraction(fleet) <= 1.0


def test_d4_phase():
    S, fleet, work = chip_smoke.d4_phase(N=3, chains=8, records=2, thin=1)
    assert S.Lattice.D == 4 and fleet.final['n'].shape == (8, 4, 3, 3, 3, 3)
    assert fleet.columns == {} and fleet.chains == 8   # no worm in D=4: no inline columns


def test_reference_phase_matches_numpy():
    samples = []
    for L in (sv.Lattice2D(6), sv.Lattice(4, 3)):
        S = sv.Villain(L, 0.4, W=1)
        fleet = sv.parallel.sample_fleet(S, sv.generators.villain.Hammer(S, fleet=True),
                                         chains=8, steps=3, seed=7, keep_fields=False)
        samples.append((S, fleet.final))
    worst = chip_smoke.reference_phase(samples, per_fleet=4)
    # float64 on the CPU against the float64 reference: far inside the limits.
    assert worst['density'] < 1e-7 and worst['correlator'] < 1e-7


def test_reference_phase_rejects_a_wrong_measurement(monkeypatch):
    """A perturbed reference must fail the phase, not pass it silently."""
    from supervillain_tpu.observables import reference_implementation as ref
    S = sv.Villain(sv.Lattice2D(6), 0.4, W=1)
    fleet = sv.parallel.sample_fleet(
        S, sv.generators.villain.NeighborhoodUpdate(S, interval_phi=0.5),
        chains=8, steps=4, seed=8)
    exact = ref.villain_numpy

    def off(kappa, phi, n):
        out = exact(kappa, phi, n)
        return out | {'ActionDensity': out['ActionDensity'] * (1 + 1e-4)}
    monkeypatch.setattr(ref, 'villain_numpy', off)
    with pytest.raises(RuntimeError, match='density'):
        chip_smoke.reference_phase([(S, fleet.final)], per_fleet=2)


def test_statistics_phase():
    pull, villain, worldline = chip_smoke.statistics_phase(chains=16, records=60, cut=20)
    assert abs(pull) < chip_smoke.STATISTICS_SIGMA
    assert villain[1] > 0 and worldline[1] > 0


def test_constraint_violations_counts_broken_chains():
    S = sv.Villain(sv.Lattice2D(4), 0.5, W=2)
    n = np.zeros((3, 2, 4, 4), dtype=int)
    n[1, 0, 1, 1] = 1          # a lone unit link: dn = ±1 on two plaquettes
    n[2, 0, 2, 2] = 2          # a multiple of W: allowed
    assert chip_smoke.constraint_violations(S, {'n': n}) == 1
    SW = sv.Worldline(sv.Lattice2D(4), 0.5, W=2)
    m = np.zeros((2, 2, 4, 4), dtype=int)
    m[0, 1, 0, 0] = 1
    assert chip_smoke.constraint_violations(SW, {'m': m}) == 1


def test_compare_fields_counts_differences():
    a = {'x': np.zeros((2, 3)), 'y': np.ones(4), 'only_a': np.zeros(1)}
    b = {'x': np.zeros((2, 3)), 'y': np.array([1.0, 2.0, 1.0, 3.0])}
    assert chip_smoke.compare_fields(a, b) == {'x': 0, 'y': 2}


def test_four_phase_on_virtual_devices():
    """The --four comparison on 4 of the 8 virtual CPU devices: the sharded
    fleet and the space-sharded Hammer step match their single-device runs
    bitwise."""
    diffs = chip_smoke.four_phase(jax.devices()[4:], L=8, chains=8, records=2,
                                  thin=1, space_N=8)
    assert diffs and all(v == 0 for v in diffs.values()), diffs
    assert {'fleet.final.n', 'fleet.columns.Vortex_Vortex', 'space_mesh.n'} <= set(diffs)


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_script_refuses_cpu_backend(script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    out = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert 'needs a GPU' in out.stderr
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout


def test_chip_smoke_last_line_format(monkeypatch, capsys):
    """With the device check passed and the phases stubbed, the last line is
    exactly the result record."""
    monkeypatch.setattr(sv.utils.device, 'require_gpu', lambda program: None)
    for phase in ('villain_phase', 'worldline_phase', 'd4_phase'):
        monkeypatch.setattr(chip_smoke, phase, lambda **kw: (
            sv.Villain(sv.Lattice2D(4), 0.5, W=1),
            type('F', (), {'chains': 1, 'final': {},
                           'stats': {'ClassicWorm': {'acceptance': 1, 'sweeps': 1}}})(),
            16))
    monkeypatch.setattr(chip_smoke, 'reference_phase',
                        lambda samples: {'density': 0.0, 'correlator': 0.0})
    monkeypatch.setattr(chip_smoke, 'statistics_phase', lambda: (0.0, (1, 0), (1, 0)))
    chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l.split()[0] for l in lines[:-1]] == [
        'phase=device', 'phase=villain', 'phase=villain', 'phase=worldline',
        'phase=d4', 'phase=reference', 'phase=statistics']
    d = jax.devices()[0]
    assert json.loads(lines[-1]) == {'ok': True, 'device': {
        'platform': d.platform, 'kind': d.device_kind, 'count': len(jax.devices())}}
