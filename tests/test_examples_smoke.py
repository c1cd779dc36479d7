"""Every example script runs end-to-end at toy sizes on the CPU backend —
the reference runs its doc examples as tests (sphinx doctests / test drivers);
these are the equivalent executable-documentation battery.  Each case runs the
script's real `__main__` path via runpy with shrunken arguments, so argument
parsing, default sizes, H5 output, and the analysis tails are all exercised.
"""

import pathlib
import runpy
import sys

import numpy as np
import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / 'examples'


def run_example(name, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    # Matplotlib-free environment safety: examples gate figures behind flags.
    return runpy.run_path(str(EXAMPLES / name), run_name='__main__')


def test_end_to_end_villain(monkeypatch):
    run_example('end-to-end.py',
                ['--N', '4', '--configurations', '200'], monkeypatch)


def test_end_to_end_worldline(monkeypatch):
    run_example('end-to-end.py',
                ['--action', 'worldline', '--N', '4', '--W', '2',
                 '--configurations', '200'], monkeypatch)


def test_end_to_end_winf(monkeypatch):
    run_example('end-to-end.py',
                ['--N', '4', '--W', 'inf', '--configurations', '150'],
                monkeypatch)


def test_action_comparison(monkeypatch):
    run_example('action-comparison.py',
                ['--N', '4', '--configurations', '300'], monkeypatch)


def test_villain_algorithm_comparison(monkeypatch):
    run_example('villain-algorithm-comparison.py',
                ['--N', '4', '--configurations', '200'], monkeypatch)


def test_worldline_algorithm_comparison(monkeypatch):
    run_example('worldline-algorithm-comparison.py',
                ['--N', '4', '--configurations', '200'], monkeypatch)


def test_no_vortices(tmp_path, monkeypatch):
    run_example('no-vortices.py',
                ['--N', '5', '--configurations', '300',
                 '--h5', str(tmp_path / 'nv.h5')], monkeypatch)


def test_why_measure_inline(monkeypatch):
    run_example('why-measure-inline.py',
                ['--N', '4', '--configurations', '200'], monkeypatch)


def test_fleet_scan(tmp_path, monkeypatch):
    run_example('fleet-scan.py',
                ['--N', '4', '--chains', '8', '--steps', '10', '--cut', '2',
                 '--kappas', '0.5', '--h5', str(tmp_path / 'fleet.h5')],
                monkeypatch)


def test_bkt_scan_cpu_fallback(monkeypatch, capsys):
    """The κ-scan at W=2 through sample_fleet: neighborhood sweeps plus one
    capped worm per record, with the inline vortex correlator and the
    truncation budget."""
    run_example('bkt-scan.py',
                ['--L', '8', '--chains', '4', '--therm-sweeps', '20',
                 '--records', '3', '--thin', '4', '--kappas', '0.6',
                 '--W', '2'], monkeypatch)
    assert 'χ_V/L^(D-2Δ_V)' in capsys.readouterr().out


def test_d4_topology(monkeypatch):
    res = run_example('d4-topology.py',
                      ['--N', '3', '--chains', '4', '--steps', '6', '--thin',
                       '1', '--cut', '2', '--kappas', '0.4'], monkeypatch)


def test_d4_topology_winf(monkeypatch):
    """At W=∞ the topological charge must vanish identically (dn = 0) — the
    script asserts it internally."""
    run_example('d4-topology.py',
                ['--N', '3', '--chains', '4', '--steps', '6', '--thin', '1',
                 '--cut', '2', '--kappas', '0.4', '--W', 'inf'], monkeypatch)


def test_winf_line_cpu_exits_cleanly(monkeypatch, capsys):
    """The W=∞ line at its CPU default sizes: a real two-volume run."""
    run_example('winf-line.py', [], monkeypatch)
    assert 'η_eff per volume pair' in capsys.readouterr().out


def test_pod_fleet_cpu_exits_cleanly(tmp_path, monkeypatch):
    """The pod fleet at its CPU default sizes, with HDF5 output."""
    import h5py
    run_example('pod-fleet.py', ['--chains', '4', '--h5', str(tmp_path / 'pod.h5')],
                monkeypatch)
    with h5py.File(tmp_path / 'pod.h5') as f:
        assert f['fleet/columns/ActionDensity'].shape[1] == 4


def test_w3_analysis(monkeypatch, capsys):
    """The W=3 dual-channel analysis reproduces its quoted crossings from the
    committed artifacts (runs wherever results/ is present)."""
    if not (EXAMPLES.parent / 'results' / 'bkt-scan-W3-L64.h5').exists():
        pytest.skip('scan artifacts not present')
    run_example('plot/w3-analysis.py', [], monkeypatch)
    out = capsys.readouterr().out
    assert 'crossing(64,128)' in out and 'crossing(128,256)' in out
    assert 'Delta_vortex' in out


def test_physics_figure(monkeypatch, tmp_path):
    """The summary figure renders from the committed artifacts."""
    if not (EXAMPLES.parent / 'results' / 'bkt-scan-W2-L64.h5').exists():
        pytest.skip('scan artifacts not present')
    run_example('plot/physics-figure.py', [], monkeypatch)
    assert (EXAMPLES.parent / 'results' / 'physics-summary.png').stat().st_size > 10000
