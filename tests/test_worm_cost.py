"""The worm-cost harness at tiny sizes on the CPU: both formulations, the
worm cap, and the one-JSON-line-per-point command line."""

import json

import pytest

from supervillain_tpu.benchmark import worm_cost


@pytest.mark.parametrize('formulation', ['villain', 'worldline'])
def test_worm_share_reports_both_stacks(formulation):
    res = worm_cost.worm_share(4, 4, steps=2, W=2, reps=1, formulation=formulation,
                               max_moves=50)
    assert res['formulation'] == formulation and res['max_moves'] == 50
    assert res['t_full_s'] > 0 and res['t_local_s'] > 0
    assert res['local_site_steps_per_s'] == pytest.approx(4 * 16 * 2 / res['t_local_s'])
    assert 0 < res['worm_length_max'] <= 50
    assert 0.0 <= res['worm_share'] < 1.0


def test_worm_share_rejects_an_unknown_formulation():
    with pytest.raises(ValueError, match='formulation'):
        worm_cost.worm_share(4, 4, formulation='xy')


def test_main_prints_one_line_per_point(capsys):
    worm_cost.main(['--L', '4', '--chains', '4', '--steps', '2', '--reps', '1',
                    '--W', '1', '2', '--formulation', 'worldline', '--max-moves', '40'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('# device')
    points = [json.loads(line) for line in lines[1:]]
    assert [(p['formulation'], p['W']) for p in points] == [('worldline', 1), ('worldline', 2)]
