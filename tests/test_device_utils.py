"""The compile-cache helper and the backend helpers of
``supervillain_tpu.utils.device``.  Cache placement is decided when JAX
starts, so each case runs in a fresh process."""

import os
import pathlib
import subprocess
import sys

import jax

from supervillain_tpu.utils import device

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = '''
import jax
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
from supervillain_tpu.utils.device import enable_compile_cache
print(enable_compile_cache())
{compile}
'''


def _probe(cwd, env_dir=None, compile=''):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=str(ROOT))
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    if env_dir is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = str(env_dir)
    out = subprocess.run([sys.executable, '-c', PROBE.format(compile=compile)],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[0]


def test_cache_goes_where_the_environment_says(tmp_path):
    cache = tmp_path / 'cache'
    used = _probe(tmp_path, cache,
                  compile='jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7))')
    assert used == str(cache)
    assert any(cache.iterdir()), 'no cache entry written to the named directory'


def test_cache_defaults_to_the_checkout(tmp_path):
    assert _probe(tmp_path) == str(ROOT / '.jax_cache')


def test_cache_path_does_not_depend_on_the_working_directory(tmp_path):
    elsewhere = tmp_path / 'a' / 'b'
    elsewhere.mkdir(parents=True)
    assert _probe(elsewhere) == _probe(ROOT) == str(device.CHECKOUT / '.jax_cache')


def test_sized_follows_the_backend():
    assert jax.devices()[0].platform == 'cpu'
    assert device.sized(256, 8) == 8


def test_card_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv('PATH', '')
    assert device.card() == 'nvidia-smi unavailable'
