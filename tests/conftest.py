"""Test configuration: run the suite on CPU with 8 virtual devices and 64-bit floats.

Multi-device sharding is validated on a virtual CPU mesh (``chip_smoke.py
--four`` runs the same comparison on four GPUs); numerical oracle comparisons
need f64.  The platform is forced through jax.config so that a GPU, where one
is present, is left alone.
"""

import os

_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (_flags + ' --xla_force_host_platform_device_count=8').strip()

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

# Persistent compilation cache: the suite is dominated by hundreds of small XLA
# compiles, so repeat runs (every xdist worker after the first populates it)
# are much faster.  JAX_COMPILATION_CACHE_DIR places it; otherwise it is the
# checkout's untracked .jax_cache.
from supervillain_tpu.utils.device import enable_compile_cache

enable_compile_cache()
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)

import numpy as np
import pytest


@pytest.fixture(scope='session')
def rng():
    return np.random.default_rng(20260817)
