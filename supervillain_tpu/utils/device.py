"""Where the program runs: the persistent compile cache, the accelerator check,
the card's name and power limit, and backend-dependent default sizes."""

from __future__ import annotations

import os
import pathlib
import subprocess

#: The checkout (or install prefix) holding the ``supervillain_tpu`` package.
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache():
    """Keep JAX's persistent compilation cache between processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here.  Otherwise the cache lives at ``<checkout>/.jax_cache``,
    a fixed path (the cache only hits when every process names the same one).
    Returns the directory in use."""
    import jax
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', str(CHECKOUT / '.jax_cache'))
    return jax.config.jax_compilation_cache_dir


def require_gpu(program):
    """Exit with status 1 unless JAX's first device is a GPU: a measurement
    that finds no card fails rather than reporting a CPU number."""
    import jax
    platform = jax.devices()[0].platform
    if platform != 'gpu':
        raise SystemExit(f'{program}: needs a GPU, JAX found {platform!r} '
                         f'({jax.devices()[0].device_kind})')


def card():
    """The card's name and power limit as ``nvidia-smi`` reports them, one line
    per card; ``'nvidia-smi unavailable'`` where it cannot be run."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'
    return '; '.join(line.strip() for line in out.splitlines() if line.strip())


def sized(gpu, cpu):
    """A default size: ``gpu`` where the program runs on a GPU, ``cpu`` (a
    smoke-test size) elsewhere."""
    import jax
    return gpu if jax.devices()[0].platform == 'gpu' else cpu
