"""Multi-host initialization helpers.

With several processes (one per host, or one per GPU), call :func:`initialize`
once per process before building meshes; ``jax.devices()`` then spans all hosts and every mesh/sharding in
:mod:`supervillain_tpu.parallel` works unchanged (chains shard across the global
device list; statistics reductions become cross-host psums)."""

from __future__ import annotations

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """``jax.distributed.initialize`` with pass-through arguments.  Where no
    cluster manager describes the job, pass all three explicitly
    (``coordinator_address='localhost:<port>'`` on a single host)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count(), len(jax.devices())


def is_multi_host():
    return jax.process_count() > 1
