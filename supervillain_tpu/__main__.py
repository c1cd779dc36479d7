"""``python -m supervillain_tpu`` prints a banner with version and capabilities."""

from . import meta

BANNER = rf'''
                                     _ _ _       _          _
 ___ _   _ _ __   ___ _ ____   _(_) | | __ _(_)_ __    | |_ _ __  _   _
/ __| | | | '_ \ / _ \ '__\ \ / / | | |/ _` | | '_ \   | __| '_ \| | | |
\__ \ |_| | |_) |  __/ |   \ V /| | | | (_| | | | | |  | |_| |_) | |_| |
|___/\__,_| .__/ \___|_|    \_/ |_|_|_|\__,_|_|_| |_|___\__| .__/ \__,_|
          |_|                                      |_____| |_|

supervillain-tpu {meta.version} ({meta.nickname})
Accelerator lattice Monte Carlo for the Villain model of the compact boson.
Villain (φ, n) and Worldline (m, v) dual formulations; Z_W vortex constraint;
JAX/XLA compute; chains vmapped and sharded over device meshes.
'''

if __name__ == '__main__':
    # Route argv through the metadata parser so `python -m supervillain_tpu
    # --version/--copyright/--license` print-and-exit exactly like the
    # reference's module entry point (reference supervillain/__main__.py:1-13
    # + cli/metadata.py:12-50).
    from . import cli
    cli.ArgumentParser(description=__doc__).parse_args()
    print(BANNER)
