"""supervillain_tpu — accelerator lattice Monte Carlo for the Villain model.

A JAX/XLA framework with the capability surface of
``evanberkowitz/supervillain``: the Villain (φ, n) and dual Worldline (m, v)
formulations of the compact boson on D-dimensional periodic lattices with the Z_W
vortex-constraint generalization, sampled by checkerboard-vectorized Metropolis sweeps
and worm algorithms, measured by a registry of observables and derived quantities, and
analyzed with autocorrelation / blocking / weighted-bootstrap machinery with HDF5
persistence.  Chains vmap/shard across device meshes.
"""

from . import meta
from .ops import Lattice, Lattice2D, Form
from . import lattice  # reference-compatible alias (supervillain.lattice)
from .ops import d, delta, face_sum, coface_sum, laplacian, star, wedge, push, pull

from . import utils
from . import models
from .models import Villain, Worldline
from . import generators
from . import generator  # reference-compatible alias
from .configurations import Configurations
from .ensemble import Ensemble
from . import observables
from . import observable  # reference-compatible alias
from .observables import observables as observables_registry
from . import analysis
from .analysis import Blocking, Bootstrap, Uncertain
from . import io
from . import h5  # reference-compatible alias (supervillain.h5)
from . import performance  # reference-compatible alias (supervillain.performance)
from . import cli
from . import parallel

from .observables import derived_registry as derivedQuantities  # noqa: N812 — reference-compatible name

#: reference-compatible name: dict of all primary observables
observables = observables_registry
