from .mesh import chain_mesh, chain_space_mesh
from .fleet import Fleet, sample_fleet, check_truncation_budget, TRUNCATION_BUDGET
from . import distributed
