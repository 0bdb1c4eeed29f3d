"""Multi-device training: the process mesh, its placement rules and the
collectives that carry a gradient (counterpart of
transfuser_tpu/parallel/)."""
from .sharding import Mesh, MeshSpec, make_mesh

__all__ = ["Mesh", "MeshSpec", "make_mesh"]
