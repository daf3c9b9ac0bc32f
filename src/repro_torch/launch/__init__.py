"""Launchers: the serving and training entry points, the decode and
fleet profilers, the production meshes and sharding rules (``mesh``), the
dry run on a fake process group (``dryrun``) and the roofline analysis
(H100 constants)."""
from .mesh import (  # noqa: F401
    ShardingRules,
    activation_spec,
    batch_axes_for,
    batch_shardings,
    cache_shardings,
    make_cpu_mesh,
    make_production_mesh,
    param_shardings,
)
