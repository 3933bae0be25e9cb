"""Production mesh entry point (counterpart of ``repro/launch/mesh.py``).

A re-export of ``repro_torch.dist.mesh``: ``make_production_mesh`` is a
function, so importing this module touches no device and no process
group.  The dry-run does not build one (it would need 256 or 512 ranks);
it traces one rank's step under ``repro_torch.launch.dryrun.RecordingMesh``
of the same shape.
"""
from repro_torch.dist.mesh import (make_host_mesh, make_production_mesh,
                                   mesh_axis_sizes)

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_axis_sizes"]
