"""Parallelism layer: meshes of ranks and logical sharding rules (port
of skypilot_tpu/parallel)."""
from skypilot_tpu_torch.parallel.mesh import (MESH_AXES, Mesh, MeshSpec,
                                              build_mesh, current_mesh,
                                              single_device_mesh, use_mesh)
from skypilot_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules

__all__ = [
    'MESH_AXES', 'Mesh', 'MeshSpec', 'build_mesh', 'current_mesh',
    'single_device_mesh', 'use_mesh', 'DEFAULT_RULES', 'Rules',
]
