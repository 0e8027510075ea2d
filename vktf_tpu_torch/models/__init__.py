"""Procedural meshes and benchmark scenes."""

from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh
from vktf_tpu_torch.models.scenes import build_preset, sponza_like_asset

__all__ = ["box_mesh", "plane_mesh", "uv_sphere_mesh", "build_preset", "sponza_like_asset"]
