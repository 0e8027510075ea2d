"""Procedural meshes and benchmark scenes."""

from vktf_tpu_torch.models.scenes import build_preset, sponza_like_asset

__all__ = ["build_preset", "sponza_like_asset"]
