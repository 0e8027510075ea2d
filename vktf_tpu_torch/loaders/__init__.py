"""glTF 2.0, KTX2 and Basis loaders (numpy host code)."""

from vktf_tpu_torch.loaders.gltf import Asset, GltfError, load_gltf
from vktf_tpu_torch.loaders.ktx import KtxError, load_ktx

__all__ = ["Asset", "GltfError", "KtxError", "load_gltf", "load_ktx"]
