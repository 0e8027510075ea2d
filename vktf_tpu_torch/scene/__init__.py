from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta, flatten_assets

__all__ = ["RenderScene", "SceneMeta", "flatten_assets", "Scene"]


def __getattr__(name):
    if name == "Scene":
        from vktf_tpu_torch.scene.scene import Scene

        return Scene
    raise AttributeError(f"module 'vktf_tpu_torch.scene' has no attribute {name!r}")
