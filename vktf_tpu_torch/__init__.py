"""vktf_tpu_torch — the PyTorch + CUDA port of the vktf_tpu renderer.

The same public names as ``vktf_tpu``; ``Engine`` and ``Window`` load
lazily, so ``import vktf_tpu_torch`` stays light.
"""

from vktf_tpu_torch.config import MAX_RENDER_FRAMES, RenderConfig, select_msaa_samples
from vktf_tpu_torch.log import Log, Severity, default_log
from vktf_tpu_torch.mathx import Camera, ViewFrustumParams

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "MAX_RENDER_FRAMES",
    "select_msaa_samples",
    "Log",
    "Severity",
    "default_log",
    "Camera",
    "ViewFrustumParams",
    "Engine",
    "Window",
]


def __getattr__(name):  # lazy imports to keep `import vktf_tpu_torch` light
    if name == "Engine":
        from vktf_tpu_torch.engine import Engine

        return Engine
    if name == "Window":
        from vktf_tpu_torch.window import Window

        return Window
    raise AttributeError(f"module 'vktf_tpu_torch' has no attribute {name!r}")
