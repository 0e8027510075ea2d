from vktf_tpu_torch.utils.data_view import as_view, size_bytes
from vktf_tpu_torch.utils.delta_time import DeltaTime
from vktf_tpu_torch.utils.timing import FrameTimer

__all__ = ["as_view", "size_bytes", "DeltaTime", "FrameTimer"]
