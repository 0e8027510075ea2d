from vktf_tpu_torch.runtime.cache import (
    enable_persistent_cache,
    frame_program,
    program_cache_info,
    warmup,
)

__all__ = ["enable_persistent_cache", "frame_program", "program_cache_info", "warmup"]
