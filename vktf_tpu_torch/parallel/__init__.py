"""The multi-device frame path over torch.distributed (``tiles.py``) and
the helpers that start its processes (``launch.py``)."""

from vktf_tpu_torch.parallel.tiles import (  # noqa: F401
    RenderMesh,
    ShardedFrameProgram,
    make_render_mesh,
    merge_keys,
    pack_keys,
    unpack_keys,
)
