"""Port parity of multi-tap anisotropy in the deferred shade, taps 2, 4 and
8 (tests/test_torch_texture.py's first item, with its resolved-pixel
bound): ``shade_resolve(texels="fused", taps=N)`` against
``shade_addr_chunk`` + ``shade_final_chunk(fused_pool=True, aniso_taps=N,
interpret=True)`` on every 32nd pixel of the small courtyard."""

import jax
import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()


@pytest.mark.parametrize("taps", [2, 4, 8])
def test_multi_tap_matches_jax_kernel(taps):
    from vktf_tpu.ops.shade_kernel import shade_addr_chunk, shade_final_chunk
    from vktf_tpu_torch.ops.shade_kernel import shade_resolve

    full = tp.sponza_stages()
    st = dict(full, **{k: full[k][::32] for k in ("tri", "frac", "sx", "sy")})
    ma = tp.port_config().max_anisotropy
    background = np.zeros(4, np.float32)

    @jax.jit
    def reference(tri, sx, sy, table, pool, cam, lights, frac):
        trow, r0, r1 = shade_addr_chunk(tri, sx, sy, table, ma, fused_pool=True, aniso_taps=taps)
        return shade_final_chunk(trow, r0, r1, tri, sx, sy, pool, cam, lights,
                                 max_anisotropy=ma, interpret=True, frac=frac,
                                 background=background, fused_pool=True, aniso_taps=taps)

    want = np.asarray(reference(*tp.jax_shade_args(st), st["frac"]))
    args = tp.stage_tensors(st, "tri", "sx", "sy", "frac", "table", "pool", "cam", "lights", "bg")
    got = shade_resolve(*args, ma, "fused", taps).numpy()
    tp.assert_packed_close(got, want)
    # the taps act: the frame differs from the one-tap frame
    one = shade_resolve(*args, ma).numpy()
    assert (tp.u8_step(got, one) > 1).mean() > 0.01
