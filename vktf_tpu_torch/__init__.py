"""vktf_tpu_torch — the PyTorch + CUDA port of the vktf_tpu renderer."""
