"""Model-layout entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

The reference wrappers transpose the model's (b, S, hkv, d) cache into
the kernel's (b, hkv, S, d) blocks.  The CUDA kernel reads the model
layout through its strides, so :func:`flash_decode` is the kernel
wrapper itself: q (b, 1, hq, d), cache (b, S, hkv, d), slot_pos (b, S),
pos (b,) -> (b, 1, hq, d).  The launch count is
``flash_decode.launches``.
"""

from repro_torch.kernels.flash_decode import flash_decode  # noqa: F401
