"""Model-layout entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

The reference wrappers transpose the model's (b, S, hkv, ...) caches
into the kernels' (b, hkv, S, ...) blocks and pad ``m`` to the GEMM's
tile.  The CUDA kernels read the model layout through its strides and
mask ragged edges themselves, so each entry point here is its kernel's
wrapper:

* :func:`flash_attention`: whole-sequence attention, q (b, sq, hq, d),
  k / v (b, skv, hkv, d) -> (b, sq, hq, d), causal or not, with an
  optional window, softcap, scale and ``q_offset``;
* :func:`flash_decode`: q (b, 1, hq, d), dense cache (b, S, hkv, d),
  slot_pos (b, S), pos (b,) -> (b, 1, hq, d);
* :func:`flash_decode_quant`: the same over a quantized cache dict
  (``init_kv_cache(kv_format=fmt)``);
* :func:`qmatmul` / :func:`qmatmul_packed`: x (m, k) @ dequant(weights
  (n, k) quantized along k, scales (n, k/32)).T, with
  :func:`quantize_for_qmatmul` / :func:`pack_for_qmatmul` to make the
  weights;
* :func:`ssd_scan`: the Mamba-2 SSD chunked scan, x (bt, s, h, p)
  pre-discretized, dt_a (bt, s, h), b / c (bt, s, n), optional
  initial_state (bt, h, p, n) -> (y (bt, s, h, p), final_state), s
  padded to the chunk with an identity tail;
* the probe kernels, with the reference's signatures: :func:`dep_chain`
  (x (ilp, 8, 128) fp32 through ``chain_len`` serial ``x * a + b``),
  :func:`chase` (final index of a walk over :func:`make_chase_buffer`)
  and :func:`mma_probe` (x (ilp, m, k) @ y (k, n)).

Launch counts are ``<wrapper>.launches``.
"""

from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_decode import flash_decode  # noqa: F401
from repro_torch.kernels.flash_decode_quant import (  # noqa: F401
    flash_decode_quant)
from repro_torch.kernels.probe_chase import (  # noqa: F401
    chase, make_chase_buffer)
from repro_torch.kernels.probe_dep_chain import dep_chain  # noqa: F401
from repro_torch.kernels.probe_mma import mma_probe  # noqa: F401
from repro_torch.kernels.qmatmul import (  # noqa: F401
    pack_for_qmatmul, qmatmul, qmatmul_packed, quantize_for_qmatmul)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
