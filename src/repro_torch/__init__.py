"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference and stays as it is; this
package mirrors its module names (``configs``, ``compat``,
``models.{layers,attention,slotstate,transformer,model}``,
``kernels.{flash_decode,ops}``, ``serve.{engine,sampler,quant}``,
``launch.serve``) and imports nothing of it, nor JAX.  Every TPU kernel
on a ported path is a hand-written CUDA kernel under ``csrc/`` with its
plain PyTorch version beside it; kernels are built at first use, never
at import.
"""
