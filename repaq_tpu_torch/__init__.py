"""PyTorch/CUDA port of repaq_tpu's ``--engine device`` codec.

The JAX package ``repaq_tpu`` is the reference and stays as it is. This
package stands alone: it carries its own copy of the host layers (format,
io, pipeline, the vectorized and kernels_np codecs, the CLI functions, the
native host library's source in ``native/``) and ports the device code:
stream coders as torch tensor code on an explicit device
(``ops.device_streams``) and the TPU's Pallas kernels as hand-written CUDA
kernels for Hopper (``csrc/``, bound in ``ops.kernels``). Nothing here
imports ``jax`` or ``repaq_tpu``.
"""
