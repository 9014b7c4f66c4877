"""carla_garage_tpu_torch — the PyTorch + CUDA port of carla_garage_tpu.

Module paths and function names mirror the JAX package, so each function
has an obvious counterpart there. The port imports torch, numpy and scipy
only; the JAX package is its reference in the tests and nowhere else.
Entry points that create tensors default to ``device="cuda"`` and run on
the CPU only when the caller asks for it (see ``device.resolve_device``).
"""
