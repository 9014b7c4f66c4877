"""A frozen copy of the parts of ``carla_garage_tpu_torch`` that the
benchmark's cells run: the simulator, the scenario engine and criteria,
the sensor and PlanT agents, the sensors, TransFuser++ and PlanT, and both
training steps.

It is the plain reference that decides ``correct``: the same modules as
the port had when the benchmark was written, with every import pointed
here, and ``ops/raycast.py`` and ``ops/bev_fill.py`` cut to their plain
PyTorch versions (no CUDA kernel, no build). The port was held against the
JAX package on the CPU at that state. It imports nothing of the port, and
later changes to the port do not reach it, so a change that alters what a
cell computes shows as a gap here. Nothing in it may be edited to follow
the port.
"""
