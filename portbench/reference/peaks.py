"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W). Every share
of a peak is stated against these, with the card's power limit beside
it, since a card set below 700 W runs slower under load."""

FLOPS = {
    "fp8": 1979e12,
    "bf16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,          # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(n_bytes: float, flops: float, precision: str = "fp32") -> float:
  """The least time the card could take: the larger of the bytes over the
  memory bandwidth and the operations over the peak of `precision`."""
  return max(n_bytes / HBM_BYTES_PER_S, flops / FLOPS[precision])
