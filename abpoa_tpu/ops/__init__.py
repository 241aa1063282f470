"""Device compute ops (JAX/XLA, Pallas/Triton) for the POA DP hot path."""
from .dp_xla import DPConfig, banded_poa_dp, banded_poa_dp_batch  # noqa: F401
