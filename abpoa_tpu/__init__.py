"""abpoa_tpu — partial-order alignment (POA) consensus framework in JAX.

A from-scratch re-design of abPOA (Xinglab/abPOA v1.4.1) for an accelerator
(an NVIDIA GPU; the CPU runs the same path for tests):
  * host layer: graph store, consensus, MSA/GFA emission, seeding — exact
    behavioral parity with the reference (byte-identical outputs),
  * compute layer: the adaptive-banded seq-to-DAG DP as a Pallas (Triton)
    GPU kernel with a plain JAX/XLA reference, batched over many POA
    instances per device, sharded over device meshes.
"""
from .params import Params
from .api import ABPOA

__version__ = "0.1.0"
