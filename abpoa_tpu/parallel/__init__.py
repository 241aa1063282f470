"""Scale-out layers: instance batching per chip, mesh sharding across chips.

The reference is single-threaded (SURVEY.md §2: "Parallelism strategies");
everything here is new design, not a port. The unit of work is a
batch of independent POA instances (amplicon/UMI windows), bucketed by
(node-capacity, band-width) and run as one vmapped device program per round;
data parallelism shards the batch axis over a jax.sharding.Mesh.
"""
from .batch import BatchPOA  # noqa: F401
