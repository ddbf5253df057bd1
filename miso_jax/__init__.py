"""miso_jax: batched Bayesian engine for alternative-splicing quantification.

A from-scratch rebuild of the capabilities of MISO (Mixture of Isoforms;
reference: yarden/MISO) in JAX, for one or several GPUs:

- Host-side "event compiler" turns annotations (GFF3) + aligned reads
  (SAM/BAM) into small dense per-event tensors: read-compatibility classes
  x isoforms.  Reads are collapsed to equivalence classes on the host, so
  the device never sees ragged per-read data.
- Device-side sampler runs thousands of (event x chain) MCMC chains in
  parallel: jax.vmap + lax.scan, or on a GPU one fused Pallas kernel
  (Triton route) that runs the whole chain.
- Event-data parallelism over a device mesh (jax.sharding.Mesh);
  posterior summaries reduce on-device.

Reference parity targets are cited throughout as file:line into the
upstream repository (e.g. ``pysplicing/src/miso.c:638``).
"""

__version__ = "0.1.0"

from miso_jax.core.gene import Gene, Isoform, Exon  # noqa: F401
