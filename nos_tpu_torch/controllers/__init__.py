"""Port of `nos_tpu/controllers/__init__.py:1` (:1-1). Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

Reconcilers wiring the engine to the cluster (internal/controllers analog)."""
