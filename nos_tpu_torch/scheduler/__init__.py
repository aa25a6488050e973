"""Port of `nos_tpu/scheduler/__init__.py:1` (:1-1). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

Quota-aware, topology-aware scheduler (pkg/scheduler analog)."""
