"""Port of `nos_tpu/gpu/__init__.py:1` (:1-6). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

NVIDIA GPU parity modes: MIG (hard partitioning) and MPS (memory slicing).

Kept for parity with the reference (SURVEY.md §7 step 8, BASELINE.json
configs[1-4]); the TPU mode in nos_tpu_torch.tpu/partitioning is first-class. The
engine contracts are shared — these modules only supply the device models.
"""
