"""Port of `nos_tpu/partitioning/__init__.py:1` (:1-7). Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

Dynamic partitioning engine: mode-agnostic planner/actuator over snapshots.

Analog of the reference's internal/partitioning (SURVEY.md §2.2): the planner
searches per-node geometry changes that make the most pending pods schedulable,
validating every candidate geometry by *simulating scheduling*; the actuator
diffs desired vs current state and drives mode-specific partitioners.
"""
