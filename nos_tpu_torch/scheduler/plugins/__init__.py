"""Port of `nos_tpu/scheduler/plugins/__init__.py:1` (:1-1). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package.

Scheduler plugins: resource fit, TPU topology scoring, capacity scheduling."""
