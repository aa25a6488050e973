"""portbench: the benchmark of the PyTorch and CUDA port, `nos_tpu_torch`.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once and prints one JSON line. Everything a cell is made of
is found by name: `cells/<cell>.json` (engine settings, the configuration
and the traffic mix it names, the correctness limit), `configs/<config>.json`
(a model's published sizes and its `arch`), `arch/<arch>.py` (the weights,
the engine's model config, the kernel libraries and the work count of one
token), `references/<arch>.py` (the plain float32 forward),
`traffic/<mix>.json` (a mix's parameters, read by the generator
`gen/<kind>.py`), `drivers/<driver>.py` (what runs the
cell), `endtoend/<metric>.py` and `metrics/<metric>.py` (one reader per
end-to-end and per-layer metric). Nothing here imports JAX or the JAX
package; nothing under `references/` imports anything of the port either.
"""
