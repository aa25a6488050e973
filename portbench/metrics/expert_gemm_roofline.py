"""Kernels, the expert layer (`ops/moe.py`, `csrc/moe_experts.cu`): the
least time one H100 needs for the expert layers' work in the traced span,
over the profiler's summed device time of the expert kernels, in percent.
The work is the change in the engine's expert tallies
(`DecodeServer.expert_counts()`, read before and after the window by
`drivers/serve-experts.py`): per kind of program (prefill, decode), rows
routed and (layer, call, expert) hits, bounded by `arch/<arch>.py`'s
`expert_flops(rows)` and `expert_bytes(hit, rows)` (`work.bound_s`).
Summed within a kind before the max, the bound can only be lower than a
call-by-call one, so the share cannot read above its truth."""

from portbench.work import bound_s

UNIT = "%"
KERNELS = ("moe_route_kernel", "moe_sort_kernel", "moe_gemm_kernel", "moe_combine_kernel")


def read(run):
    t = run.trace_data
    before, after = run.counters
    if t is None or "decode_rows" not in after or not hasattr(run.shape, "expert_flops"):
        return None
    spent = t.kernel_seconds(*KERNELS)
    need = 0.0
    for kind in ("prefill", "decode"):
        rows = after[f"{kind}_rows"] - before[f"{kind}_rows"]
        hit = after[f"{kind}_expert_hits"] - before[f"{kind}_expert_hits"]
        if rows > 0:
            need += bound_s(run.shape.expert_flops(rows), run.shape.expert_bytes(hit, rows))
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / spent
