"""Serve a cell's traffic as `drivers/serve.py` does, for an architecture
with expert layers: the same set-up, warm requests, window and drain
(serve's own functions), with the engine's expert tallies
(`DecodeServer.expert_counts()`: rows routed and experts hit, for the
prefill and the decode programs) added to the counters read before and
after the window, which `metrics/expert_gemm_roofline.py` reads. It
differs from `serve.run` in that alone."""

from __future__ import annotations

import gc
import time
from typing import Dict

from portbench.drivers import serve


def counters(engine) -> Dict:
    """serve's counters and the expert tallies (one blocking read)."""
    return {**serve.counters(engine), **engine.expert_counts()}


def run(ctx) -> None:
    """Fill `ctx` (a `harness.Run`) with the window's results."""
    import torch

    from nos_tpu_torch.runtime.decode_server import DecodeServer
    from nos_tpu_torch.tracing import EngineTracing

    cell, config, arch = ctx.cell, ctx.config, ctx.arch
    device = torch.device(serve.run_device(ctx))
    marks = [("imports", time.monotonic())]
    if device.type == "cuda":
        from nos_tpu_torch.ops import _build

        # The serving path's kernel libraries, built by nvcc on a checkout's
        # first run only; timed apart from the rest of the set-up.
        for lib in arch.KERNEL_LIBRARIES:
            _build.build(lib)
    marks.append(("kernels", time.monotonic()))
    params = arch.make_params(config, ctx.seed, device)
    serve.sync(device)
    marks.append(("weights", time.monotonic()))
    cfg = arch.engine_config(config)
    streams = ctx.make_traffic()
    engine = DecodeServer(params, cfg, device=device, temperature=0.0, seed=0,
                          tracing=EngineTracing() if ctx.trace else None,
                          **serve.engine_kwargs(cell))
    engine.start()
    marks.append(("engine", time.monotonic()))
    ctx.warm_requests = serve.warm(engine, cell, serve.max_prompt(streams), ctx.shape.vocab,
                                   ctx.seed)
    serve.sync(device)
    marks.append(("warm", time.monotonic()))
    t = ctx.t_process
    for name, at in marks:
        ctx.setup_parts[name] = at - t
        t = at
    before = counters(engine)
    trace = None

    def on_open():
        nonlocal trace
        ctx.open_window()
        if ctx.trace:
            from portbench.trace import Trace
            trace = Trace().collect()

    served = serve.drive(engine, streams, ctx.seconds, float(cell.get("max_drain_s", 60)),
                         on_open)
    if trace is not None:
        trace.stop()
    after = counters(engine)
    engine.stop()
    serve.sync(device)
    if device.type == "cuda":
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    ctx.served, ctx.trace_data = served, trace
    ctx.counters = (before, after)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.params = params
