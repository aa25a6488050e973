"""The port's DecodeServer (nos_tpu_torch/runtime/decode_server.py) against
the JAX DecodeServer on identical traffic, on the CPU.

Both engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`) and must return IDENTICAL greedy tokens.
Both run their defaults (the radix cache, the spill tier and surgical
recovery on; tests/test_torch_faults.py drives the recovery). Both engines burst with their shared
default, burst_windows=4. Where all traffic is queued before start(), the
two engines' prefill, macro and burst dispatch counts must agree too. Also pinned here: the package imports neither jax nor nos_tpu,
and the engine refuses to drift to the CPU when no CUDA device exists."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params, init_gpt
from nos_tpu_torch.models.decode import init_paged_cache

from conftest import serving_test_config, serving_test_params

DISPATCH_COUNTERS = ("prefill_dispatches", "macro_dispatches", "burst_dispatches",
                     "burst_windows_run", "steps_run", "prefill_tokens")


@pytest.fixture(scope="module")
def model():
    jcfg = serving_test_config()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    jparams = serving_test_params()
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def prompts(seed, lengths, vocab=97):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lengths]


def serve(server, traffic):
    """Queue every request, then start: dispatch counts are deterministic."""
    futs = [server.submit(p, n) for p, n in traffic]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


def run_both(model, traffic, **kw):
    jcfg, jparams, tcfg, tparams = model
    jsrv = JaxServer(jparams, jcfg, **kw)
    tsrv = DecodeServer(tparams, tcfg, device="cpu", **kw)
    jout = serve(jsrv, traffic)
    tout = serve(tsrv, traffic)
    assert tout == jout
    assert ({c: getattr(tsrv, c) for c in DISPATCH_COUNTERS}
            == {c: getattr(jsrv, c) for c in DISPATCH_COUNTERS})
    return jsrv, tsrv, tout


def test_single_request(model):
    (p,) = prompts(0, [5])
    _, tsrv, (out,) = run_both(model, [(p, 8)], n_slots=2, max_len=64)
    assert len(out) == 8
    # K=1: the prefill tick's window, then bursts of 4 and 2 windows.
    assert tsrv.steps_run == tsrv.macro_dispatches + tsrv.burst_dispatches == 3
    assert tsrv.macro_dispatches + tsrv.burst_windows_run == 7


def test_concurrent_streams_are_isolated(model):
    traffic = [(p, 10) for p in prompts(1, [3, 9, 14])]
    _, _, outs = run_both(model, traffic, n_slots=3, max_len=64)
    # Isolation: each stream alone gives the same tokens.
    _, _, tcfg, tparams = model
    for (p, n), want in zip(traffic, outs):
        solo = DecodeServer(tparams, tcfg, n_slots=3, max_len=64, device="cpu")
        assert serve(solo, [(p, n)]) == [want]


def test_eos_frees_the_slot_early(model):
    jcfg, jparams, tcfg, tparams = model
    p1, p2 = prompts(2, [6, 7])
    probe = serve(DecodeServer(tparams, tcfg, n_slots=1, max_len=64, device="cpu"),
                  [(p1, 12)])[0]
    eos = probe[3]
    jsrv = JaxServer(jparams, jcfg, n_slots=1, max_len=64, eos_id=eos)
    tsrv = DecodeServer(tparams, tcfg, n_slots=1, max_len=64, eos_id=eos, device="cpu")
    traffic = [(p1, 12), (p2, 5)]
    jout, tout = serve(jsrv, traffic), serve(tsrv, traffic)
    assert tout == jout
    assert tout[0] == probe[: probe.index(eos) + 1]  # truncated at eos


def test_prompt_longer_than_the_largest_bucket(model):
    (p,) = prompts(3, [50])
    _, tsrv, (out,) = run_both(model, [(p, 6)], n_slots=1, max_len=96,
                               prompt_buckets=(8, 16, 32))
    assert len(out) == 6 and tsrv.prefill_dispatches == 2  # chunks of 32 + 18


def test_two_long_prompts_batch_through_the_prefill_window(model):
    traffic = [(p, 5) for p in prompts(4, [70, 75])]
    _, tsrv, _ = run_both(model, traffic, n_slots=2, max_len=96,
                          prompt_buckets=(8, 16, 32), prefill_budget_tokens=64)
    # Both mid chunks (0-32, 32-64) of the two prompts as one window each.
    assert tsrv.prefill_window_dispatches == 2


def test_steps_per_dispatch_4_matches_1(model):
    traffic = [(p, 11) for p in prompts(5, [4, 12])]
    _, k4, out4 = run_both(model, traffic, n_slots=2, max_len=64, steps_per_dispatch=4)
    _, k1, out1 = run_both(model, traffic, n_slots=2, max_len=64, steps_per_dispatch=1)
    assert out4 == out1
    windows = [k.macro_dispatches + k.burst_windows_run for k in (k4, k1)]
    assert windows[0] < windows[1]


def test_pool_backpressure_is_fifo(model):
    traffic = [(p, 10) for p in prompts(6, [12, 20, 6])]
    # Each request needs 3-4 blocks of 8; 7 allocatable blocks host two.
    _, tsrv, outs = run_both(model, traffic, n_slots=3, max_len=64, block_size=8,
                             total_blocks=8)
    assert [len(o) for o in outs] == [10, 10, 10]
    assert tsrv._block_mgr.counts()["in_use"] == 0


def test_shared_prefix_hit(model):
    jcfg, jparams, tcfg, tparams = model
    prefix, a, b = prompts(7, [24, 5, 6])
    results = []
    for srv in (JaxServer(jparams, jcfg, n_slots=2, max_len=64, block_size=8),
                DecodeServer(tparams, tcfg, n_slots=2, max_len=64, block_size=8,
                             device="cpu")):
        srv.start()
        try:
            first = srv.generate(prefix + a, max_new=6, timeout=300)
            second = srv.generate(prefix + b, max_new=6, timeout=300)
        finally:
            srv.stop()
        results.append((first, second, srv.prefix_hit_tokens))
    assert results[1] == results[0]
    assert results[1][2] == 24  # three full prefix blocks served from the cache
    cold = DecodeServer(tparams, tcfg, n_slots=2, max_len=64, block_size=8, device="cpu",
                        prefix_cache=False)
    assert serve(cold, [(prefix + b, 6)]) == [results[1][1]]


def test_deferred_features_raise(model):
    _, _, tcfg, tparams = model
    for kw in (dict(quota=object()), dict(kv_store=object()),
               dict(metrics=object()), dict(cost_ledger=object())):
        with pytest.raises(NotImplementedError):
            DecodeServer(tparams, tcfg, device="cpu", **kw)
    # Surgical recovery is the default, as in the reference, and the
    # injector and the checkpoint hook are taken.
    assert DecodeServer(tparams, tcfg, device="cpu").surgical_recovery
    DecodeServer(tparams, tcfg, device="cpu", fault_injector=object(), checkpoint_hook=print)
    # radix_cache is inert without the prefix cache, as in the reference.
    assert not DecodeServer(tparams, tcfg, device="cpu", prefix_cache=False).radix_cache


def test_no_device_and_no_cuda_raises(model, monkeypatch):
    _, _, tcfg, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeServer(tparams, tcfg)


@pytest.mark.parametrize("entry", ["init_gpt", "from_numpy_params", "init_paged_cache"])
def test_entry_points_without_device_raise_without_cuda(model, monkeypatch, entry):
    """The other entry points default to CUDA and never drift to the CPU
    either (DecodeServer: the test above)."""
    _, jparams, tcfg, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_gpt": lambda: init_gpt(tcfg),
        "from_numpy_params": lambda: from_numpy_params(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg),
        "init_paged_cache": lambda: init_paged_cache(tcfg, 4, 8),
    }
    with pytest.raises(RuntimeError, match=f"{entry} runs on CUDA"):
        calls[entry]()


def test_package_imports_neither_jax_nor_nos_tpu():
    """Every module of the package, and chip_smoke.py, in a fresh process."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib, nos_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(nos_tpu_torch.__path__, 'nos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'nos_tpu_torch.runtime.faults' in sys.modules\n"
        "assert 'nos_tpu_torch.runtime.checkpoint' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'nos_tpu' or m.startswith('nos_tpu.')]\n"
        "print(len(list(pkgutil.walk_packages(nos_tpu_torch.__path__))), bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr
