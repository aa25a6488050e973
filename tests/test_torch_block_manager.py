"""The port's BlockManager (nos_tpu_torch/runtime/block_manager.py, a
near-verbatim copy of nos_tpu/runtime/block_manager.py) driven in LOCKSTEP
with the reference through the randomized 3000-op schedule of
tests/test_block_manager.py::test_randomized_interleaving_preserves_invariants,
with the same seed: admits (with injected admission faults), prefill
progress, finish/register/release, preempt-shaped spills, revives, COW
tails, resets and device-lost recovery cycles. Every call returns the same
value (or raises the same error) on both managers, the pools' full state
agrees after every op, and the reference's own invariant check holds on
the port's manager throughout."""

import random

import pytest

from nos_tpu.runtime.block_manager import BlockManager as RefBlockManager
from nos_tpu.runtime.faults import FaultInjector, FaultSpec, PoisonRequestError
from nos_tpu.runtime.spill import SpillTier as RefSpillTier
from nos_tpu_torch.runtime.block_manager import BlockManager, chain_key
from nos_tpu_torch.runtime.spill import SpillTier

from test_block_manager import BS, check_invariants, n_blocks_for


def snapshot(mgr, tier):
    return (
        mgr.counts(),
        list(mgr._free_blocks),
        list(mgr._cached_free),
        list(mgr._refcount),
        [list(r) for r in mgr._slot_blocks],
        dict(mgr._prefix_index),
        dict(mgr._block_key),
        list(mgr._spilled),
        mgr.radix_nodes(),
        (mgr.lookups, mgr.hit_blocks, mgr.evictions, mgr.output_blocks),
        (tier.host_bytes, tier.spills, tier.drops, tier.revives),
    )


class Lockstep:
    """One manager + tier + injector per side; every call goes to both."""

    def __init__(self, radix, kv_dtype, first_fault):
        salt = (kv_dtype + ":") if kv_dtype else ""
        self.sides = []
        for mgr_cls, tier_cls in ((RefBlockManager, RefSpillTier), (BlockManager, SpillTier)):
            injector = FaultInjector([FaultSpec("block_admit", first_fault, "poison")])
            mgr = mgr_cls(1 + 10, BS, 4, fault_injector=injector, radix=radix,
                          key_salt=salt)
            tier = tier_cls(capacity_bytes=6 * 16)
            if kv_dtype:
                mgr.attach_spill(tier, lambda b: ((kv_dtype, f"kv-of-{b}"), 10 + b % 7))
            else:
                mgr.attach_spill(tier, lambda b: (f"kv-of-{b}", 16))
            self.sides.append((mgr, tier, injector))

    @property
    def port(self):
        return self.sides[1][0]

    def call(self, fn):
        """fn(mgr, tier, injector) on both sides: equal results, equal
        exceptions, equal state."""
        out = []
        for mgr, tier, injector in self.sides:
            try:
                out.append(("ok", fn(mgr, tier, injector)))
            except PoisonRequestError:
                out.append(("poison", None))
        assert out[0] == out[1], f"reference {out[0]} != port {out[1]}"
        ref, port = (snapshot(m, t) for m, t, _ in self.sides)
        assert ref == port
        return out[0]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("radix", [False, True])
def test_randomized_schedule_in_lockstep_with_reference(radix, kv_dtype):
    rng = random.Random(20260804)
    pair = Lockstep(radix, kv_dtype, rng.randint(1, 40))
    live = {}
    finished = []
    counts = {"injected": 0, "recoveries": 0, "revived": 0, "cows": 0}

    def rearm():
        delay = rng.randint(1, 40)
        for _, _, injector in pair.sides:
            injector.add(FaultSpec(
                "block_admit", injector.visits("block_admit") + delay, "poison"))

    def consume(idx):
        def revives(mgr, tier, _):
            got = 0
            for _, _, key in mgr.claim_revives(idx):
                if tier.take(key) is None:
                    break
                got += 1
            return got

        counts["revived"] += pair.call(revives)[1]
        perform = rng.random() < 0.85

        def cow(mgr, tier, _):
            staged = mgr.claim_cow(idx)
            if staged is not None and perform:
                if staged[2] is None:
                    tier.get(staged[3])
                mgr.cow_done(idx)
            return staged

        if pair.call(cow)[1] is not None:
            counts["cows"] += 1

    def make_prompt():
        if radix and finished and rng.random() < 0.35:
            base, out = rng.choice(finished)
            if out and rng.random() < 0.6:
                grown = base + out + [rng.randint(0, 2) for _ in range(rng.randint(1, 6))]
                return grown[:20]
            div = list(base)
            if div:
                div[rng.randrange(len(div))] = rng.randint(3, 5)
            return div + [rng.randint(0, 2) for _ in range(rng.randint(0, 4))]
        return [rng.randint(0, 2) for _ in range(rng.randint(1, 20))]

    def admit(idx, prompt, n, use_cache):
        status, got = pair.call(lambda m, t, i: m.admit(idx, prompt, n, use_cache=use_cache))
        if status == "poison":
            counts["injected"] += 1
            rearm()
            return None
        return got

    def finish(idx, spill):
        prompt, _, max_new = live.pop(idx)
        out = [rng.randint(0, 2) for _ in range(rng.randint(0, max_new))]
        register = radix and rng.random() < 0.8

        def run(mgr, tier, _):
            if register:
                mgr.register_output(idx, prompt + out)
            mgr.release(idx, spill=spill)

        pair.call(run)
        if register and out:
            finished.append((prompt, out))
            del finished[:-12]

    for _ in range(3000):
        op = rng.random()
        idle = [i for i in range(4) if i not in live]
        if op < 0.4 and idle:
            idx = rng.choice(idle)
            prompt = make_prompt()
            max_new = rng.randint(1, 6)
            n = n_blocks_for(len(prompt), max_new)
            if prompt and n <= 10:
                got = admit(idx, prompt, n, rng.random() < 0.8)
                if got is not None:
                    consume(idx)
                    live[idx] = (prompt, got[1] * BS, max_new)
        elif op < 0.7 and live:
            idx = rng.choice(list(live))
            prompt, cursor, max_new = live[idx]
            cursor = min(len(prompt), cursor + rng.randint(1, 8))
            pair.call(lambda m, t, i: m.note_progress(idx, cursor))
            live[idx] = (prompt, cursor, max_new)
        elif op < 0.95 and live:
            finish(rng.choice(list(live)), spill=rng.random() < 0.35)
        elif op >= 0.985:
            counts["recoveries"] += 1
            survivors = list(live.items())

            def reset_all(mgr, tier, _):
                for idx in survivors:
                    mgr.release(idx[0])
                mgr.reset()

            pair.call(reset_all)
            live.clear()
            for idx, (prompt, _, max_new) in survivors:
                n = n_blocks_for(len(prompt), rng.randint(1, 6))
                if n > 10:
                    continue
                got = admit(idx, prompt, n, True)
                if got is not None:
                    assert got[1] == 0
                    consume(idx)
                    live[idx] = (prompt, 0, max_new)
        elif op >= 0.98:
            pair.call(lambda m, t, i: m.reset())
            live.clear()
        check_invariants(pair.port)
        assert pair.port.conserved()
    assert counts["injected"] > 0 and counts["recoveries"] > 0 and counts["revived"] > 0
    if radix:
        assert counts["cows"] > 0
    for idx in list(live):
        pair.call(lambda m, t, i: m.release(idx))
    check_invariants(pair.port)
    assert pair.port.counts()["in_use"] == 0


def test_chain_key_is_the_reference_key_scheme():
    from nos_tpu.runtime.block_manager import chain_key as ref_chain_key

    for parent in ("", "abc"):
        for tokens in ((1, 2, 3), (0,) * 32):
            assert chain_key(parent, tokens) == ref_chain_key(parent, tokens)
