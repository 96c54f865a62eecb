"""The port's paged-KV host bookkeeping (serving/kvcache.py,
serving/schedule.py) against the JAX package's classes: the same decisions
over a seeded sequence of allocator and prefix-tree operations, the same
bucket ladders and scheduler decisions, and the port's torch pools."""

import numpy as np
import pytest
import torch

from grove_tpu.serving import kvcache as jkv
from grove_tpu.serving import schedule as jsched
from grove_tpu_torch.serving import kvcache as tkv
from grove_tpu_torch.serving import schedule as tsched

# Fields of the allocator payload (``adopted_total`` counts the blocks the
# disaggregated handoff adopts).
_PAYLOAD_KEYS = ("capacity", "used", "free", "block_size", "cached",
                 "utilization", "allocs_total", "frees_total", "refs_total",
                 "oom_events", "high_water", "reclaimed_total",
                 "cached_high_water", "adopted_total")


def _side(mod, num_blocks, block_size):
    alloc = mod.BlockAllocator(num_blocks, block_size)
    return alloc, mod.PrefixTree(alloc)


def _state(alloc, tree):
    p = alloc.payload()
    return ({k: p[k] for k in _PAYLOAD_KEYS}, tree.payload(),
            sorted(alloc._free), sorted(alloc._refs.items()),
            list(alloc._cached))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_and_prefix_tree_decide_as_jax(seed):
    """alloc / ref / free / match / insert, with LRU eviction under
    pressure, applied to both packages in lockstep: every result and the
    full allocator and tree state agree after every operation. A vocab of
    three tokens makes prefix hits and mid-block partial hits common."""
    rng = np.random.default_rng(seed)
    bs = 4
    sides = {"jax": _side(jkv, 24, bs), "port": _side(tkv, 24, bs)}
    held: list[tuple[list[int], np.ndarray]] = []  # blocks + their tokens
    kinds = ("alloc", "free", "ref", "insert", "match")
    for step in range(300):
        op = kinds[int(rng.integers(0, len(kinds)))]
        results = {}
        if op == "alloc":
            n = int(rng.integers(0, 6))
            for name, (alloc, _) in sides.items():
                results[name] = alloc.alloc(n)
            if results["jax"] is not None:
                held.append((list(results["jax"]),
                             rng.integers(0, 3, size=n * bs)))
        elif op == "free" and held:
            blocks, _ = held.pop(int(rng.integers(0, len(held))))
            for name, (alloc, _) in sides.items():
                results[name] = alloc.free(list(blocks))
        elif op == "ref" and held:
            blocks, toks = held[int(rng.integers(0, len(held)))]
            if blocks:
                j = int(rng.integers(0, len(blocks)))
                for name, (alloc, _) in sides.items():
                    results[name] = alloc.ref(blocks[j])
                held.append(([blocks[j]], toks[j * bs:(j + 1) * bs]))
        elif op == "insert" and held:
            blocks, toks = held[int(rng.integers(0, len(held)))]
            for name, (_, tree) in sides.items():
                results[name] = tree.insert(toks, list(blocks))
        elif op == "match":
            toks = rng.integers(0, 3, size=int(rng.integers(1, 14)))
            for name, (_, tree) in sides.items():
                results[name] = tree.match(toks)
            full, _, partial = results["jax"]
            refs = list(full) + ([partial[0]] if partial else [])
            if refs:
                held.append((refs, np.zeros(len(refs) * bs, np.int64)))
        assert results.get("jax") == results.get("port"), (step, op)
        assert _state(*sides["jax"]) == _state(*sides["port"]), (step, op)
        sides["port"][0].check()
    assert sides["port"][1].payload()["hits"] > 0
    assert sides["port"][0].reclaimed_total > 0 or seed != 0


def test_alloc_is_all_or_nothing_and_free_is_strict():
    alloc = tkv.BlockAllocator(5, 4)
    got = alloc.alloc(3)
    assert got == [1, 2, 3]
    assert alloc.alloc(2) is None and alloc.oom_events == 1
    with pytest.raises(ValueError):
        alloc.free([tkv.NULL_BLOCK])
    alloc.free(got)
    with pytest.raises(ValueError, match="double free"):
        alloc.free([got[0]])
    alloc.check()


def test_seq_blocks_and_pad_tables_match_jax():
    for mod in (jkv, tkv):
        alloc = mod.BlockAllocator(8, 4)
        seq = mod.SeqBlocks(alloc)
        assert seq.ensure(9) and seq.capacity == 12
        assert not seq.ensure(40)  # all or nothing
        assert seq.capacity == 12
        seq.release()
        seq.release()  # idempotent
        assert alloc.used_blocks == 0
    tables = [[3, 1], [2], []]
    np.testing.assert_array_equal(tkv.pad_tables(tables, 4),
                                  jkv.pad_tables(tables, 4))


def test_paged_kv_pools_are_torch_tensors():
    kv = tkv.PagedKV.create(2, 5, 4, 3, 8, torch.float32, device="cpu")
    assert kv.k.shape == (2, 5, 4, 3, 8) and kv.v.dtype == torch.float32
    assert kv.num_blocks == 5 and kv.block_size == 4
    assert kv.tokens_capacity == 16 and not kv.quantized
    assert kv.pool_bytes == 2 * 2 * 5 * 4 * 3 * 8 * 4
    assert kv.scales == {}
    q8 = tkv.PagedKV.create(2, 5, 4, 3, 8, quant="int8", device="cpu")
    assert q8.quantized and q8.k.dtype == q8.v.dtype == torch.int8
    assert q8.k_scale.shape == q8.v_scale.shape == (2, 5, 4, 3)
    assert q8.k_scale.dtype == torch.float32 and not q8.k_scale.any()
    assert q8.pool_bytes == 2 * 2 * 5 * 4 * 3 * (8 + 4)
    assert set(q8.scales) == {"k_scale", "v_scale"}
    with pytest.raises(ValueError):
        tkv.PagedKV.create(2, 5, 4, 3, 8, quant="fp4")


@pytest.mark.parametrize("maximum,start", [(1, 1), (32, 1), (128, 1),
                                           (48, 4), (6, 1)])
def test_bucket_ladders_match_jax(maximum, start):
    ladder = tsched.bucket_ladder(maximum, start)
    assert ladder == jsched.bucket_ladder(maximum, start)
    for n in range(1, maximum + 1):
        assert tsched.pick_bucket(n, ladder) == jsched.pick_bucket(n, ladder)
    with pytest.raises(ValueError):
        tsched.pick_bucket(maximum + 1, ladder)


class _Req:
    def __init__(self, rid, prompt, max_new_tokens):
        self.rid = rid
        self.prompt = prompt
        self.prompt_len = len(prompt)
        self.max_new_tokens = max_new_tokens
        self.generated = []
        self.cached_tokens = 0


@pytest.mark.parametrize("prefix", [True, False])
def test_scheduler_decisions_match_jax(prefix):
    """Admission, chunk grants, promotion, decode capacity with newest-first
    preemption and retirement on a tight pool: both schedulers make the
    same decisions, step for step."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 50, size=9)
    prompts = [np.concatenate([base, rng.integers(0, 50, size=int(n))])
               for n in rng.integers(1, 12, size=6)]
    trace = {}
    for name, kv_mod, sched_mod in (("jax", jkv, jsched),
                                    ("port", tkv, tsched)):
        alloc = kv_mod.BlockAllocator(12, 4)
        tree = kv_mod.PrefixTree(alloc) if prefix else None
        sched = sched_mod.PagedScheduler(alloc, max_slots=3,
                                         max_blocks_per_seq=8, chunk=4,
                                         prefix_tree=tree)
        queue = [_Req(i, p, 12) for i, p in enumerate(prompts)]
        log = []
        for tick in range(200):
            while queue:
                seq = sched.admit(queue[0], queue[0].prompt)
                if seq is None:
                    break
                log.append(("admit", queue.pop(0).rid, seq.pos))
            head = sched.next_prefill()
            if head is not None:
                head.pos = min(head.pos + 4, head.prompt_len)
                if head.prefill_done:
                    head.req.generated.append(tick)
                    head.last_token = tick
                    head.n_generated = 1
                    sched.promote(head)
                    log.append(("promote", head.req.rid))
            victims = sched.ensure_decode_capacity()
            log.append(("victims", [v.req.rid for v in victims]))
            for seq in list(sched.running):
                seq.pos += 1
                seq.n_generated += 1
                seq.req.generated.append(tick)
                seq.last_token = tick
                if seq.finished():
                    sched.retire(seq)
                    log.append(("retire", seq.req.rid))
            while sched.preempted:
                seq = sched.preempted.popleft()
                if sched.readmit(seq) is None:
                    sched.preempted.appendleft(seq)
                    break
            log.append(("shape", sched.decode_shape() if sched.running
                        else None, alloc.used_blocks, alloc.cached_blocks))
            if not (queue or sched.live or sched.preempted):
                break
        alloc.check()
        p = sched.payload()
        trace[name] = (log, p["preemptions_total"], p["admitted_total"],
                       p["deferred_total"], p["prefix_tokens_skipped_total"])
    assert trace["port"] == trace["jax"]
    assert trace["port"][1] > 0  # the pool was tight enough to preempt


# ---- the disaggregated handoff: adopt across two allocators ----
# Twins of tests/test_paged_kvcache.py's adopt tests, on the port's classes.

def test_adopt_is_alloc_with_attribution():
    """``adopt`` is exactly ``alloc`` (all-or-nothing, refcount 1,
    check-clean) plus the ``adopted_total`` attribution."""
    a = tkv.BlockAllocator(num_blocks=9, block_size=4)
    got = a.adopt(3)
    assert got is not None and len(got) == 3
    assert a.adopted_total == 3 and a.allocs_total == 3
    assert a.payload()["adopted_total"] == 3
    a.check()
    # Backpressure is all-or-nothing and does NOT count as adopted.
    assert a.adopt(6) is None
    assert a.adopted_total == 3 and a.oom_events == 1
    assert a.free_blocks == 5
    a.free(got)
    a.check()
    assert a.used_blocks == 0


def test_foreign_free_across_two_allocators_raises():
    """Block ids are allocator-LOCAL: a payload's source ids freed into the
    adopting allocator raise even where the ids are numerically valid
    there, and the rejected free mutates nothing."""
    src = tkv.BlockAllocator(num_blocks=17, block_size=4)
    dst = tkv.BlockAllocator(num_blocks=9, block_size=4)
    theirs = src.alloc(4)
    mine = dst.adopt(2)
    foreign = [b for b in theirs if b not in set(mine)]
    assert foreign
    with pytest.raises(ValueError):
        dst.free([foreign[0]])
    dst.check()
    src.check()
    assert dst.used_blocks == 2 and src.used_blocks == 4
    src.free(theirs)
    dst.free(mine)
    src.check()
    dst.check()


def test_adopt_then_prefix_insert_parks_cached():
    """Adopted blocks register into the adopter's prefix tree like locally
    written ones: release parks them cached, a match resurrects them, and
    pressure evicts them before OOM."""
    a = tkv.BlockAllocator(num_blocks=6, block_size=4)
    tree = tkv.PrefixTree(a)
    tokens = tuple(range(8))
    got = a.adopt(2)
    tree.insert(tokens, got)
    a.free(got)
    assert a.used_blocks == 0 and a.cached_blocks == 2
    a.check()
    full, matched, partial = tree.match(tokens + (9, 9))
    assert matched == 8 and full == got and partial is None
    assert a.cached_blocks == 0
    a.free(full)
    a.check()
    grant = a.adopt(a.capacity)
    assert grant is not None and a.cached_blocks == 0
    a.free(grant)
    a.check()


def _handoff_soak(mod) -> tuple[dict, dict]:
    """Randomized mini-handoffs between a producer and an adopter pool of
    ``mod``'s allocator, with ``check()`` on both sides after every op and
    shadow live counts; returns the final payloads (adopter, producer)."""
    rng = np.random.default_rng(18)
    src = mod.BlockAllocator(num_blocks=17, block_size=8)
    dst = mod.BlockAllocator(num_blocks=33, block_size=8)
    in_flight: list[list[int]] = []
    adopted: list[list[int]] = []
    for _ in range(2000):
        op = int(rng.integers(0, 3))
        if op == 0:
            got = src.alloc(int(rng.integers(1, 5)))
            if got is not None:
                in_flight.append(got)
        elif op == 1 and in_flight:
            payload = in_flight.pop(int(rng.integers(0, len(in_flight))))
            got = dst.adopt(len(payload))
            if got is None:
                in_flight.append(payload)
            else:
                assert len(got) == len(payload)
                adopted.append(got)
                src.free(payload)
        elif adopted:
            dst.free(adopted.pop(int(rng.integers(0, len(adopted)))))
        src.check()
        dst.check()
        assert src.used_blocks == sum(len(p) for p in in_flight)
        assert dst.used_blocks == sum(len(t) for t in adopted)
    for p in in_flight:
        src.free(p)
    for t in adopted:
        dst.free(t)
    src.check()
    dst.check()
    assert src.used_blocks == 0 and dst.used_blocks == 0
    assert dst.adopted_total > 0
    return dst.payload(), src.payload()


def test_two_allocator_handoff_refcount_soak():
    """The pools never exchange ids, and the port's allocators make the JAX
    package's decisions over the whole soak (equal final counters)."""
    assert _handoff_soak(tkv) == _handoff_soak(jkv)


@pytest.mark.parametrize("prefix", [True, False])
def test_detach_and_adopt_running_match_jax(prefix):
    """A producer scheduler prefills and detaches each finished head without
    freeing its blocks (registering its full blocks in the prefix tree); a
    consumer scheduler adopts fresh blocks and joins each sequence straight
    into its running set; then the producer releases the payload's blocks.
    The port makes the JAX package's decisions step for step, and both
    pools end clean."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 50, size=9)
    prompts = [np.concatenate([base, rng.integers(0, 50, size=int(n))])
               for n in rng.integers(1, 12, size=5)]
    trace = {}
    for name, kv_mod, sched_mod in (("jax", jkv, jsched),
                                    ("port", tkv, tsched)):
        pa = kv_mod.BlockAllocator(24, 4)
        ptree = kv_mod.PrefixTree(pa) if prefix else None
        prod = sched_mod.PagedScheduler(pa, max_slots=2,
                                        max_blocks_per_seq=8, chunk=4,
                                        prefix_tree=ptree)
        ca = kv_mod.BlockAllocator(24, 4)
        cons = sched_mod.PagedScheduler(ca, max_slots=3,
                                        max_blocks_per_seq=8, chunk=4)
        queue = [_Req(i, p, 3) for i, p in enumerate(prompts)]
        log = []
        for _ in range(100):
            while queue and prod.admit(queue[0], queue[0].prompt):
                queue.pop(0)
            head = prod.next_prefill()
            if head is not None:
                if head.cow_src >= 0:        # the engine's copy-on-write
                    pa.free([head.cow_src])
                    head.cow_src = head.cow_dst = -1
                head.pos = min(head.pos + 4, head.prompt_len)
                if head.prefill_done:
                    prod.detach_prefill_head(head)
                    blocks = list(head.blocks.blocks)
                    assert all(pa.refcount(b) >= 1 for b in blocks)
                    got = ca.adopt(len(blocks))
                    seq = sched_mod.PagedSeq(
                        req=head.req, tokens=head.tokens,
                        blocks=kv_mod.SeqBlocks(ca, got), order=0,
                        pos=head.pos)
                    cons.adopt_running(seq)
                    pa.free(blocks)          # the payload's release
                    log.append((head.req.rid, blocks, got, seq.order,
                                head.prefix_matched, pa.cached_blocks))
            for seq in list(cons.running):
                cons.retire(seq)
            if not (queue or prod.live):
                break
        for a in (pa, ca):
            a.check()
            assert a.used_blocks == 0
        trace[name] = (log, prod.payload(), cons.payload())
    assert trace["port"] == trace["jax"]
    assert len(trace["port"][0]) == len(prompts)
    assert trace["port"][2]["admitted_total"] == len(prompts)
