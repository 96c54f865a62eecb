"""Paged KV cache for the continuous-batching decode engine.

The port's copy of ``grove_tpu/serving/kvcache.py``: the same memory model
and the same host bookkeeping, with the pools as torch tensors on the
engine's device.

- **Fixed-size blocks.** One pool per engine for K and one for V,
  ``[layers, num_blocks, block_size, n_kv, head_dim]``. Block 0 is the
  NULL block: padded block-table rows and inactive batch slots point at
  it, so the scatter and the attention kernels never branch on shape:
  garbage lands in (and is read from) a block no live sequence owns, and
  the attention mask discards it.
- **Per-request block tables.** A sequence owns an ordered list of block
  ids; token position ``p`` lives at block ``table[p // bs]``, slot
  ``p % bs``. Tables are padded to bucketed widths on the way to the
  device (serving/schedule.py holds the bucket ladder), so the set of
  decode shapes, and of captured CUDA graphs, is finite.
- **Host-side allocator.** A LIFO free list with all-or-nothing grants: a
  shortfall returns None (the scheduler's backpressure signal), and a
  double free or a foreign free raises. Nothing here touches a device.
- **Refcounted sharing + prefix tree.** The same block can back a shared
  prompt prefix in many live tables; ``PrefixTree`` keys full-block token
  runs in a trie, and a registered block parks in an LRU pool of cached
  blocks at its last unref, which ``alloc`` evicts (leaf first) before it
  ever reports OOM. A sequence that diverges mid-block copies on write
  (the engine copies the shared block before any write lands in it).

The pools are updated in place by ``models/llama.decode_step_paged`` and
``prefill_chunk_paged`` (the JAX package donates them instead). With
``GROVE_KV_QUANT=int8`` they hold int8 rows and per-(slot, head) f32 scales
(ops/kvquant.py quantizes, ops/paged.py dequantizes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Block 0 never leaves the allocator: padding rows of every block table
# point at it, and inactive batch slots scatter their dead writes into
# it. One sacrificial block buys static shapes everywhere else.
NULL_BLOCK = 0


@dataclasses.dataclass
class PagedKV:
    """The device half: one K and one V block pool,
    ``[layers, num_blocks, block_size, n_kv, head_dim]``.

    The pools live for the engine's lifetime and are written in place, so
    a captured CUDA graph can hold their addresses. With int8 KV
    (``quant="int8"``) the pools hold int8 rows and ``k_scale``/``v_scale``
    the per-(slot, head) symmetric dequantize scales, ``[layers,
    num_blocks, block_size, n_kv]`` f32: per slot because rows are written
    one at a time (a whole-block scale would need slots the writer has not
    seen). Without it the scales are None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, n_layers: int, num_blocks: int, block_size: int,
               n_kv: int, head_dim: int, dtype: torch.dtype = torch.bfloat16,
               quant: str = "off",
               device: str | torch.device = "cpu") -> "PagedKV":
        shape = (n_layers, num_blocks, block_size, n_kv, head_dim)
        if quant == "int8":
            sshape = shape[:-1]
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(sshape, dtype=torch.float32,
                                           device=device),
                       v_scale=torch.zeros(sshape, dtype=torch.float32,
                                           device=device))
        if quant != "off":
            raise ValueError(f"unknown KV quant mode {quant!r}")
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def pool_bytes(self) -> int:
        """Device bytes of both pools, scales included."""
        parts = (self.k, self.v) if self.k_scale is None else \
            (self.k, self.v, self.k_scale, self.v_scale)
        return sum(t.numel() * t.element_size() for t in parts)

    @property
    def scales(self) -> dict:
        """The scale pools as keyword arguments of the paged model
        functions (``k_scale=``, ``v_scale=``); empty without int8."""
        if self.k_scale is None:
            return {}
        return {"k_scale": self.k_scale, "v_scale": self.v_scale}

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def tokens_capacity(self) -> int:
        """Usable token capacity (the null block is not allocatable)."""
        return (self.num_blocks - 1) * self.block_size


class BlockAllocator:
    """Host-side free-list allocator over the block pool.

    LIFO reuse (recently freed blocks are likeliest still warm in HBM
    caches / host page tables), all-or-nothing grants, and loud
    invariant violations: a double free or a free of a never-granted
    block is a scheduler bug, not a recoverable condition.

    With a ``PrefixTree`` attached (the serving prefix cache) every
    block is in exactly one of three states:

    - FREE: in the LIFO free list, contents garbage.
    - LIVE: refcount ≥ 1 — one count per live table holding it (plus
      one while a pending copy-on-write source). ``alloc`` grants at
      refcount 1; ``ref`` shares; ``free``/``unref`` decrements.
    - CACHED: refcount 0 but tree-registered — contents are a hashed
      prompt prefix worth keeping. Parked in an LRU pool that ``alloc``
      reclaims from (via the tree's leaf-first eviction hook) BEFORE
      reporting OOM, so cached blocks are headroom, never pressure: the
      all-or-nothing grant and the ``None`` backpressure signal are
      byte-identical to the unshared allocator.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        assert num_blocks >= 2, "need at least the null block + one real"
        assert block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Block ids count down so early allocations pop low ids — makes
        # allocator traces readable; NULL_BLOCK (0) is never in the list.
        self._free: list[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._refs: dict[int, int] = {}
        # Zero-ref blocks retained for the prefix cache, insertion
        # order = LRU (oldest first). Only the PrefixTree hooks below
        # ever move blocks in or out of here.
        self._cached: dict[int, None] = {}
        # Tree attachment points (None = unshared seed behavior).
        self.retain_hook = None     # block -> bool: cache on last unref?
        self.reclaim_hook = None    # () -> list[int]: evict one LRU unit
        # Counters for the telemetry/debug surfaces and the soak tests.
        self.allocs_total = 0
        self.frees_total = 0
        self.refs_total = 0
        self.oom_events = 0
        self.high_water = 0
        self.reclaimed_total = 0
        self.cached_high_water = 0
        self.adopted_total = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """LIVE blocks (refcount ≥ 1). Cached blocks are headroom and
        deliberately NOT counted: a drained engine with a warm prefix
        cache still reads used_blocks == 0."""
        return len(self._refs)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def utilization(self) -> float:
        """Fraction of the allocatable pool in LIVE use — the paged
        analog of the lanes engine's kv_lane_utilization gauge (cached
        blocks are reclaimable, so they do not count as pressure)."""
        return self.used_blocks / self.capacity if self.capacity else 0.0

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._cached)

    def alloc(self, n: int) -> list[int] | None:
        """Grant ``n`` blocks, or None (backpressure) — never partial.
        The None is the signal the scheduler turns into deferred
        admission or preemption; raising here would make every
        steady-state OOM an exception on the hot path. A shortfall
        against the free list alone is NOT an OOM while the cached pool
        can cover it: unreferenced prefix blocks are evicted LRU-first
        to fill the grant (eviction before backpressure, always)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) + len(self._cached):
            self.oom_events += 1
            return None
        while n > len(self._free):
            self._reclaim_one()
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self.allocs_total += n
        self.high_water = max(self.high_water, len(self._refs))
        return got

    def adopt(self, n: int) -> list[int] | None:
        """Grant ``n`` blocks whose contents another engine's pool fills
        (the disaggregated handoff: serving/handoff.py). The semantics are
        exactly ``alloc``'s: all-or-nothing, cached-LRU reclaim before
        backpressure, refcount 1 to the caller; the separate entry point
        counts handoff-adopted blocks apart from locally written ones. The
        ids are LOCAL: the handoff remaps the source table onto them and
        never imports a foreign id (freeing one raises like any other
        unallocated free)."""
        got = self.alloc(n)
        if got is not None:
            self.adopted_total += n
        return got

    def _reclaim_one(self) -> None:
        """Evict one LRU unit from the cached pool into the free list.
        The tree's hook picks the victim (leaf-first) and drops its
        node(s); blocks it reports are moved here so the free/cached
        accounting lives in one place."""
        if self.reclaim_hook is None:
            raise RuntimeError("free-list shortfall with no reclaim hook "
                               "— can_alloc/alloc disagree")
        freed = self.reclaim_hook()
        if not freed:
            raise RuntimeError("cached-pool reclaim made no progress")
        self.reclaim(freed)

    def reclaim(self, blocks: list[int]) -> None:
        """Move cached blocks that the tree dropped into the free list."""
        for b in blocks:
            del self._cached[b]
            self._free.append(b)
            self.reclaimed_total += 1

    def ref(self, b: int) -> None:
        """Share a block: bump a live refcount, or resurrect a cached
        block to LIVE at refcount 1 (a prefix-tree hit)."""
        if b in self._refs:
            self._refs[b] += 1
        elif b in self._cached:
            del self._cached[b]
            self._refs[b] = 1
        else:
            raise ValueError(f"ref of unallocated block {b}")
        self.refs_total += 1
        self.high_water = max(self.high_water, len(self._refs))

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per listed block. The last reference
        either returns the block to the free list or — when the prefix
        tree claims it (``retain_hook``) — parks it in the cached LRU
        pool with its contents intact. Unref of a block nobody holds
        raises: that is a double free whether or not sharing is on."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("freeing the null block")
            r = self._refs.get(b)
            if r is None:
                raise ValueError(
                    f"free of unallocated block {b} (double free or "
                    "foreign block) — scheduler bookkeeping is corrupt")
            if r > 1:
                self._refs[b] = r - 1
            else:
                del self._refs[b]
                if self.retain_hook is not None and self.retain_hook(b):
                    self._cached[b] = None  # append = most recent
                    self.cached_high_water = max(self.cached_high_water,
                                                 len(self._cached))
                else:
                    self._free.append(b)
            self.frees_total += 1

    def check(self) -> None:
        """Structural invariants (the soak test sweeps this between
        every operation): free ∪ live ∪ cached partitions
        [1, num_blocks), no duplicates anywhere, every live refcount
        ≥ 1, null block owned by nobody."""
        free = set(self._free)
        live = set(self._refs)
        cached = set(self._cached)
        assert len(free) == len(self._free), "duplicate in free list"
        assert not (free & live), "block both free and live"
        assert not (free & cached), "block both free and cached"
        assert not (live & cached), "block both live and cached"
        assert NULL_BLOCK not in free | live | cached
        assert free | live | cached == set(range(1, self.num_blocks)), \
            "leaked or foreign block"
        assert all(r >= 1 for r in self._refs.values()), \
            "zero refcount held as live"

    def payload(self) -> dict:
        return {"capacity": self.capacity, "used": self.used_blocks,
                "free": self.free_blocks, "block_size": self.block_size,
                "cached": self.cached_blocks,
                "utilization": round(self.utilization, 4),
                "allocs_total": self.allocs_total,
                "frees_total": self.frees_total,
                "refs_total": self.refs_total,
                "oom_events": self.oom_events,
                "high_water": self.high_water,
                "reclaimed_total": self.reclaimed_total,
                "cached_high_water": self.cached_high_water,
                "adopted_total": self.adopted_total}


@dataclasses.dataclass
class SeqBlocks:
    """One sequence's block table: the ordered block ids backing token
    positions [0, capacity). Growth is allocator-mediated and
    all-or-nothing; ``release`` is idempotent."""

    allocator: BlockAllocator
    blocks: list[int] = dataclasses.field(default_factory=list)

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.allocator.block_size

    def ensure(self, n_tokens: int) -> bool:
        """Grow the table to hold ``n_tokens`` total. False = OOM
        backpressure (table unchanged — the all-or-nothing grant means
        a failed ensure never strands half the growth)."""
        bs = self.allocator.block_size
        need = max(0, -(-n_tokens // bs) - len(self.blocks))
        if need == 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            return False
        self.blocks.extend(got)
        return True

    def release(self) -> None:
        if self.blocks:
            self.allocator.free(self.blocks)
            self.blocks = []


class PrefixNode:
    """One full block's worth of tokens in the prefix trie. ``key`` is
    the exact token tuple the block holds (the "hash" is dict hashing
    of that tuple — exact-match, collision-free by construction);
    ``block`` is the pool block whose KV backs those positions."""

    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key: tuple | None, block: int,
                 parent: "PrefixNode | None") -> None:
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple, PrefixNode] = {}


class PrefixTree:
    """Block-granular radix tree over prompt prefixes (SGLang's
    RadixAttention shape, sized to this engine).

    - **Keys are token tuples, one per FULL block** — position ``p`` of
      a registered chain holds exactly the KV a cold prefill would
      write there, so a hit is bitwise-identical to recompute.
    - **match** walks full-block children, then probes ONE partial
      block (the longest child-key prefix): the caller shares that
      block's already-computed tokens and must copy-on-write before
      writing its divergent tail. At most ``len(tokens) - 1`` tokens
      ever match — the final prompt token must run through prefill to
      produce first-token logits.
    - **Ownership**: match/insert never hold tree-side refs. Matched
      blocks are ref'd FOR THE CALLER (its release unrefs them);
      registration only marks a block worth caching, so the owner's
      last unref parks it in the allocator's cached LRU pool.
    - **Eviction** (the allocator's reclaim hook): oldest cached LEAF
      first — evicting a mid-chain node would orphan its descendants.
      When every cached node has children (possible once a divergent
      sequence grafts a live child under a cached parent), the oldest
      cached subtree is dropped whole: live descendants are merely
      unregistered (they free normally at last unref), cached ones are
      reclaimed as a bonus.
    """

    def __init__(self, allocator: BlockAllocator) -> None:
        self.allocator = allocator
        self.block_size = allocator.block_size
        self.root = PrefixNode(None, NULL_BLOCK, None)
        self._nodes: dict[int, PrefixNode] = {}   # block id -> node
        allocator.retain_hook = self._nodes.__contains__
        allocator.reclaim_hook = self._evict_lru_unit
        # Telemetry counters (ride the slo digest + engine payload).
        self.lookups = 0
        self.hits = 0                # lookups that matched ≥ 1 token
        self.tokens_matched_total = 0
        self.inserts = 0
        self.nodes_high_water = 0
        self.cow_shares = 0          # partial matches handed out

    @property
    def nodes(self) -> int:
        return len(self._nodes)

    # ---- lookup ----

    def match(self, tokens: np.ndarray
              ) -> tuple[list[int], int, tuple[int, int] | None]:
        """Longest registered prefix of ``tokens``, capped at
        ``len(tokens) - 1``. Returns ``(full_blocks, n_matched,
        partial)`` where ``full_blocks`` are whole-block hits in chain
        order, ``n_matched`` counts ALL matched tokens, and ``partial``
        is ``(block, k)`` when the last ``k`` of them sit in a shared
        block the caller must copy-on-write. Every returned block
        (including the partial source) carries one ref for the caller
        — on any later bail-out, unref them all."""
        self.lookups += 1
        bs = self.block_size
        limit = len(tokens) - 1
        node = self.root
        blocks: list[int] = []
        matched = 0
        while matched + bs <= limit:
            child = node.children.get(tuple(int(t) for t in
                                            tokens[matched:matched + bs]))
            if child is None:
                break
            self.allocator.ref(child.block)
            blocks.append(child.block)
            matched += bs
            node = child
        partial = None
        tail = tuple(int(t) for t in tokens[matched:limit])
        if tail:
            best, best_child = 0, None
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, tail):
                    if a != b:
                        break
                    n += 1
                if n > best:
                    best, best_child = n, child
            if best_child is not None:
                self.allocator.ref(best_child.block)
                partial = (best_child.block, best)
                matched += best
                self.cow_shares += 1
        if matched:
            self.hits += 1
            self.tokens_matched_total += matched
        return blocks, matched, partial

    # ---- registration ----

    def insert(self, tokens: np.ndarray, blocks: list[int]) -> int:
        """Register the chain of FULL blocks backing ``tokens`` (block
        ``i`` holds ``tokens[i*bs:(i+1)*bs]``). First writer wins: a
        key already present keeps its existing block (the duplicate
        simply frees at its owner's last unref), and the walk descends
        through the existing node so deeper suffix blocks still graft
        on. Returns newly registered nodes. No refs are taken."""
        bs = self.block_size
        assert len(blocks) * bs <= len(tokens), (len(blocks), len(tokens))
        node = self.root
        added = 0
        for i, b in enumerate(blocks):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None and b not in self._nodes \
                    and b in self.allocator._refs:
                child = PrefixNode(key, b, node)
                node.children[key] = child
                self._nodes[b] = child
                added += 1
            if child is None:
                break  # b already registered elsewhere: stop grafting
            node = child
        if added:
            self.inserts += 1
            self.nodes_high_water = max(self.nodes_high_water,
                                        len(self._nodes))
        return added

    def clear(self) -> int:
        """Forget every registered prefix (after a warm restart replaced
        the weights that computed their KV): cached blocks go back to the
        free list, live ones free normally at their last unref. Returns
        the blocks freed."""
        freed = []
        for child in list(self.root.children.values()):
            freed += self._drop_subtree(child)
        self.allocator.reclaim(freed)
        return len(freed)

    # ---- eviction (allocator reclaim hook) ----

    def _evict_lru_unit(self) -> list[int]:
        """Evict one unit from the cached pool: the oldest cached leaf,
        or — if every cached node has children — the oldest cached
        subtree. Returns the cached block ids released (the allocator
        moves them to the free list)."""
        cached = self.allocator._cached
        victim = None
        for b in cached:
            if not self._nodes[b].children:
                victim = b
                break
        if victim is None:
            victim = next(iter(cached), None)
        if victim is None:
            return []
        return self._drop_subtree(self._nodes[victim])

    def _drop_subtree(self, node: PrefixNode) -> list[int]:
        """Unregister ``node`` and every descendant. Cached descendants
        are returned for reclaim; live ones just lose their cached-on-
        release promise (they free normally)."""
        if node.parent is not None:
            del node.parent.children[node.key]
        stack, freed = [node], []
        while stack:
            n = stack.pop()
            del self._nodes[n.block]
            if n.block in self.allocator._cached:
                freed.append(n.block)
            stack.extend(n.children.values())
            n.children = {}
            n.parent = None
        return freed

    def payload(self) -> dict:
        hit_rate = self.hits / self.lookups if self.lookups else 0.0
        return {"nodes": self.nodes,
                "cached_blocks": self.allocator.cached_blocks,
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": round(hit_rate, 4),
                "tokens_matched_total": self.tokens_matched_total,
                "inserts": self.inserts,
                "cow_shares": self.cow_shares,
                "nodes_high_water": self.nodes_high_water,
                "reclaimed_total": self.allocator.reclaimed_total}


def pad_tables(tables: list[list[int]], width: int) -> np.ndarray:
    """Stack per-sequence block-id lists into a ``[len(tables), width]``
    int32 array, padding with the null block. ``width`` must cover the
    widest table (the scheduler's width bucket guarantees it)."""
    out = np.full((len(tables), width), NULL_BLOCK, np.int32)
    for i, t in enumerate(tables):
        assert len(t) <= width, (len(t), width)
        out[i, :len(t)] = t
    return out
