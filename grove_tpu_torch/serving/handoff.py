"""KV block handoff protocol for disaggregated prefill -> decode serving.

The port's copy of ``grove_tpu/serving/handoff.py``, the seam of
GROVE_DISAGG=1 (docs/design/disaggregated-serving.md): a ``PrefillEngine``
runs chunked prefill to completion against its OWN block pool, then hands
the finished sequence to the ``PagedDecodeEngine`` as a ``HandoffPayload``:
the request, its tokens, the source block ids in table order, the prefill
position, and the sampler state (the first sampled token). Because both
pools are block-granular with per-request tables, adoption is a block-id
REMAP plus a pool copy (same process: one device copy per payload, every
block of it at once; across engines the identical payload would ride an
interconnect transfer), never a buffer reshape.

Ownership rules (the refcount contract the tests pin):

- The payload OWNS one reference per source block from detach until
  ``release()``. The producing engine's scheduler detaches the sequence
  without freeing (``detach_prefill_head``), so a payload in flight keeps
  its blocks live in the SOURCE allocator.
- The consumer adopts FRESH blocks from its own allocator
  (``BlockAllocator.adopt``) and copies payloads across pools; source block
  ids never enter the destination allocator (a foreign free raises there
  by construction).
- ``release()`` is idempotent and is the ONLY path that drops the source
  references. The producer registered the prompt's full blocks into its
  prefix tree at detach time, so the unref parks them in the source's
  cached LRU pool: the source side keeps its warm prefix (matched prefix
  blocks never move; a repeat prompt prefills only its cold suffix).
- If the producer dies mid-handoff, un-released payloads die with its
  allocator (chaos: prefill-replica-kill); the decode side holds no
  reference to anything of the producer's, so its allocator stays clean
  and the request simply re-prefills.

Composition: int8 KV blocks transfer as-is: the copy moves the int8 rows
AND the per-slot scale rows, no requantize (both engines must run the same
kv_quant mode; the facade asserts it). The decode side's prefix cache
still matches adopted tokens, so a warm decode-side prefix turns block
copies into shared refs (only the cold suffix transfers).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class HandoffPayload:
    """One finished prefill, in flight between engines.

    ``tokens`` is the full prefill input (the prompt, or prompt + generated
    for a recompute replay): exactly what the decode side needs for prefix
    matching and later preemption recompute. ``first_token`` is the
    materialized sampler state: the token the producing chunk sampled,
    already appended to ``req.generated`` and TTFT-stamped by the producer.
    """

    rid: int
    req: object                     # serving.engine.Request
    tokens: np.ndarray              # int32 [pos]: prefill input
    first_token: int                # sampler state (last sampled token)
    blocks: list[int]               # SOURCE block ids, table order
    pos: int                        # tokens written to the source pool
    n_generated: int
    recompute: bool
    source: object                  # producing PrefillEngine
    block_bytes: int                # bytes one block moves (quant-aware)
    # The request's live trace (serving/reqtrace.RequestTrace | None),
    # carried across the seam so ONE trace spans both tiers: the adopting
    # engine splices it through ``RequestObservatory.adopt_trace`` (a
    # no-op under the shared disaggregated recorder). None when tracing
    # is off.
    trace: object = None
    created_ts: float = dataclasses.field(default_factory=time.time)
    _released: bool = dataclasses.field(default=False, repr=False)

    @property
    def nbytes(self) -> int:
        """Transfer bytes this payload represents (K + V + scales for every
        block)."""
        return len(self.blocks) * self.block_bytes

    def release(self) -> None:
        """Drop the payload's source-side block references (idempotent).
        The producer registered the prompt's full blocks at detach, so the
        unref parks them in the source's cached LRU pool instead of freeing:
        the producer keeps its warm prefix across handoffs."""
        if self._released:
            return
        self._released = True
        self.source._release_handoff(self)
