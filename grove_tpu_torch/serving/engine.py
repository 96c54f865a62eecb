"""Serving engine: continuous-batching decode over fixed lanes, and the
prefill worker of disaggregated serving.

- fixed decode batch lanes: inactive lanes compute too, so every step has
  the same shapes;
- prefill and decode are separate calls so that they can run in separate
  pods: ``PrefillWorker`` returns the per-sequence KV slab and
  ``DecodeEngine.insert`` splices it into a free lane;
- the KV cache is updated in place (the JAX package donates it);
- sampled tokens accumulate on the device and reach the host once per
  window of ``host_sync_interval`` steps; ``step`` itself never waits for
  the device;
- a queue-depth metric hook feeds the control plane's autoscaler.

Only the lanes engine (``GROVE_ENGINE=lanes``) is ported so far; the paged
engine, the request/device observatories and chunked prefill are not, and
asking for them raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.models import llama
from grove_tpu_torch.models.llama import LlamaConfig
from grove_tpu_torch.ops.kvcache import KVCache


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Token sampling: temperature 0 = greedy argmax; otherwise a
    temperature-scaled categorical over the top_k logits (0 = full vocab).
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None,
                  cfg: SamplerConfig) -> torch.Tensor:
    """logits [b, vocab] -> tokens [b] int32 per the sampler config. The
    categorical draw is Gumbel-max with noise from ``generator`` (on the
    logits' device); it does not reproduce the JAX package's draws."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / cfg.temperature
    if 0 < cfg.top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [s] int32 (may be right-padded)
    max_new_tokens: int = 32
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # True prompt length (!= len(prompt) for padded rows). Lets the engine
    # do all cache-capacity math on the host: after g generated tokens the
    # lane's next write lands at prompt_len + g - 1.
    prompt_len: int = -1
    # SLO stamps: host wall clock, 0.0 = never reached. enqueue/admit/
    # first-token are exact; done is observed at window drain, so it can
    # trail the true completion by interval-1 steps.
    enqueue_ts: float = 0.0
    admit_ts: float = 0.0
    first_token_ts: float = 0.0
    done_ts: float = 0.0
    # Prompt tokens served from a prefix cache at first admission (0 =
    # cold; the lanes engine has no prefix cache).
    cached_tokens: int = 0

    def __post_init__(self):
        if self.prompt_len < 0:
            self.prompt_len = len(self.prompt)


@dataclasses.dataclass
class PrefillResult:
    """Everything decode needs to continue a sequence: the KV slab and the
    first sampled token (the disaggregation transfer payload)."""

    k: torch.Tensor        # [layers, s_pad, n_kv, d]
    v: torch.Tensor        # [layers, s_pad, n_kv, d]
    length: int
    next_token: int


def _stamp_admit_impl(req: Request, now: float, admit: float | None,
                      compat: bool, telemetry) -> None:
    """Admission stamps: ``now`` is when the first token existed, ``admit``
    when the request left the queue. Compat mode (GROVE_TTFT_COMPAT=1)
    fuses them to one stamp. The prefill-sampled token is counted here,
    so the drain only accounts decode tokens."""
    if compat or admit is None or admit > now:
        admit = now
    req.admit_ts = admit
    if not req.enqueue_ts:
        req.enqueue_ts = admit
    req.first_token_ts = now
    if telemetry is not None:
        telemetry.add_tokens(1)


def _complete_impl(req: Request, completed: list, telemetry) -> None:
    """Completion bookkeeping: stamp done, record, fold into telemetry."""
    req.done = True
    req.done_ts = time.time()
    completed.append(req)
    if telemetry is not None:
        telemetry.observe_request(req)


def _quantized(params, quant: str | None):
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    if quant == "int8":
        from grove_tpu_torch.serving.quant import quantize_params
        return quantize_params(params)
    return params


class PrefillWorker:
    """The prefill side of disaggregated serving (one-shot prefill)."""

    def __init__(self, cfg: LlamaConfig, params, batch: int = 1,
                 max_prompt: int | None = None,
                 sampler: SamplerConfig | None = None,
                 quant: str | None = None,
                 prefill_chunk: int | None = None,
                 device: str | torch.device | None = None):
        if prefill_chunk:
            raise NotImplementedError(
                "chunked prefill is not ported yet (ROADMAP.md, queue 1)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _quantized(params, quant)
        self.batch = batch
        self.max_prompt = max_prompt or cfg.max_seq_len
        self.sampler = sampler or SamplerConfig()
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.sampler.seed)
        self._cache = KVCache.create(cfg.n_layers, batch, self.max_prompt,
                                     cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                     self.device)

    def prefill(self, prompts: list[np.ndarray]) -> list[PrefillResult]:
        """Prefill up to ``batch`` prompts (right-padded to one length).
        Each result owns its KV slab (a copy), so the worker's cache can
        take the next batch."""
        if not 0 < len(prompts) <= self.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of "
                             f"{self.batch}")
        s_pad = self.max_prompt
        toks = np.zeros((self.batch, s_pad), np.int32)
        lengths = np.zeros((self.batch,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            lengths[i] = len(p)
        logits, cache = llama.prefill(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device),
            self._cache, torch.from_numpy(lengths).to(self.device))
        self._cache = cache
        if self.sampler.temperature > 0.0:
            next_dev = sample_tokens(logits, self._gen, self.sampler)
        else:
            next_dev = torch.argmax(logits, dim=-1)
        next_tokens = next_dev.cpu().numpy()
        return [PrefillResult(k=cache.k[:, i].clone(), v=cache.v[:, i].clone(),
                              length=int(lengths[i]),
                              next_token=int(next_tokens[i]))
                for i in range(len(prompts))]


class DecodeEngine:
    """Continuous-batching decode over fixed lanes.

    Two operating modes:
    - standalone: ``admit_prompts`` prefills in-engine (single-pod serving,
      also the bench path);
    - disaggregated: ``insert`` splices a PrefillResult produced elsewhere.

    ``telemetry``, ``xprof`` and ``reqtrace`` (the JAX package's
    observatories) are not ported: pass None or False.
    """

    def __init__(self, cfg: LlamaConfig, key_or_params, batch: int = 8,
                 max_len: int | None = None,
                 metric_hook: Callable[[int], None] | None = None,
                 host_sync_interval: int = 8,
                 sampler: SamplerConfig | None = None,
                 quant: str | None = None,
                 telemetry=None,
                 xprof=None,
                 reqtrace=None,
                 device: str | torch.device | None = None):
        for name, val in (("telemetry", telemetry), ("xprof", xprof),
                          ("reqtrace", reqtrace)):
            if val is not None and val is not False:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP.md, queue 1); "
                    "pass None")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._sampler = sampler or SamplerConfig()
        # A torch.Generator means "initialise random params from it";
        # anything else is a params dict already on ``device``.
        if isinstance(key_or_params, torch.Generator):
            key_or_params = llama.init_params(cfg, key_or_params,
                                              self.device)
        self.params = _quantized(key_or_params, quant)
        self.quant = quant
        self.batch = batch
        self.max_len = max_len or cfg.max_seq_len
        self.metric_hook = metric_hook
        self.telemetry = None
        # Completion bookkeeping needs sampled tokens on the host; fetching
        # every step would serialise the launch queue behind a device->host
        # sync. Tokens accumulate on the device and drain every
        # ``host_sync_interval`` steps (a finished lane decodes at most
        # interval-1 wasted steps).
        self.host_sync_interval = max(1, host_sync_interval)
        self.cache = KVCache.create(cfg.n_layers, batch, self.max_len,
                                    cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                    self.device)
        self._tokens = torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)
        self._active = np.zeros((batch,), bool)
        self._requests: list[Request | None] = [None] * batch
        self._queue: deque[Request] = deque()
        self._pending_tokens: list[torch.Tensor] = []
        # Steps already pending when a lane was (re)admitted: tokens from
        # before the admission belong to the previous occupant.
        self._lane_window_start = np.zeros((batch,), np.int32)
        self._next_rid = 0
        self.completed: list[Request] = []
        self.steps = 0
        self._sampling = self._sampler.temperature > 0.0
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._sampler.seed)
        # GROVE_TTFT_COMPAT=1 fuses admit_ts with first_token_ts (the
        # historical single stamp); by default admit is queue exit.
        self._ttft_compat = os.environ.get("GROVE_TTFT_COMPAT", "0") == "1"

    @property
    def sampler(self) -> SamplerConfig:
        return self._sampler

    # ---- the model calls ----

    def _decode(self) -> None:
        """One decode step on the device: advances the cache in place and
        replaces ``self._tokens`` (never written in place: earlier token
        tensors may still sit in the pending window)."""
        logits, self.cache = llama.decode_step(self.cfg, self.params,
                                               self._tokens, self.cache)
        if self._sampling:
            self._tokens = sample_tokens(logits, self._gen, self._sampler)
        else:
            self._tokens = torch.argmax(logits, dim=-1).to(torch.int32)

    # ---- request intake ----

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, enqueue_ts=time.time())
        self._next_rid += 1
        self._queue.append(req)
        self._report_metric()
        return req.rid

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def kv_lane_utilization(self) -> float:
        """Fraction of decode lanes occupied (1.0 = no free lane)."""
        return float(np.count_nonzero(self._active)) / self.batch

    def _report_metric(self) -> None:
        if self.metric_hook is not None:
            self.metric_hook(len(self._queue))

    def _stamp_admit(self, req: Request, now: float,
                     admit: float | None = None) -> None:
        """``now``: the first token exists (post-prefill); ``admit``: the
        request left the queue (pre-prefill)."""
        _stamp_admit_impl(req, now, admit, self._ttft_compat, self.telemetry)

    def _complete(self, req: Request) -> None:
        _complete_impl(req, self.completed, self.telemetry)

    # ---- standalone mode (bench path) ----

    def admit_prompts(self, prompts: torch.Tensor,
                      max_new_tokens: int | None = None,
                      lengths: torch.Tensor | None = None) -> None:
        """Prefill a full batch [batch, s] into the lanes.

        ``lengths`` [batch] gives true per-lane prompt lengths for ragged
        (right-padded) batches; defaults to s. With ``max_new_tokens`` each
        lane gets a tracked Request and the full completion bookkeeping
        runs; without it, lanes decode untracked (raw-throughput loops).
        """
        prompts = torch.as_tensor(prompts).to(self.device)
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"{b} prompts for {self.batch} lanes")
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=self.device)
        else:
            lengths = torch.as_tensor(lengths).to(self.device, torch.int32)
        admit_wall = time.time()  # queue exit: prefill not yet started
        logits, self.cache = llama.prefill(self.cfg, self.params, prompts,
                                           self.cache, lengths)
        if self._sampling:
            self._tokens = sample_tokens(logits, self._gen, self._sampler)
        else:
            self._tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        self._active[:] = True
        if max_new_tokens is not None:
            prompts_np = prompts.cpu().numpy()
            lengths_np = lengths.cpu().numpy()
            first = self._tokens.cpu().numpy()
            self._lane_window_start[:] = len(self._pending_tokens)
            now = time.time()
            for i in range(b):
                req = Request(rid=self._next_rid, prompt=prompts_np[i],
                              max_new_tokens=max_new_tokens,
                              prompt_len=int(lengths_np[i]))
                self._next_rid += 1
                self._requests[i] = req
                self._stamp_admit(req, now, admit=admit_wall)
                req.generated.append(int(first[i]))
            self._report_metric()

    # ---- disaggregated mode ----

    def free_lanes(self) -> list[int]:
        return [i for i in range(self.batch) if not self._active[i]]

    def release_lane(self, lane: int,
                     zero_kv: bool = True) -> "Request | None":
        """Retire a lane's occupant and free the lane. The KV length is
        zeroed so the next occupant starts from a clean row;
        ``zero_kv=False`` skips that write for a retire-then-insert
        hand-off. Returns the retired Request (marked done) or None for an
        untracked/empty lane. Idempotent on free lanes."""
        occupant = self._requests[lane]
        if occupant is not None:
            # Tokens this lane already decoded belong to the retiring
            # request: drain pending windows first.
            self._drain()
        req = self._requests[lane]  # the drain may have completed it
        if req is not None:
            self._complete(req)
            self._requests[lane] = None
        if self._active[lane]:
            self._active[lane] = False
            if zero_kv:
                self.cache.lengths[lane] = 0
            self._report_metric()
        return occupant

    def insert(self, lane: int, result: PrefillResult,
               request: Request | None = None) -> None:
        """Splice a prefilled sequence into a free lane (KV handoff)."""
        if self._active[lane]:
            raise ValueError(f"lane {lane} busy")
        s = result.k.shape[1]
        self.cache.k[:, lane, :s] = result.k.to(self.cache.k.dtype)
        self.cache.v[:, lane, :s] = result.v.to(self.cache.v.dtype)
        self.cache.lengths[lane] = result.length
        tokens = self._tokens.clone()  # the old tensor may be pending
        tokens[lane] = result.next_token
        self._tokens = tokens
        self._active[lane] = True
        self._requests[lane] = request
        self._lane_window_start[lane] = len(self._pending_tokens)
        if request is not None:
            request.prompt_len = result.length
            # A request pre-stamped at queue exit (admit_from_queue) keeps
            # that admit; bare inserts fuse admit = first token.
            self._stamp_admit(request, time.time(),
                              admit=request.admit_ts or None)
            request.generated.append(result.next_token)

    def admit_from_queue(self, prefiller: PrefillWorker) -> int:
        """Move queued requests through the prefiller into free lanes."""
        admitted = 0
        lanes = self.free_lanes()
        while lanes and self._queue:
            take = min(len(lanes), prefiller.batch, len(self._queue))
            popped = time.time()  # queue exit, before the prefill runs
            reqs = [self._queue.popleft() for _ in range(take)]
            for r in reqs:
                r.admit_ts = popped
            results = prefiller.prefill([r.prompt for r in reqs])
            for req, res in zip(reqs, results):
                self.insert(lanes.pop(0), res, req)
                admitted += 1
        self._report_metric()
        return admitted

    # ---- decode ----

    def step(self) -> None:
        """One decode step across all lanes (inactive lanes compute too).
        Launches device work only: no host fetch unless a window of
        tracked tokens is full."""
        self._decode()
        self.steps += 1
        if any(r is not None for r in self._requests):
            self._pending_tokens.append(self._tokens)
            if len(self._pending_tokens) >= self.host_sync_interval:
                self._drain()

    def _lane_has_room(self, req: Request, n: int) -> bool:
        """Host-side capacity check: after g generated tokens the lane's
        next write lands at prompt_len + g - 1, so n more steps fit iff
        that stays within max_len (write_row clamps silently past it)."""
        return req.prompt_len + len(req.generated) - 1 + n <= self.max_len

    def _drain(self) -> None:
        """Process accumulated single-step tokens: one host fetch per
        window."""
        if not self._pending_tokens:
            return
        toks = torch.stack(self._pending_tokens).cpu().numpy()  # [w, batch]
        self._pending_tokens.clear()
        self._process_window(toks, offsets=self._lane_window_start)
        self._lane_window_start[:] = 0

    def _process_window(self, toks: np.ndarray,
                        offsets: np.ndarray | None = None) -> None:
        """Completion bookkeeping over a [w, batch] token window.
        ``offsets[i]`` = rows belonging to lane i's previous occupant
        (single-step path; block windows never contain them)."""
        freed = False
        for i, req in enumerate(self._requests):
            if req is None or not self._active[i]:
                continue
            start = int(offsets[i]) if offsets is not None else 0
            for t in toks[start:, i]:
                req.generated.append(int(t))
                if len(req.generated) >= req.max_new_tokens:
                    break
            if len(req.generated) >= req.max_new_tokens or \
                    not self._lane_has_room(req, self.host_sync_interval):
                self._complete(req)
                self._requests[i] = None
                self._active[i] = False
                freed = True
                self.cache.lengths[i] = 0
        if freed:
            self._report_metric()

    def sync(self) -> None:
        """Drain outstanding bookkeeping and wait for the device."""
        self._drain()
        self._tokens.cpu()

    def run(self, steps: int) -> None:
        """Decode ``steps`` steps in throughput mode: full windows of
        ``host_sync_interval`` steps accumulate their tokens on the device
        and the bookkeeping drains with one fetch at the end; the remainder
        decodes through single steps. Completion is observed per ``run``
        call, not per window. Lane admission happens between calls."""
        K = self.host_sync_interval
        self._drain()  # single-step leftovers use the offset bookkeeping
        tracked = any(r is not None for r in self._requests)
        if tracked:
            # Deferred bookkeeping cannot free lanes mid-run, so cap the
            # block phase at the steps every tracked lane has room for; the
            # rest goes through the draining single-step path.
            safe = min((self.max_len - req.prompt_len
                        - len(req.generated) + 1
                        for req in self._requests if req is not None),
                       default=steps)
            block_steps = min(steps, max(0, safe))
        else:
            block_steps = steps
        steps -= (block_steps // K) * K
        windows: list[torch.Tensor] = []
        for _ in range(block_steps // K):
            window = []
            for _ in range(K):
                self._decode()
                window.append(self._tokens)
            self.steps += K
            if tracked:
                windows.append(torch.stack(window))
        fetched = False
        if windows:
            # One fetch of every window ([w, batch] rows); it is also the
            # sync for the block phase.
            self._process_window(torch.cat(windows).cpu().numpy())
            fetched = True
        for _ in range(steps):
            self.step()
        if steps or not fetched:
            self.sync()


def engine_mode() -> str:
    """GROVE_ENGINE=paged|lanes (default paged)."""
    mode = os.environ.get("GROVE_ENGINE", "paged")
    if mode not in ("paged", "lanes"):
        raise ValueError(f"GROVE_ENGINE={mode!r} (expected paged|lanes)")
    return mode


def make_engine(cfg: LlamaConfig, key_or_params, *, batch: int = 8,
                max_len: int | None = None,
                host_sync_interval: int = 8,
                sampler: SamplerConfig | None = None,
                quant: str | None = None,
                metric_hook=None, telemetry=None, xprof=None,
                reqtrace=None, mesh=None, mode: str | None = None,
                device: str | torch.device | None = None,
                **paged_kwargs):
    """Engine factory honoring GROVE_ENGINE. ``mode="lanes"`` builds the
    lanes ``DecodeEngine``; the paged engine (the default mode) is not
    ported yet and raises. Paged-only knobs in ``paged_kwargs`` are ignored
    by the lanes engine, as in the JAX package."""
    mode = mode or engine_mode()
    if mode == "paged":
        raise NotImplementedError(
            "the paged engine (GROVE_ENGINE=paged) is not ported yet: see "
            "ROADMAP.md, queue 1, item 1 (the paged engine); use "
            "mode='lanes'")
    if mode != "lanes":
        raise ValueError(f"unknown engine mode {mode!r}")
    if mesh is not None:
        raise NotImplementedError("tensor parallelism is not ported yet")
    return DecodeEngine(cfg, key_or_params, batch=batch, max_len=max_len,
                        host_sync_interval=host_sync_interval,
                        sampler=sampler, quant=quant,
                        metric_hook=metric_hook, telemetry=telemetry,
                        xprof=xprof, reqtrace=reqtrace, device=device)
