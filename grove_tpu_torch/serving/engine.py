"""Serving engines: continuous batching over a paged KV cache (the default),
continuous-batching decode over fixed lanes, and the lanes engine's prefill
worker.

- ``PagedDecodeEngine`` (``GROVE_ENGINE=paged``, the default): fixed-size
  KV blocks with per-request block tables (serving/kvcache.py), int8 or
  model-dtype pools, chunked prefill interleaved with decode, recompute
  preemption, and the prefix cache with copy-on-write
  (serving/schedule.py); greedy or sampled decoding; speculative greedy
  decoding (``GROVE_SPEC_DECODE=1``: a self-draft or a tiny draft model);
  one CUDA graph per (batch, table width) decode or spec bucket and one
  per prefill-chunk width, where the JAX package compiles one ``jax.jit``
  per bucket;
- ``DecodeEngine`` (``GROVE_ENGINE=lanes``): fixed decode batch lanes;
  inactive lanes compute too, so every step has the same shapes; prefill
  and decode are separate calls so that they can run in separate pods:
  ``PrefillWorker`` returns the per-sequence KV slab (one-shot or chunked
  prefill) and ``DecodeEngine.insert`` splices it into a free lane; one
  CUDA graph for the single decode step and one for a window of
  ``host_sync_interval`` steps, where the JAX package compiles ``step``
  and ``step_block`` (and their sampled twins);
- ``DisaggServing`` (``GROVE_DISAGG=1``): a ``PrefillEngine`` (chunked
  prefill over its own block pool) hands each finished prompt to a
  ``PagedDecodeEngine`` through the block handoff (serving/handoff.py):
  the decode tier adopts fresh blocks and copies the prompt's K/V across
  pools in one device copy per request;
- KV caches are updated in place (the JAX package donates them);
- every dispatch, warmup and capture runs under ``torch.no_grad()``: the
  hand-written kernels have no backward and refuse inputs that require
  grad, and params straight from a train step do (serving/checkpoint.py
  says how weights reach a live engine);
- sampled tokens accumulate on the device and reach the host once per
  window of ``host_sync_interval`` steps; ``step`` itself never waits for
  the device;
- a queue-depth metric hook feeds the control plane's autoscaler;
- the observatories, on by default as in the JAX package: ``telemetry``
  (serving/slo.py ``EngineTelemetry``: TTFT/TPOT/queue-wait histograms),
  ``xprof`` (serving/xprof.py ``Observatory``: builds, sampled device
  time, memory; ``GROVE_XPROF=0`` or ``False`` switches it off) and
  ``reqtrace`` (serving/reqtrace.py ``RequestObservatory``: per-request
  spans; ``GROVE_REQTRACE=0`` or ``False``). Sampled dispatches are timed
  by CUDA events around the replay, read only after a fetch the engine
  makes anyway (``_drain``, ``_finish_prefill``, ``sync``), so timing
  adds no device sync.

Tensor parallelism (``mesh=``, parallel/mesh.py): the paged engine, spec
and the disaggregated pair run as one rank of a tp group, each process
driving its own engine over its rank's weight slices and n_kv / tp heads
of the pools, with the model's collectives inside the captured graphs
(models/llama.py ``tp=``). Every rank runs the same host schedule, so
every rank runs the same collectives in the same order: nothing that
decides what to dispatch reads a clock or a rank-local state (the
scheduler, preemption and the prefix cache are deterministic in the
traffic; the observatories time and count but dispatch nothing). The
lanes engine runs on one device and ignores ``mesh``, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
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
from grove_tpu_torch.ops.kvquant import (paged_rope_scatter,
                                         paged_rope_scatter_q)
from grove_tpu_torch.ops.norms import add_rms_norm, rms_norm
from grove_tpu_torch.ops.paged import (paged_chunk_attention,
                                       paged_chunk_attention_q8,
                                       paged_decode_attention,
                                       paged_decode_attention_q8)
from grove_tpu_torch.ops.w8a16 import dense_matmul, w8a16_matmul
from grove_tpu_torch.parallel import sharding as shardlib
from grove_tpu_torch.parallel.mesh import single_device_mesh
from grove_tpu_torch.serving import reqtrace as reqtrace_mod
from grove_tpu_torch.serving import xprof as xprof_mod
from grove_tpu_torch.serving.handoff import HandoffPayload
from grove_tpu_torch.serving.kvcache import (NULL_BLOCK, BlockAllocator,
                                             PagedKV, PrefixTree, SeqBlocks,
                                             pad_tables)
from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
from grove_tpu_torch.serving.quant import QTensor
from grove_tpu_torch.serving.schedule import (PagedScheduler, PagedSeq,
                                              pick_bucket)


# The hand-written kernels a captured decode step or prefill chunk
# launches, by wrapper.
_KERNEL_WRAPPERS = (paged_decode_attention, paged_chunk_attention,
                    paged_decode_attention_q8, paged_chunk_attention_q8,
                    paged_rope_scatter_q, paged_rope_scatter, w8a16_matmul,
                    dense_matmul, rms_norm, add_rms_norm)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Token sampling: temperature 0 = greedy argmax; otherwise a
    temperature-scaled categorical over the top_k logits (0 = full vocab),
    drawn from a ``torch.Generator`` seeded with ``seed`` (its draws are
    not ``jax.random``'s: the same seed gives other tokens than the JAX
    package's).
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
        return llama.greedy_tokens(logits)
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


class _Observed:
    """The observatories' engine-side half, shared by both engines.

    ``xprof`` and ``reqtrace`` follow the JAX package's contract: an
    instance (the caller names the scope), None (one is made unless
    GROVE_XPROF=0 / GROVE_REQTRACE=0), or False (off); off means the
    attribute is None and every hook site skips. ``telemetry`` is an
    ``EngineTelemetry`` or None. Sampled dispatches go through ``_tic`` /
    ``_toc``: the engine's ``DeviceTimer`` brackets the dispatch (CUDA
    events around the replay on the card, host wall around the eager call
    on the CPU) and its callbacks run in ``_resolve_timings``, which only
    the fetches call."""

    xprof = None
    reqtrace = None

    def _init_observatories(self, telemetry, xprof, reqtrace) -> None:
        self.telemetry = telemetry
        if xprof is not False:
            if xprof is not None:
                xprof.cfg, xprof.batch = self.cfg, self.batch
                xprof.max_len = self.max_len
            elif xprof_mod.enabled():
                xprof = xprof_mod.Observatory(cfg=self.cfg, batch=self.batch,
                                              max_len=self.max_len)
            else:
                xprof = None
        self.xprof = xprof or None
        if reqtrace is not False and reqtrace is None \
                and reqtrace_mod.enabled():
            reqtrace = reqtrace_mod.RequestObservatory()
        self.reqtrace = reqtrace or None
        # Pending timings are bounded by the sampling cadence times the
        # drain window: past that (no fetch for that long) the oldest drop.
        every = self.xprof.recorder.sample_every if self.xprof else 16
        self._timer = xprof_mod.DeviceTimer(
            self.device, capacity=max(64, every * self.host_sync_interval))
        if self.xprof is not None:
            self.xprof.device = self.device
            self.xprof.timer = self._timer

    def _note_build(self, name: str, seconds: float,
                    sig: tuple = ("build",), also: tuple = ()) -> None:
        """An executable was built: a graph captured, an eager step or copy
        called for the first time. ``also`` names builds that happened
        inside the same one (the tiny draft's chunk inside the target's)."""
        if self.xprof is not None:
            self.xprof.compile.note_build(name, seconds, sig)
            for other in also:
                self.xprof.compile.note_build(other, 0.0)

    def _tracked(self, name: str, fn: Callable, install: Callable,
                 also: tuple = ()) -> Callable:
        """``fn`` whose first call is a build of ``name``: the wrapper
        times that call, notes it and installs ``fn`` itself (through
        ``install``) for every later call."""
        if self.xprof is None:
            return fn

        def first(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            install(fn)
            self._note_build(name, time.perf_counter() - t0, also=also)
            return out

        return first

    def _tic(self):
        """Open the timing bracket of a sampled dispatch."""
        if self.xprof is not None:
            self.xprof.compile.last_call_compiled = False
        return self._timer.start()

    def _toc(self, mark, phase: str | None, steps: int = 1, tokens: int = 0,
             then: Callable[[float], None] | None = None) -> None:
        """Close the bracket: when its time is known, ``phase`` (if any)
        goes into the flight recorder, unless the dispatch built an
        executable (its time is the build's), and ``then(seconds)`` runs."""
        x = self.xprof
        built = x is not None and x.compile.last_call_compiled

        def done(seconds: float) -> None:
            if phase is not None and not built:
                x.record(phase, seconds, steps=steps, tokens=tokens)
            if then is not None:
                then(seconds)

        self._timer.stop(mark, done)

    def _resolve_timings(self) -> None:
        """Read the queued device timings. Called only right after a fetch
        that waited for the stream."""
        self._timer.resolve()


class _Graphed(_Observed):
    """The capture shared by both engines: on the card each dispatch of a
    signature is one CUDA graph, captured at its first use (or at
    ``warmup``) and replayed after; ``graphs_captured`` counts captures,
    ``capture_seconds`` and ``capture_bytes`` their host wall and the
    memory their pool reserved. Each engine names the static buffers its
    graphs read and advance (``_state_bufs``) and its tp group (``_tp``,
    None without one)."""

    _tp = None

    def _init_graphs(self) -> None:
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self.graphs_captured = 0
        self.capture_seconds = 0.0
        self.capture_bytes = 0

    @torch.no_grad()
    def _capture(self, step: Callable[[], torch.Tensor | None]
                 ) -> Callable[[], torch.Tensor | None]:
        """Capture ``step`` into a CUDA graph; returns its replay, which
        returns what the captured call returned (a static tensor of the
        graph's pool, or None).

        The step runs once eagerly on a side stream first (torch's
        documented warm-up), so the kernel library's load, its function
        attributes and every lazily built table happen outside the
        capture. That run reads the live static buffers and writes the
        next K/V rows (of the pools, or of the lanes) with the values the
        next real step writes again; the engine's static buffers
        (``_state_bufs``: tokens, lengths and the like) are restored before
        the capture. All graphs share one memory pool: no tensor
        allocated inside a capture outlives it, but the returned one. A
        sampling engine registers its generator with the graph, so each
        replay takes fresh random numbers.

        Kernel launch counts follow the device: the wrappers' counts taken
        while capturing (when nothing launches) move to the replay, which
        adds them each time it launches the graph's kernels; so does the tp
        group's count of collectives. The warm-up run launches the group's
        first collectives, which create NCCL's communicator: never under
        capture."""
        dev = self.device
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        state = self._state_bufs()
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, keep in zip(state, saved):
            t.copy_(keep)
        graph = torch.cuda.CUDAGraph()
        if self._sampling:
            graph.register_generator_state(self._gen)
        counters = _KERNEL_WRAPPERS + (
            (self._tp,) if self._tp is not None else ())
        counts = [w.launches for w in counters]
        with torch.cuda.graph(graph, pool=self._graph_pool):
            out = step()
        per_replay = []
        for w, n in zip(counters, counts):
            if w.launches != n:
                per_replay.append((w, w.launches - n))
                w.launches = n
        torch.cuda.empty_cache()
        self.graphs_captured += 1
        self.capture_seconds += time.perf_counter() - t0
        self.capture_bytes += torch.cuda.memory_reserved(dev) - reserved

        def replay() -> torch.Tensor | None:
            graph.replay()
            for w, n in per_replay:
                w.launches += n
            return out

        return replay


def _quantized(params, quant: str | None):
    """The engine's params: ``params`` itself (the caller's tensors), or
    their int8 quantization (new tensors, made with no autograd graph)."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    if quant == "int8":
        from grove_tpu_torch.serving.quant import quantize_params
        with torch.no_grad():
            return quantize_params(params)
    return params


def _on_device(params, device: torch.device):
    """``params`` with every leaf on ``device``: the tree itself where every
    leaf is there already (an engine keeps the caller's tensors), else a
    tree of the same kind whose leaves were moved one by one."""
    moved = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            moved[name] = _on_device(leaf, device)
        elif isinstance(leaf, QTensor):
            q, scale = leaf.q.to(device), leaf.scale.to(device)
            moved[name] = (leaf if q is leaf.q and scale is leaf.scale
                           else QTensor(q=q, scale=scale))
        else:
            moved[name] = leaf.to(device)
    if all(moved[k] is params[k] for k in params):
        return params
    if isinstance(params, shardlib.ShardedParams):
        out = shardlib.ShardedParams(moved)
        out.layout, out.shapes = params.layout, params.shapes
        return out
    return moved


def _sharded(mesh, params, quant: str | None, device: torch.device):
    """The engine's params on ``mesh``, on ``device``: ``_quantized`` (the
    whole tree, so that a scale over an axis tp splits is the amax over all
    of it), then this rank's slices under tp > 1 (parallel/sharding.py),
    both where the caller's params are; only then are the leaves moved to
    ``device``. So a model larger than one card is passed in host memory,
    and each card receives its rank's slices alone. A tree that
    ``shard_params`` made already is taken as it is, if it was cut for this
    rank of this plan."""
    if isinstance(params, shardlib.ShardedParams):
        if params.layout != (mesh.plan, mesh.rank):
            raise ValueError(f"params sharded for {params.layout}, not for "
                             f"rank {mesh.rank} of {mesh.plan}")
        return _on_device(params, device)
    params = _quantized(params, quant)
    if mesh.shape["tp"] > 1:
        params = shardlib.shard_params(mesh, params)
    return _on_device(params, device)


def _tp_comm(mesh, device: torch.device):
    """The mesh's tp group, checked against the engine's device: NCCL for
    CUDA tensors, gloo for CPU ones, and none only on a mesh without a
    group at tp = 1. Never a quiet tp = 1 in place of a missing group."""
    comm = mesh.comm("tp")
    if comm is None:
        if mesh.shape["tp"] > 1:
            raise ValueError(f"a mesh with tp={mesh.shape['tp']} needs its "
                             "process group (parallel/mesh.py build_mesh)")
        return None
    want = "nccl" if device.type == "cuda" else "gloo"
    if comm.backend != want:
        raise ValueError(f"the tp group's backend is {comm.backend}, but "
                         f"{device.type} tensors need {want}")
    return comm


class PrefillWorker:
    """The prefill side of the lanes engine's disaggregated serving: one-shot
    prefill by default, or chunked (``prefill_chunk``: windows of that many
    positions, ``llama.prefill_chunked``), which bounds the attention working
    set of long prompts."""

    def __init__(self, cfg: LlamaConfig, params, batch: int = 1,
                 max_prompt: int | None = None,
                 sampler: SamplerConfig | None = None,
                 quant: str | None = None,
                 prefill_chunk: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _quantized(params, quant)
        self.batch = batch
        self.max_prompt = max_prompt or cfg.max_seq_len
        if prefill_chunk and self.max_prompt % prefill_chunk:
            raise ValueError(f"max_prompt {self.max_prompt} does not divide "
                             f"into chunks of {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.sampler = sampler or SamplerConfig()
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.sampler.seed)
        self._cache = KVCache.create(cfg.n_layers, batch, self.max_prompt,
                                     cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                     self.device)
        # One-shot prefill's executables, by shape (the JAX worker's jit
        # cache): a call of a new shape is a build, which an engine's
        # observatory notes as ``worker_prefill``. The chunked path calls
        # the model functions directly, as the JAX worker does.
        self._shapes: set[tuple[int, int]] = set()
        self.builds = 0

    def idle(self) -> bool:
        """Always: each ``prefill`` hands its sequences' KV to its results."""
        return True

    def reset_prefix_cache(self) -> int:
        """No prefix cache here: nothing to drop."""
        return 0

    @torch.no_grad()
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
        toks_dev = torch.from_numpy(toks).to(self.device)
        lengths_dev = torch.from_numpy(lengths).to(self.device)
        if self.prefill_chunk:
            logits, cache = llama.prefill_chunked(
                self.cfg, self.params, toks_dev, self._cache,
                chunk=self.prefill_chunk, lengths=lengths_dev)
        else:
            if toks.shape not in self._shapes:
                self._shapes.add(toks.shape)
                self.builds += 1
            logits, cache = llama.prefill(self.cfg, self.params, toks_dev,
                                          self._cache, lengths_dev)
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


class DecodeEngine(_Graphed):
    """Continuous-batching decode over fixed lanes.

    Two operating modes:
    - standalone: ``admit_prompts`` prefills in-engine (single-pod serving,
      also the bench path);
    - disaggregated: ``insert`` splices a PrefillResult produced elsewhere.

    The decode is the JAX package's four executables: ``step`` /
    ``step_sampled`` (one step) and ``step_block`` / ``step_block_sampled``
    (``run``'s windows of K = ``host_sync_interval`` steps, a ``lax.scan``
    there). On the card each is one CUDA graph per (batch, max_len,
    sampled), captured at its first dispatch (the capture is the build, as
    a jit's first call is) or by ``warmup``. The graphs hold their buffers
    by address: the step reads and advances the token buffer ``_tokens``
    and the cache's length buffer ``cache.lengths``, and the block also
    writes each step's tokens into the window buffer ``_window`` [K,
    batch]. So everything that changes the lanes between dispatches writes
    those buffers in place (``admit_prompts``, ``insert``,
    ``release_lane``, the drain), and what outlives a replay is copied on
    the device first (each pending step's tokens, each block's window). On
    the CPU the same functions run eagerly. The prefill stays eager on both
    (device-bound, through the flash kernel): the first call of each prompt
    shape is its build, and a worker's one-shot prefill of a new shape is
    an external ``worker_prefill`` build.
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
        # The block's tokens, one row per step (overwritten at each replay).
        self._window = torch.zeros((self.host_sync_interval, batch),
                                   dtype=torch.int32, device=self.device)
        # "step" and "block": a captured graph's replay on the card, the
        # eager function on the CPU.
        self._graphs: dict[str, Callable[[], None]] = {}
        self._init_graphs()
        self._init_observatories(telemetry, xprof, reqtrace)
        suffix = "_sampled" if self._sampling else ""
        self._step_name = "step" + suffix
        self._block_name = "step_block" + suffix
        self._phase = "sample" if self._sampling else "step"
        self._lanes_sig = (batch, self.max_len)

    @property
    def sampler(self) -> SamplerConfig:
        return self._sampler

    def idle(self) -> bool:
        """No lane holds a sequence (whose KV the current weights wrote)."""
        return not self._active.any()

    def reset_prefix_cache(self) -> int:
        """No prefix cache here: nothing to drop."""
        return 0

    # ---- the model calls ----

    def _state_bufs(self) -> tuple[torch.Tensor, ...]:
        """The static buffers the decode graphs read and advance."""
        return (self._tokens, self.cache.lengths, self._window)

    def _choose(self, logits: torch.Tensor) -> torch.Tensor:
        if self._sampling:
            return sample_tokens(logits, self._gen, self._sampler)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _keep_lengths(self, call: Callable) -> torch.Tensor:
        """``call(cache)``, a model function returning (logits, cache) with
        the cache's lengths rebound (``llama.prefill``, ``decode_step``);
        the new lengths are copied into the engine's own length buffer,
        which the graphs hold, and the cache keeps that buffer. Returns the
        logits."""
        lengths = self.cache.lengths
        logits, cache = call(self.cache)
        lengths.copy_(cache.lengths)
        cache.lengths = lengths
        return logits

    def _decode(self) -> None:
        """One decode step on the device: the cache advanced in place and
        the next tokens written into ``_tokens``."""
        logits = self._keep_lengths(functools.partial(
            llama.decode_step, self.cfg, self.params, self._tokens))
        self._tokens.copy_(self._choose(logits))

    def _block(self) -> None:
        """K decode steps, each step's tokens into its row of ``_window``."""
        for j in range(self.host_sync_interval):
            self._decode()
            self._window[j].copy_(self._tokens)

    def _dispatch(self, kind: str) -> None:
        """Run ``kind`` ("step" or "block"): on the card its graph's replay,
        the graph captured at the first call; on the CPU the eager
        function."""
        fn = self._graphs.get(kind)
        if fn is None:
            fn = self._decode if kind == "step" else self._block
            if self.device.type == "cuda":
                fn = self._capture(fn)
            self._graphs[kind] = fn
        fn()

    def _launch(self, kind: str, name: str, steps: int,
                sampled: bool | None = None) -> None:
        """``_dispatch(kind)`` under the observatory: its first call is the
        build of ``name``; a sampled call (``sampled`` None: the recorder's
        cadence decides) is timed."""
        x = self.xprof
        if x is None:
            self._dispatch(kind)
            return
        if sampled is None:
            sampled = x.should_sample()
        self._observed(name, self._lanes_sig, sampled,
                       functools.partial(self._dispatch, kind), self._phase,
                       steps=steps, tokens=steps * self.batch)

    @torch.no_grad()
    def warmup(self) -> int:
        """Build the single step and the K-step block before traffic (on the
        card, capture both graphs) and run each once over the lanes as they
        stand; the token, length and window buffers are restored, so the
        lanes are as they were (K/V rows past each lane's length are
        written, which the next steps write again). Returns the number
        built."""
        saved = [t.clone() for t in self._state_bufs()]
        built = 0
        for kind, name, steps in (
                ("step", self._step_name, 1),
                ("block", self._block_name, self.host_sync_interval)):
            built += kind not in self._graphs
            self._launch(kind, name, steps, sampled=False)
        for t, keep in zip(self._state_bufs(), saved):
            t.copy_(keep)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return built

    def _observed(self, name: str, sig: tuple, sampled: bool, fn: Callable,
                  phase: str, steps: int = 1, tokens: int = 0):
        """Dispatch ``fn()`` under the observatory: its first call under
        ``sig`` is the build of ``name`` (noted, and its time kept out of
        the ring); a ``sampled`` call is timed into ``phase``."""
        build = not self.xprof.compile.seen(name, sig)
        if build:
            t0 = time.perf_counter()
        if sampled:
            mark = self._tic()
        out = fn()
        if build:
            self._note_build(name, time.perf_counter() - t0, sig)
        if sampled:
            self._toc(mark, phase, steps=steps, tokens=tokens)
        return out

    # ---- request intake ----

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, enqueue_ts=time.time())
        self._next_rid += 1
        self._queue.append(req)
        rt = self.reqtrace
        if rt is not None:
            rt.note_enqueue(req.rid, ts=req.enqueue_ts,
                            prompt_len=len(req.prompt),
                            max_new_tokens=max_new_tokens)
        # No memory snapshot here: on the card it queries the device (1-5
        # ms under load on an H100), time that would land between the
        # request's enqueue stamp and the caller's; the next drain takes
        # it.
        self._report_metric(memory=False)
        return req.rid

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def kv_lane_utilization(self) -> float:
        """Fraction of decode lanes occupied (1.0 = no free lane)."""
        return float(np.count_nonzero(self._active)) / self.batch

    def _report_metric(self, memory: bool = True) -> None:
        """Refresh the gauges; ``memory=False`` leaves out the (rate-limited)
        memory snapshot, as ``submit`` does (see there)."""
        if self.metric_hook is not None:
            self.metric_hook(len(self._queue))
        if self.telemetry is not None:
            self.telemetry.sample_gauges(len(self._queue),
                                         self.kv_lane_utilization)
            if self.reqtrace is not None and self.reqtrace.finished_total:
                self.telemetry.sample_phases(self.reqtrace.phase_stats())
        if self.xprof is not None and memory:
            self.xprof.observe_memory(self, self.telemetry)

    def _stamp_admit(self, req: Request, now: float,
                     admit: float | None = None) -> None:
        """``now``: the first token exists (post-prefill); ``admit``: the
        request left the queue (pre-prefill)."""
        _stamp_admit_impl(req, now, admit, self._ttft_compat, self.telemetry)
        if self.reqtrace is not None:
            self.reqtrace.note_admit(req.rid, ts=req.admit_ts)

    def _complete(self, req: Request) -> None:
        _complete_impl(req, self.completed, self.telemetry)
        if self.reqtrace is not None:
            self.reqtrace.note_done(req.rid, ts=req.done_ts)

    # ---- standalone mode (bench path) ----

    @torch.no_grad()
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

        def prefill() -> None:
            logits = self._keep_lengths(functools.partial(
                llama.prefill, self.cfg, self.params, prompts,
                lengths=lengths))
            self._tokens.copy_(self._choose(logits))

        if self.xprof is None:
            prefill()
        else:
            # Every in-engine prefill is timed (the flash path's device
            # time); the first of a prompt shape is its build.
            self._observed("prefill", (b, s), True, prefill, "prefill",
                           tokens=b)
        self._active[:] = True
        if max_new_tokens is not None:
            prompts_np = prompts.cpu().numpy()
            lengths_np = lengths.cpu().numpy()
            first = self._tokens.cpu().numpy()
            self._resolve_timings()
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

    @torch.no_grad()
    def insert(self, lane: int, result: PrefillResult,
               request: Request | None = None) -> None:
        """Splice a prefilled sequence into a free lane (KV handoff)."""
        if self._active[lane]:
            raise ValueError(f"lane {lane} busy")
        s = result.k.shape[1]
        self.cache.k[:, lane, :s] = result.k.to(self.cache.k.dtype)
        self.cache.v[:, lane, :s] = result.v.to(self.cache.v.dtype)
        self.cache.lengths[lane] = result.length
        self._tokens[lane] = result.next_token  # pending steps hold copies
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
            rt = self.reqtrace
            if rt is not None:
                # The lane insert is the prefill -> decode splice: the
                # worker's prefill ran between queue exit and here.
                rt.note_prefill_done(request.rid)
                rt.note_decode_start(request.rid)

    @torch.no_grad()
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
            x = self.xprof
            if x is not None:
                # The worker's builds are not this engine's: a call that
                # built one is noted as an external build and kept out of
                # the device-time ring. The bracket is read at the next
                # drain (the worker copies its slabs after its fetch).
                builds = getattr(prefiller, "builds", None)
                t0 = time.perf_counter()
                mark = self._timer.start()
            results = prefiller.prefill([r.prompt for r in reqs])
            if x is not None:
                if builds is not None and prefiller.builds != builds:
                    x.compile.note_external_compile(
                        "worker_prefill", time.perf_counter() - t0)
                    self._timer.stop(mark, lambda seconds: None)
                else:
                    self._timer.stop(mark, functools.partial(
                        x.recorder.record, "prefill", tokens=take))
            for req, res in zip(reqs, results):
                self.insert(lanes.pop(0), res, req)
                admitted += 1
        self._report_metric()
        return admitted

    # ---- decode ----

    @torch.no_grad()
    def step(self) -> None:
        """One decode step across all lanes (inactive lanes compute too).
        Launches device work only: no host fetch unless a window of
        tracked tokens is full."""
        self._launch("step", self._step_name, 1)
        self.steps += 1
        if any(r is not None for r in self._requests):
            # The next step overwrites ``_tokens``: keep a device copy.
            self._pending_tokens.append(self._tokens.clone())
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
        x = self.xprof
        if x is not None:
            t0 = time.perf_counter()
        toks = torch.stack(self._pending_tokens).cpu().numpy()  # [w, batch]
        if x is not None:
            x.record("host_transfer", time.perf_counter() - t0)
        self._resolve_timings()
        self._pending_tokens.clear()
        self._process_window(toks, offsets=self._lane_window_start)
        self._lane_window_start[:] = 0

    def _process_window(self, toks: np.ndarray,
                        offsets: np.ndarray | None = None) -> None:
        """Completion bookkeeping over a [w, batch] token window.
        ``offsets[i]`` = rows belonging to lane i's previous occupant
        (single-step path; block windows never contain them)."""
        freed = False
        appended = 0
        for i, req in enumerate(self._requests):
            if req is None or not self._active[i]:
                continue
            start = int(offsets[i]) if offsets is not None else 0
            for t in toks[start:, i]:
                req.generated.append(int(t))
                appended += 1
                if len(req.generated) >= req.max_new_tokens:
                    break
            if len(req.generated) >= req.max_new_tokens or \
                    not self._lane_has_room(req, self.host_sync_interval):
                self._complete(req)
                self._requests[i] = None
                self._active[i] = False
                freed = True
                self.cache.lengths[i] = 0
        if self.telemetry is not None:
            self.telemetry.add_tokens(appended)
        if freed:
            self._report_metric()

    def sync(self) -> None:
        """Drain outstanding bookkeeping and wait for the device."""
        self._drain()
        self._tokens.cpu()
        self._resolve_timings()

    @torch.no_grad()
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
        x = self.xprof
        for _ in range(block_steps // K):
            self._launch("block", self._block_name, K)
            self.steps += K
            if tracked:
                # The next block overwrites ``_window``: keep a device copy.
                windows.append(self._window.clone())
        fetched = False
        if windows:
            # One fetch of every window ([w, batch] rows); it is also the
            # sync for the block phase.
            if x is not None:
                t0 = time.perf_counter()
            toks = torch.cat(windows).cpu().numpy()
            if x is not None:
                x.record("host_transfer", time.perf_counter() - t0)
            self._resolve_timings()
            self._process_window(toks)
            fetched = True
        for _ in range(steps):
            self.step()
        if steps or not fetched:
            self.sync()


class PagedDecodeEngine(_Graphed):
    """Continuous-batching decode over a paged KV cache.

    The port of the JAX package's default engine (``GROVE_ENGINE=paged``):

    - **Paged KV** (serving/kvcache.py): fixed-size blocks and per-request
      block tables, so effective batch is bounded by tokens in flight, and
      decode attention reads the bucketed live width. The pool holds the
      model's dtype, or int8 rows with per-(slot, head) f32 scales
      (``kv_quant="int8"`` or ``GROVE_KV_QUANT=int8``: half the bytes of
      bf16; the write quantizes, attention dequantizes as it reads).
    - **Continuous batching** (serving/schedule.py): requests join and
      leave the decode batch at any step. Decode shapes come off fixed
      power-of-two bucket ladders, so the set of decode steps is finite.
    - **One CUDA graph per decode bucket.** On the card, ``_get_step(B,
      W)`` captures ``decode_step_paged`` + the token choice + ``lengths
      += 1`` once per (batch, width) bucket; the graph reads and writes
      static token, length and table buffers and the pools in place, and a
      replay costs one launch. ``warmup`` captures over the null block
      before traffic, and ``graphs_captured`` counts captures. On the CPU
      the same dict holds the eager step functions. A capture that fails
      raises.
    - **Sampling** (``sampler.temperature > 0``): the step draws with
      ``sample_tokens`` (Gumbel-max over the top-k) from the engine's own
      generator, seeded with ``sampler.seed`` and registered with every
      captured graph, so each replay advances its counter and draws fresh
      noise; the first token of a prompt is drawn from the same generator.
      The draws are not ``jax.random``'s.
    - **Chunked prefill**: prompts advance one fixed chunk per engine
      tick, interleaved with decode. ``_get_prefill(W)`` captures one
      ``prefill_chunk_paged`` per table-width bucket (the JAX package's
      per-width executables): static chunk tokens, table, offset, logit
      row and valid count go up in one pinned upload per tick, and a
      chunk that does not complete its prompt fetches nothing.
    - **Speculative decoding** (``spec_decode=True`` or
      ``GROVE_SPEC_DECODE=1``; ``spec_k`` or ``GROVE_SPEC_K``, default 3):
      each decode dispatch drafts ``spec_k`` tokens, verifies them in one
      (spec_k + 1)-wide target chunk and commits the longest agreeing
      prefix plus a bonus token (``llama.spec_step_paged``): greedy only,
      and bitwise the tokens of the plain engine. ``draft_params`` None
      derives a tiny draft (``llama.draft_config``, random weights from a
      generator seeded with ``sampler.seed + 1``) with its own model-dtype
      pool, which each prefill chunk's graph fills too; ``"self"`` drafts
      with the target over its own pool; a ``(cfg, params)`` pair is a
      given draft. ``_get_spec(B, W)`` captures one graph per bucket that
      reads the static tokens, lengths, tables and per-row ``limit`` (the
      write cap, uploaded with the tables) and writes a static
      [batch, spec_k + 1] out-token buffer; the committed counts stay on
      the device until the window drains (``spec_stats``).
    - **Handoff consumer** (``GROVE_DISAGG=1``, the decode tier of
      ``DisaggServing``): ``adopt`` takes a ``HandoffPayload`` from a
      ``PrefillEngine``, grants fresh blocks for its cold suffix and copies
      them from the producer's pool into this one in place
      (``llama.paged_block_copy``/``_q`` over two id vectors of the fixed
      width ``max_blocks_per_seq``, one upload and one copy per request);
      the sequence joins the decode batch directly.
    - **Tensor parallelism** (``mesh=``, parallel/mesh.py): this process is
      one rank of the mesh's tp group. The params are quantized whole, then
      cut to the rank's slices (parallel/sharding.py ``shard_params``); the
      pools, and a tiny draft's, hold n_kv / tp heads; the model functions
      run the group's collectives (models/llama.py ``tp=``), captured in
      every graph, and every rank computes the full logits, so all ranks
      choose the same tokens. ``n_kv_heads`` (and a tiny draft's) must
      divide over tp. Without ``mesh`` (or with ``single_device_mesh()``)
      no collective runs.
    - **Observatories** (``_Observed``): every graph capture (or, on the
      CPU, an eager step's first call) is a build under the JAX package's
      executable name: ``paged_step{_sampled}{_q8}[b{B},w{W}]``,
      ``paged_prefill{_q8}[c{C},w{W}]``, ``paged_spec{_q8}[b{B},w{W},k{K}]``,
      ``draft_prefill[c{C},w{W}]`` (inside the chunk's graph),
      ``paged_handoff_copy`` and ``paged_cow_copy`` (run once over the null
      block at construction with the prefix cache on, as JAX prebuilds it).

    Host discipline: the per-step dispatch path performs no device sync.
    Sampled tokens stay on the device; bookkeeping drains once per
    ``host_sync_interval`` window or at a composition change, whichever
    comes first.
    """

    def __init__(self, cfg: LlamaConfig, key_or_params, batch: int = 8,
                 max_len: int | None = None,
                 block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 metric_hook: Callable[[int], None] | None = None,
                 host_sync_interval: int = 8,
                 sampler: SamplerConfig | None = None,
                 quant: str | None = None,
                 telemetry=None,
                 xprof=None,
                 reqtrace=None,
                 mesh=None,
                 prefix_cache: bool | None = None,
                 spec_decode: bool | None = None,
                 spec_k: int | None = None,
                 draft_params=None,
                 kv_quant: str | None = None,
                 device: str | torch.device | None = None):
        if spec_decode is None:
            spec_decode = os.environ.get("GROVE_SPEC_DECODE", "0") == "1"
        self.spec_decode = bool(spec_decode)
        if spec_k is None:
            spec_k = int(os.environ.get("GROVE_SPEC_K", "3"))
        self.spec_k = max(1, int(spec_k))
        self._sampler = sampler or SamplerConfig()
        self._sampling = self._sampler.temperature > 0.0
        # Acceptance is an argmax-agreement test: under sampling there is
        # no one token to agree with, so the combination is refused.
        if self.spec_decode and self._sampling:
            raise ValueError("speculative decoding is greedy-only "
                             "(temperature must be 0)")
        if kv_quant is None:
            kv_quant = os.environ.get("GROVE_KV_QUANT", "off")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else single_device_mesh()
        self._tp = _tp_comm(self.mesh, self.device)
        tp = self.mesh.shape["tp"]
        if cfg.n_kv_heads % tp:
            raise ValueError(f"n_kv_heads {cfg.n_kv_heads} must divide over "
                             f"tp={tp}")
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._sampler.seed)
        if isinstance(key_or_params, torch.Generator):
            # On the generator's device: a host generator makes the model
            # in host memory, and the card receives the rank's slices.
            key_or_params = llama.init_params(cfg, key_or_params,
                                              key_or_params.device)
        self.params = _sharded(self.mesh, key_or_params, quant, self.device)
        self.quant = quant
        # The draft: none (spec off), the target itself ("self"), a derived
        # tiny draft (None) or a given (cfg, params) pair.
        self._draft_cfg = self._draft_params = None
        if self.spec_decode:
            if draft_params is None:
                self._draft_cfg = llama.draft_config(cfg)
                dgen = torch.Generator(device=self.device).manual_seed(
                    self._sampler.seed + 1)
                self._draft_params = llama.init_params(
                    self._draft_cfg, dgen, self.device)
            elif isinstance(draft_params, str) and draft_params == "self":
                self._draft_cfg, self._draft_params = cfg, self.params
            else:
                self._draft_cfg, self._draft_params = draft_params
        self._self_draft = (self.spec_decode
                            and self._draft_params is self.params)
        if self.spec_decode and not self._self_draft:
            # The draft shards like the target: its pool holds its n_kv / tp
            # heads (a self-draft drafts over the target's pool).
            if self._draft_cfg.n_kv_heads % tp:
                raise ValueError(f"draft n_kv_heads "
                                 f"{self._draft_cfg.n_kv_heads} must divide "
                                 f"over tp={tp}")
            self._draft_params = _sharded(self.mesh, self._draft_params,
                                          None, self.device)
        self._spec_stats = {"draft_tokens": 0, "accepted_tokens": 0,
                            "committed_tokens": 0, "dispatches": 0,
                            "rows": 0, "per_bucket": {}}
        self.batch = batch          # max decode slots
        self.max_len = max_len or cfg.max_seq_len
        self.metric_hook = metric_hook
        self.host_sync_interval = max(1, host_sync_interval)
        self._ttft_compat = os.environ.get("GROVE_TTFT_COMPAT", "0") == "1"

        # Block geometry: 16-token blocks (GROVE_PAGED_BLOCK overrides) and
        # a pool sized to the lanes engine's worst case (batch x max_len),
        # so the default shape never has less capacity than the lanes
        # engine; deployments shrink num_blocks to bank the memory.
        if block_size is None:
            block_size = int(os.environ.get("GROVE_PAGED_BLOCK", 16))
        block_size = max(1, min(block_size, self.max_len))
        self.block_size = block_size
        self.max_blocks_per_seq = -(-self.max_len // block_size)
        if num_blocks is None:
            num_blocks = batch * self.max_blocks_per_seq + 1  # + null
        # The pool must fit at least one full sequence, or a lone
        # max-length request could never be served.
        if num_blocks - 1 < self.max_blocks_per_seq:
            raise ValueError(f"{num_blocks} blocks cannot hold one "
                             f"{self.max_len}-token sequence")
        self.kv_quant = kv_quant
        # Each rank's pools hold its n_kv / tp heads (and their scales).
        self.kv = PagedKV.create(cfg.n_layers, num_blocks, block_size,
                                 cfg.n_kv_heads // tp, cfg.head_dim,
                                 cfg.dtype, quant=kv_quant,
                                 device=self.device)
        self._alloc = BlockAllocator(num_blocks, block_size)
        # A tiny draft keeps its own pool (never quantized: it is small, and
        # int8 would cost draft accuracy), addressed by the target's block
        # tables; a self-draft drafts over the target's pool.
        self.draft_kv = None
        if self.spec_decode and not self._self_draft:
            dcfg = self._draft_cfg
            self.draft_kv = PagedKV.create(dcfg.n_layers, num_blocks,
                                           block_size, dcfg.n_kv_heads // tp,
                                           dcfg.head_dim, cfg.dtype,
                                           device=self.device)
        if prefill_chunk is None:
            prefill_chunk = int(os.environ.get("GROVE_PAGED_CHUNK", 32))
        self.prefill_chunk = max(1, min(prefill_chunk, self.max_len))
        # Global prefix cache (GROVE_PREFIX_CACHE=0 switches it off). The
        # tokens are the same either way: cached KV is what a cold prefill
        # would have written.
        if prefix_cache is None:
            prefix_cache = os.environ.get("GROVE_PREFIX_CACHE", "1") != "0"
        self._prefix = PrefixTree(self._alloc) if prefix_cache else None
        from grove_tpu_torch.serving.quant import kv_block_bytes
        # What one block costs this rank's pools.
        self._block_bytes = kv_block_bytes(
            dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp),
            block_size, kv_quant)
        self.cow_copies = 0
        # The handoff copy (the decode tier of disaggregated serving) is
        # built on the first adoption or by ``warmup_handoff``; the stats
        # accumulate on this, the consuming side. ``seconds`` is host wall
        # time of the dispatch, without a sync.
        self._handoff: Callable[[PagedKV], None] | None = None
        self._handoff_ids: torch.Tensor | None = None
        self.handoff_stats = {"requests": 0, "blocks": 0,
                              "shared_blocks": 0, "bytes": 0,
                              "seconds": 0.0, "deferred": 0}
        self._sched = PagedScheduler(self._alloc, batch,
                                     self.max_blocks_per_seq,
                                     self.prefill_chunk,
                                     prefix_tree=self._prefix)

        # Static decode inputs, written in place between steps and read by
        # every step (and captured graph): tokens and lengths of slots
        # [0, B) are views of one buffer each, and each table width has
        # one [batch, W] buffer whose first B rows a step reads.
        self._tok_buf = torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device)
        self._len_buf = torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device)
        self._table_bufs: dict[int, torch.Tensor] = {}
        # Spec steps also read each row's write cap (0 for padded rows) and
        # write the committed tokens, -1 past them.
        self._limit_buf = torch.zeros((batch,), dtype=torch.int32,
                                      device=self.device)
        self._out_buf = torch.zeros((batch, self.spec_k + 1),
                                    dtype=torch.int32, device=self.device)
        # One step per (batch bucket, width bucket): a captured graph's
        # replay on the card, the eager step on the CPU. A spec engine
        # builds spec steps only.
        self._steps: dict[tuple[int, int], Callable[[], None]] = {}
        self._specs: dict[tuple[int, int], Callable[[], None]] = {}
        # Static prefill inputs, one int32 buffer uploaded once per chunk:
        # the chunk's c tokens, then offset, logit row and valid count,
        # then the table (its first W entries for width W). One chunk per
        # width bucket, a graph's replay or the eager chunk, each returning
        # the logits.
        self._pf_buf = torch.zeros(
            (self.prefill_chunk + 3 + max(self._sched.width_buckets),),
            dtype=torch.int32, device=self.device)
        self._prefills: dict[int, Callable[[], torch.Tensor]] = {}
        self._init_graphs()

        # Request flow state.
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self.completed: list[Request] = []
        self.steps = 0              # decode dispatches
        self.chunks = 0             # prefill-chunk dispatches
        self.ticks = 0              # engine ticks (prefill or decode)
        self._cur_shape: tuple[int, int] | None = None
        self._tables_sig: tuple = ()
        self._run_order: tuple = ()
        self._composition_dirty = True
        self._pending: list[tuple[torch.Tensor, tuple]] = []
        self._finishing: list = []

        self._init_observatories(telemetry, xprof, reqtrace)
        if self.xprof is not None:
            # The roofline's KV byte basis: what this engine moves.
            self.xprof.kv_quant = self.kv_quant
        # The scheduler stamps preemption and prefix boundaries itself.
        self._sched.reqtrace = self.reqtrace
        q8 = "_q8" if self.kv.quantized else ""
        self._names = {"step": f"paged_step{'_sampled' if self._sampling else ''}"
                               f"{q8}[b{{B}},w{{W}}]",
                       "prefill": f"paged_prefill{q8}[c{self.prefill_chunk},"
                                  "w{W}]",
                       "spec": f"paged_spec{q8}[b{{B}},w{{W}},k{self.spec_k}]",
                       "draft": f"draft_prefill[c{self.prefill_chunk},w{{W}}]"}
        # The one copy-on-write copy, run once over the null block at
        # construction (JAX builds its executable here, never mid-traffic).
        if self._prefix is not None:
            t0 = time.perf_counter()
            self._cow_copy(NULL_BLOCK, NULL_BLOCK)
            self._note_build("paged_cow_copy", time.perf_counter() - t0)

    @property
    def sampler(self) -> SamplerConfig:
        return self._sampler

    @property
    def cache(self) -> PagedKV:
        """The KV pool (``xprof.memory_snapshot`` reads it, as the lanes
        engine's contiguous cache)."""
        return self.kv

    # ---- decode steps (one per shape bucket) ----

    def _table_buf(self, W: int) -> torch.Tensor:
        buf = self._table_bufs.get(W)
        if buf is None:
            buf = torch.zeros((self.batch, W), dtype=torch.int32,
                              device=self.device)
            self._table_bufs[W] = buf
        return buf

    def _get_step(self, B: int, W: int) -> Callable[[], None]:
        key = (B, W)
        fn = self._steps.get(key)
        if fn is not None:
            return fn
        cfg, params, kv = self.cfg, self.params, self.kv
        tokens, lengths = self._tok_buf[:B], self._len_buf[:B]
        tables = self._table_buf(W)[:B]
        sampler, gen, tp = self._sampler, self._gen, self._tp

        def step() -> None:
            logits = llama.decode_step_paged(cfg, params, tokens, kv.k,
                                             kv.v, tables, lengths,
                                             **kv.scales, tp=tp)
            tokens.copy_(sample_tokens(logits, gen, sampler))
            lengths.add_(1)

        return self._install(self._steps, key, step,
                             self._names["step"].format(B=B, W=W))

    def _get_spec(self, B: int, W: int) -> Callable[[], None]:
        """The speculative step of one (batch, width) bucket
        (``llama.spec_step_paged``): reads the static tokens, lengths,
        tables and limits, writes the pools in place, the committed tokens
        into the static out-token buffer, and the next tokens and lengths
        back into their buffers. One captured graph per bucket on the card
        (the draft loop is a Python loop of a fixed ``spec_k`` inside the
        capture), the eager step on the CPU."""
        key = (B, W)
        fn = self._specs.get(key)
        if fn is not None:
            return fn
        cfg, params, kv, K = self.cfg, self.params, self.kv, self.spec_k
        dcfg, dparams, draft = self._draft_cfg, self._draft_params, \
            self.draft_kv
        tokens, lengths = self._tok_buf[:B], self._len_buf[:B]
        tables, limit = self._table_buf(W)[:B], self._limit_buf[:B]
        out = self._out_buf[:B]
        self_draft, tp = self._self_draft, self._tp

        def spec() -> None:
            committed, nxt, new_lengths = llama.spec_step_paged(
                cfg, dcfg, params, dparams, tokens, kv.k, kv.v,
                None if draft is None else draft.k,
                None if draft is None else draft.v, tables, lengths, limit,
                K, **kv.scales, self_draft=self_draft, tp=tp)
            out.copy_(committed)
            tokens.copy_(nxt)
            lengths.copy_(new_lengths)

        return self._install(self._specs, key, spec,
                             self._names["spec"].format(B=B, W=W))

    def _get_prefill(self, W: int) -> Callable[[], torch.Tensor]:
        """The prefill chunk of table width ``W``: reads the static prefill
        buffer, writes the pools in place, returns the logits [1, vocab]
        (on the card, the captured graph's static output, valid until the
        next replay). With a tiny draft the same chunk (one graph) then
        replays the tokens through the draft into its pool, with no head,
        so that the draft has the history to draft from (prefix-cache hits
        skip the matched blocks there too: stale draft rows cost acceptance
        only, never tokens, since the target verifies)."""
        fn = self._prefills.get(W)
        if fn is not None:
            return fn
        cfg, params, kv, c = self.cfg, self.params, self.kv, \
            self.prefill_chunk
        dcfg, dparams, draft = self._draft_cfg, self._draft_params, \
            self.draft_kv
        buf = self._pf_buf
        tokens, table = buf[:c].view(1, c), buf[c + 3:c + 3 + W].view(1, W)
        scalars = (buf[c:c + 1], buf[c + 1:c + 2], buf[c + 2:c + 3])
        tp = self._tp

        def chunk() -> torch.Tensor:
            logits = llama.prefill_chunk_paged(
                cfg, params, tokens, kv.k, kv.v, table, *scalars,
                **kv.scales, tp=tp)
            if draft is not None:
                llama.prefill_chunk_paged(dcfg, dparams, tokens, draft.k,
                                          draft.v, table, *scalars,
                                          logits=False, tp=tp)
            return logits

        also = () if draft is None else (self._names["draft"].format(W=W),)
        return self._install(self._prefills, W, chunk,
                             self._names["prefill"].format(W=W), also)

    def _install(self, table: dict, key, fn: Callable, name: str,
                 also: tuple = ()) -> Callable:
        """Install the executable of one bucket under ``key``: on the card
        ``fn`` captured into a CUDA graph now (the capture's host wall is the
        build's time), on the CPU the eager ``fn``, whose first call is the
        build. Either way the build is noted as ``name`` (and ``also``)."""
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            fn = self._capture(fn)
            self._note_build(name, time.perf_counter() - t0, also=also)
        else:
            fn = self._tracked(name, fn,
                               functools.partial(table.__setitem__, key),
                               also)
        table[key] = fn
        return fn

    def _state_bufs(self) -> tuple[torch.Tensor, ...]:
        """The static per-slot buffers a step reads or advances (tables
        aside): tokens, lengths, limits and committed tokens."""
        return (self._tok_buf, self._len_buf, self._limit_buf, self._out_buf)

    def _upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """Copy a host array into a device buffer without waiting for the
        device: through pinned memory (whose block the caching host
        allocator holds until the copy has run) on the card."""
        t = torch.from_numpy(np.ascontiguousarray(src))
        if dst.device.type == "cuda":
            dst.copy_(t.pin_memory(), non_blocking=True)
        else:
            dst.copy_(t)

    def _to_device(self, src: np.ndarray) -> torch.Tensor:
        out = torch.empty(src.shape, dtype=torch.from_numpy(src).dtype,
                          device=self.device)
        self._upload(out, src)
        return out

    @torch.no_grad()
    def warmup(self, batches: list[int] | None = None,
               widths: list[int] | None = None,
               prefill_widths: list[int] | None = None) -> int:
        """Capture the decode step of every (batch, width) bucket named
        (both ladders by default) over the null block, and run each once:
        tables all point at block 0 and lengths are 0, so every write
        lands in the one block no sequence owns, and the static buffers are
        restored afterwards, so live state is untouched. A spec engine
        builds its spec steps instead, and never a plain one (their limits
        are 0 too: every write is rerouted to the null block). Then capture
        and run the prefill chunk of every width in ``prefill_widths``
        (default ``widths``, else the width ladder; ``[]`` skips them) over
        the null block: no valid row, every write rerouted to block 0.
        Returns the number of steps and chunks built: graphs captured on
        the card, eager functions on the CPU. A deployment calls this at
        startup so that traffic never pays a capture."""
        self._cow_guard(())
        built = 0
        state = self._state_bufs()
        saved = ([t.clone() for t in state],
                 {W: t.clone() for W, t in self._table_bufs.items()})
        steps, get = (self._specs, self._get_spec) if self.spec_decode \
            else (self._steps, self._get_step)
        for B in batches or self._sched.batch_buckets:
            for W in widths or self._sched.width_buckets:
                for t in state:
                    t[:B].zero_()
                self._table_buf(W)[:B].zero_()
                if (B, W) not in steps:
                    built += 1
                get(B, W)()
        for t, keep in zip(state, saved[0]):
            t.copy_(keep)
        for W, t in saved[1].items():
            self._table_bufs[W].copy_(t)
        for W in set(self._table_bufs) - set(saved[1]):
            self._table_bufs[W].zero_()
        if prefill_widths is None:
            prefill_widths = widths or self._sched.width_buckets
        built += self._warmup_prefill(prefill_widths)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return built

    def _warmup_prefill(self, widths: list[int]) -> int:
        """Build and run the prefill chunk of every width in ``widths``
        over the null block (no valid row: every write lands in block 0).
        Returns the number of chunks built."""
        built = 0
        for W in widths:
            self._pf_buf.zero_()
            if W not in self._prefills:
                built += 1
            self._get_prefill(W)()
        return built

    def decode_width_buckets(self, start_tokens: int,
                             end_tokens: int) -> list[int]:
        """The width buckets a sequence crosses decoding from
        ``start_tokens`` to ``end_tokens`` in cache: what a caller passes
        to ``warmup(widths=...)`` to capture exactly the graphs a run of
        known lengths will use."""
        bs = self.block_size
        ladder = self._sched.width_buckets
        lo = pick_bucket(max(1, -(-start_tokens // bs)), ladder)
        hi = pick_bucket(max(1, -(-end_tokens // bs)), ladder)
        return [w for w in ladder if lo <= w <= hi]

    # ---- request intake ----

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit "
                             f"max_len={self.max_len} with room to generate")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      enqueue_ts=time.time())
        self._next_rid += 1
        self._queue.append(req)
        rt = self.reqtrace
        if rt is not None:
            rt.note_enqueue(req.rid, ts=req.enqueue_ts,
                            prompt_len=len(prompt),
                            max_new_tokens=max_new_tokens)
        # No memory snapshot here, as in the lanes engine's submit.
        self._report_metric(memory=False)
        return req.rid

    @property
    def queue_depth(self) -> int:
        """Requests not yet (re)admitted: the submit queue plus preempted
        sequences awaiting recompute."""
        return len(self._queue) + len(self._sched.preempted)

    @property
    def kv_lane_utilization(self) -> float:
        """Fraction of the KV block pool in use (1.0 = allocator dry,
        admissions defer)."""
        return self._alloc.utilization

    @property
    def _active(self) -> np.ndarray:
        """Liveness mask: one True per sequence prefilling or decoding,
        plus one while undrained window tokens or completions are pending,
        so that a driver stepping while "active" keeps ticking until the
        last request's bookkeeping lands."""
        n = self._sched.live
        if n == 0 and (self._pending or self._finishing):
            n = 1
        return np.ones((n,), bool)

    def _report_metric(self, memory: bool = True) -> None:
        """Refresh the gauges; ``memory=False`` leaves out the (rate-limited)
        memory snapshot, as ``submit`` does (see there)."""
        if self.metric_hook is not None:
            self.metric_hook(self.queue_depth)
        tel = self.telemetry
        if tel is not None:
            tel.sample_gauges(self.queue_depth, self.kv_lane_utilization)
            if self._prefix is not None:
                tel.sample_prefix(self.prefix_stats())
            if self.spec_decode:
                tel.sample_spec(self.spec_stats())
            if self.handoff_stats["requests"]:
                tel.sample_handoff(self.handoff_view())
            if self.reqtrace is not None and self.reqtrace.finished_total:
                tel.sample_phases(self.reqtrace.phase_stats())
        if self.xprof is not None:
            if memory:
                self.xprof.observe_memory(self, tel)
            if self.spec_decode:
                self.xprof.spec = self.spec_stats()
            if self.handoff_stats["requests"]:
                self.xprof.handoff = self.handoff_view()

    def handoff_view(self) -> dict:
        """Block-handoff accounting of the consuming side.
        ``ms_per_request`` is the mean host wall one adoption's copy
        dispatch cost (no sync: it times the enqueue, not the copy);
        ``bytes_per_request`` the mean bytes a request's cold suffix moved
        (shared prefix blocks never move: they are ``shared_blocks``)."""
        st = self.handoff_stats
        n = st["requests"]
        return {"requests": n,
                "blocks": st["blocks"],
                "shared_blocks": st["shared_blocks"],
                "bytes": st["bytes"],
                "deferred": st["deferred"],
                "seconds": st["seconds"],
                "ms_per_request": st["seconds"] * 1e3 / n if n else 0.0,
                "bytes_per_request": st["bytes"] / n if n else 0.0,
                "block_bytes": self._block_bytes}

    def payload(self) -> dict:
        """Debug view: scheduler and allocator state."""
        return {"engine": "paged", "slots": self.batch,
                "max_len": self.max_len,
                "block_size": self.block_size,
                "prefill_chunk": self.prefill_chunk,
                "queue_depth": self.queue_depth,
                "steps": self.steps, "ticks": self.ticks,
                "completed": len(self.completed),
                "prefix_cache": self._prefix is not None,
                "cow_copies": self.cow_copies,
                "kv_quant": self.kv_quant,
                "spec_decode": self.spec_decode,
                "spec": self.spec_stats(),
                "handoff": self.handoff_view(),
                "schedule": self._sched.payload()}

    def idle(self) -> bool:
        """No sequence live or preempted (whose KV the current weights
        wrote)."""
        return not (self._sched.live or self._sched.preempted)

    def reset_prefix_cache(self) -> int:
        """Forget every cached prefix, whose KV the current weights wrote.
        Returns the cached blocks freed."""
        return self._prefix.clear() if self._prefix is not None else 0

    def prefix_stats(self) -> dict:
        """Prefix-cache gauges (empty with the cache off)."""
        if self._prefix is None:
            return {}
        p = self._prefix.payload()
        return {"hit_rate": p["hit_rate"],
                "cached_blocks": p["cached_blocks"],
                "cached_bytes": p["cached_blocks"] * self._block_bytes,
                "reclaimed_bytes":
                    p["reclaimed_total"] * self._block_bytes,
                "tokens_matched_total": p["tokens_matched_total"],
                "cow_copies": self.cow_copies}

    def _stamp_admit(self, req: Request, now: float,
                     admit: float | None = None) -> None:
        _stamp_admit_impl(req, now, admit, self._ttft_compat, self.telemetry)
        if self.reqtrace is not None:
            self.reqtrace.note_admit(req.rid, ts=req.admit_ts)

    def _complete(self, req: Request) -> None:
        _complete_impl(req, self.completed, self.telemetry)
        if self.reqtrace is not None:
            self.reqtrace.note_done(req.rid, ts=req.done_ts)

    # ---- disaggregated handoff (the consuming side) ----

    def _get_handoff(self) -> Callable[[PagedKV], None]:
        """The cross-pool block copy (serving/handoff.py): reads a static
        [2, max_blocks_per_seq] int64 buffer of source and destination ids
        (null-padded) and copies those blocks of the source pools into this
        engine's pools in place: the decode graphs hold the pools'
        addresses, so they are never rebound. One copy moves a whole
        payload. Pad pairs are all null -> null: on the card
        ``index_copy_`` with duplicate indices may land any of those rows,
        which is harmless only because the null block holds garbage by
        design and every masked read ignores it. The copy runs on the
        current stream, the one both tiers' graphs replay on, so it reads
        the producer's pool after the chunk that wrote it. Built on the
        first adoption or by ``warmup_handoff``; its first call is the
        build of ``paged_handoff_copy``."""
        if self._handoff is None:
            ids = torch.full((2, self.max_blocks_per_seq), NULL_BLOCK,
                             dtype=torch.int64, device=self.device)
            kv, src, dst = self.kv, ids[0], ids[1]

            def copy(source: PagedKV) -> None:
                if kv.quantized:  # the scale rows move with the int8 rows
                    llama.paged_block_copy_q(
                        kv.k, kv.v, kv.k_scale, kv.v_scale, source.k,
                        source.v, source.k_scale, source.v_scale, src, dst)
                else:
                    llama.paged_block_copy(kv.k, kv.v, source.k, source.v,
                                           src, dst)

            self._handoff_ids = ids
            self._handoff = self._tracked(
                "paged_handoff_copy", copy,
                functools.partial(setattr, self, "_handoff"))
        return self._handoff

    @torch.no_grad()
    def warmup_handoff(self, source: "PrefillEngine") -> int:
        """Build the handoff copy and run it once with every pair null ->
        null, so that traffic never pays for it. Returns the number of
        copies built (0 or 1)."""
        built = int(self._handoff is None)
        fn = self._get_handoff()
        self._upload(self._handoff_ids,
                     np.full((2, self.max_blocks_per_seq), NULL_BLOCK,
                             np.int64))
        fn(source.kv)
        return built

    @torch.no_grad()
    def adopt(self, payload: HandoffPayload) -> bool:
        """Adopt one finished prefill from another engine's pool. Gate on a
        free decode slot, match the tokens against the LOCAL prefix tree
        (full-block hits join shared: those blocks never transfer), adopt
        fresh blocks for the cold suffix, copy them pool to pool, and join
        the sequence straight into the decode batch. False is
        backpressure: nothing changed hands, and the producer retries on
        its next pump.

        Source block references stay with the payload until ``release()``
        at the END, so a refusal leaves both allocators as they were. The
        last handed-off block is never prefix-shared (a match stops at
        len(tokens) - 1), so decode's first write lands in a refcount-1
        adopted block and ``_cow_guard`` holds with no copy-on-write here.
        No device sync: one pinned upload of the ids, then the copy."""
        sched = self._sched
        if sched.slots_free <= 0:
            self.handoff_stats["deferred"] += 1
            return False
        tokens = np.asarray(payload.tokens, np.int32)
        shared: list[int] = []
        matched = 0
        if self._prefix is not None:
            shared, matched, partial = self._prefix.match(tokens)
            if partial is not None:
                # A mid-block hit would need a copy-on-write and a partial
                # copy on top: the handoff reuses FULL blocks only. Drop
                # the caller's reference; the block falls back to cached.
                src_b, k = partial
                self._alloc.free([src_b])
                matched -= k
        n_shared = len(shared)
        cold = len(payload.blocks) - n_shared
        got = self._alloc.adopt(cold)
        if got is None:
            if shared:
                self._alloc.free(shared)
            self.handoff_stats["deferred"] += 1
            return False
        x = self.xprof
        sampled = x is not None and x.should_sample()
        t0 = time.perf_counter()
        fn = self._get_handoff()
        ids = np.full((2, self.max_blocks_per_seq), NULL_BLOCK, np.int64)
        ids[0, :cold] = payload.blocks[n_shared:]
        ids[1, :cold] = got
        if sampled:
            mark = self._tic()
        self._upload(self._handoff_ids, ids)
        fn(payload.source.kv)
        if sampled:
            # Only timed copies enter the histogram: the host wall below
            # times the enqueue, not the transfer.
            self._toc(mark, "handoff", then=functools.partial(
                GLOBAL_METRICS.observe, "grove_handoff_seconds"))
        dt = time.perf_counter() - t0
        seq = PagedSeq(req=payload.req, tokens=tokens,
                       blocks=SeqBlocks(self._alloc, shared + got),
                       order=0, pos=payload.pos,
                       n_generated=payload.n_generated,
                       recompute=payload.recompute,
                       last_token=payload.first_token,
                       prefix_matched=matched)
        sched.adopt_running(seq)
        self._composition_dirty = True
        moved_bytes = cold * self._block_bytes
        rt = self.reqtrace
        if rt is not None:
            # The trace rode the payload across the seam (a no-op under the
            # shared recorder, a splice with per-tier ones). Adoption closes
            # the handoff span and opens this tier's decode segment; a
            # recompute replay closes its preempt window instead.
            rt.adopt_trace(payload.trace)
            if matched:
                rt.note_prefix(payload.req.rid, n_shared,
                               len(payload.blocks), matched)
            if payload.recompute:
                rt.note_resume(payload.req.rid)
            else:
                rt.note_handoff(payload.req.rid, payload.created_ts,
                                blocks=cold, nbytes=moved_bytes,
                                shared=n_shared)
                rt.note_decode_start(payload.req.rid)
        st = self.handoff_stats
        st["requests"] += 1
        st["blocks"] += cold
        st["shared_blocks"] += n_shared
        st["bytes"] += moved_bytes
        st["seconds"] += dt
        GLOBAL_METRICS.inc("grove_handoff_blocks_total", float(cold))
        GLOBAL_METRICS.inc("grove_handoff_bytes_total", float(moved_bytes))
        payload.release()
        self._report_metric()
        return True

    # ---- admission ----

    @torch.no_grad()
    def admit_from_queue(self, prefiller=None) -> int:
        """Admit queued work into the scheduler: preempted sequences
        re-enter first (recompute), then fresh requests FIFO, each gated on
        a free slot and the allocator's first-chunk grant. ``prefiller`` is
        accepted for the lanes engine's call sites and ignored: chunked
        prefill is in-engine here."""
        admitted = 0
        while self._sched.preempted:
            seq = self._sched.preempted.popleft()
            if self._sched.readmit(seq) is None:
                self._sched.preempted.appendleft(seq)
                break
            admitted += 1
        while self._queue:
            req = self._queue[0]
            popped = time.time()  # queue exit, before any prefill work
            if self._sched.admit(
                    req, req.prompt[:req.prompt_len]) is None:
                break
            self._queue.popleft()
            if not req.admit_ts:
                req.admit_ts = popped
            if self.reqtrace is not None:
                # Queue exit stamps here, so queue_wait never absorbs the
                # chunked prefill's wall.
                self.reqtrace.note_admit(req.rid, ts=req.admit_ts)
            admitted += 1
        if admitted:
            self._report_metric()
        return admitted

    @torch.no_grad()
    def admit_prompts(self, prompts, max_new_tokens: int | None = None,
                      lengths=None) -> None:
        """Bulk admission: submit a [b, s] batch and drive chunked prefill
        to completion so that every row is decoding."""
        prompts_np = np.asarray(prompts)
        b, s = prompts_np.shape
        lengths_np = (np.full((b,), s, np.int32) if lengths is None
                      else np.asarray(lengths, np.int32))
        for i in range(b):
            n = int(lengths_np[i])
            new = (max_new_tokens if max_new_tokens is not None
                   else self.max_len - n)
            self.submit(prompts_np[i, :n], max_new_tokens=new)
        self.admit_from_queue()
        stalled = 0
        while self._sched.has_prefill_work() or self._queue \
                or self._sched.preempted:
            before = self._admit_progress()
            if self._sched.has_prefill_work():
                self._prefill_tick()
            elif self._sched.running:
                # Slots full with prompts still queued: decode the live
                # set so that completions free slots.
                self._decode_or_spec_tick()
            self.admit_from_queue()
            stalled = stalled + 1 if self._admit_progress() == before \
                else 0
            if stalled > 4 * self.batch + 16:
                raise RuntimeError(
                    "admit_prompts stalled: KV pool too small for the "
                    f"batch ({self._alloc.payload()})")

    def _admit_progress(self) -> tuple:
        """Monotone progress signature for admit_prompts' stall guard."""
        return (sum(sq.pos for sq in self._sched.prefilling),
                sum(sq.pos for sq in self._sched.running),
                len(self.completed), self._sched.admitted_total)

    # ---- the tick loop ----

    @torch.no_grad()
    def step(self) -> None:
        """One engine tick: at most one prefill chunk, then one decode
        step over the compacted batch. No device sync on this path:
        windows drain in ``_drain``."""
        if self._sched.has_prefill_work():
            self._prefill_tick()
        if self._sched.running:
            self._decode_or_spec_tick()
        elif self._pending or self._finishing:
            # The decode set emptied with a window in flight: fold it in
            # now (the last completion must not wait for more traffic).
            self._drain()
        self.ticks += 1

    def _decode_or_spec_tick(self) -> None:
        if self.spec_decode:
            self._spec_tick()
        else:
            self._decode_tick()

    def run(self, steps: int) -> None:
        """Drive ``steps`` ticks, then drain and wait for the device."""
        for _ in range(steps):
            self.step()
        self.sync()

    def sync(self) -> None:
        self._drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._resolve_timings()

    # ---- copy-on-write ----

    def _resolve_cow(self, seq) -> None:
        """Copy-on-write barrier, which every prefill chunk passes first:
        a sequence that matched a prefix mid-block shares that block
        read-only; before its first chunk writes into it, the shared
        contents are copied into the fresh block the scheduler granted
        (the table already points at the copy) and the source reference
        drops."""
        if seq.cow_src < 0:
            return
        src, dst = seq.cow_src, seq.cow_dst
        seq.cow_src = seq.cow_dst = -1
        self._cow_copy(src, dst)
        self._alloc.free([src])
        self.cow_copies += 1

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy block ``src`` of the pool onto block ``dst`` (K, V and, for
        int8 pools, the scale rows), on the current stream."""
        ids = self._to_device(np.array([src, dst], np.int64))
        kv = self.kv
        if kv.quantized:  # the scale rows move with the int8 rows
            llama.paged_block_copy_q(kv.k, kv.v, kv.k_scale, kv.v_scale,
                                     kv.k, kv.v, kv.k_scale, kv.v_scale,
                                     ids[:1], ids[1:])
        else:
            llama.paged_block_copy(kv.k, kv.v, kv.k, kv.v, ids[:1], ids[1:])

    def _cow_guard(self, seqs, span: int = 1) -> None:
        """Exclusive-write tripwire ahead of the decode scatter: every
        block the next step can write must have refcount 1. By
        construction decode always writes a fresh suffix or CoW block; a
        trip here means the sharing bookkeeping is corrupt, and raising
        beats the silent corruption of every other holder's KV."""
        bs = self.block_size
        for seq in seqs:
            start = seq.pos + seq.inflight
            end = min(start + span, len(seq.blocks.blocks) * bs)
            for p in range(start, end):
                b = seq.blocks.blocks[p // bs]
                if self._alloc.refcount(b) > 1:
                    raise RuntimeError(
                        f"decode write into shared block {b} (refcount "
                        f"{self._alloc.refcount(b)}): copy-on-write was "
                        "bypassed")

    # ---- chunked prefill ----

    def _prefill_tick(self) -> None:
        seq = self._sched.next_prefill()
        if seq is None:
            if not self._sched.prefilling:
                return
            # OOM at the prefill head. Decode has absolute priority for
            # the pool: with anything running, the head waits for
            # completions. With nothing running, the blocks are pinned by
            # prefilling sequences that can never advance past the FIFO
            # head: evict the newest back to the queue.
            if not self._sched.running:
                head = self._sched.prefilling[0]
                victim = self._sched.evict_newest_prefilling(protect=head)
                if victim is not None:
                    self._requeue_prefill_victim(victim)
                    self._report_metric()
            return
        # A pending mid-block prefix hit is copied into its fresh block
        # before this chunk's scatter can land there.
        self._resolve_cow(seq)
        c = self.prefill_chunk
        pos, total = seq.pos, seq.prompt_len
        valid = min(c, total - pos)
        W = pick_bucket(len(seq.blocks.blocks), self._sched.width_buckets)
        host = np.zeros((c + 3 + W,), np.int32)
        host[:valid] = seq.tokens[pos:pos + valid]
        host[c:c + 3] = (pos, max(0, valid - 1), valid)
        host[c + 3:] = pad_tables([seq.blocks.blocks], W)[0]
        # Upload before the chunk is built: a capture's eager warm-up run
        # reads the static buffer and writes this chunk's K/V.
        self._upload(self._pf_buf[:c + 3 + W], host)
        fn = self._get_prefill(W)
        x = self.xprof
        sampled = x is not None and x.should_sample()
        rt = self.reqtrace
        traced = rt is not None and rt.should_sample()
        if sampled or traced:
            wall = time.time()
            mark = self._tic()
        logits = fn()
        if sampled or traced:
            # The chunk span is decoration only (not accumulated): phase
            # seconds come from the admit -> prefill-done boundaries.
            self._toc(mark, "prefill" if sampled else None, tokens=valid,
                      then=functools.partial(
                          self._note_chunk, seq.req.rid, W, valid, wall)
                      if traced else None)
        self.chunks += 1
        seq.pos += valid
        if seq.prefill_done:
            self._finish_prefill(seq, logits)

    def _requeue_prefill_victim(self, victim) -> None:
        """Re-queue a sequence evicted from the prefill queue: a recompute
        victim carries generated history in its tokens and re-enters
        through the preempted path; a fresh one through the submit
        queue."""
        if victim.recompute:
            self._sched.preempted.appendleft(victim)
        else:
            self._queue.appendleft(victim.req)

    def _sample_first(self, logits: torch.Tensor) -> int:
        """The prefill-produced token, by the sampler (one host fetch)."""
        return int(sample_tokens(logits, self._gen, self._sampler)[0])

    def _note_chunk(self, rid: int, W: int, valid: int, wall: float,
                    seconds: float) -> None:
        self.reqtrace.note_chunk(rid, W, seconds, valid, t0=wall)

    def _take_first(self, seq, logits) -> int:
        """Sample the prefill-produced token (one host fetch, after which
        the queued timings are read, before the prefill-done stamp) and fold
        it into the request: a first token is stamped (TTFT), a recompute
        replay's is the next decode token and the stamps stay."""
        tok = self._sample_first(logits)
        self._resolve_timings()
        req = seq.req
        if seq.recompute:
            req.generated.append(tok)
            if self.telemetry is not None:
                self.telemetry.add_tokens(1)
        else:
            self._stamp_admit(req, time.time(), admit=req.admit_ts or None)
            req.generated.append(tok)
        seq.n_generated = len(req.generated)
        seq.last_token = tok
        return tok

    def _finish_prefill(self, seq, logits) -> None:
        """The chunk that produces the first token just ran: take it and
        stamp TTFT here, at token emission."""
        self._take_first(seq, logits)
        req = seq.req
        rt = self.reqtrace
        if rt is not None:
            if seq.recompute:
                # The recompute replay finished: the preempt_recompute
                # window closes and decode resumes.
                rt.note_resume(req.rid)
            else:
                rt.note_prefill_done(req.rid)
                rt.note_decode_start(req.rid)
        self._sched.promote(seq)
        self._composition_dirty = True
        if seq.finished():
            self._sched.retire(seq)
            self._complete(req)
        self._report_metric()

    # ---- decode ----

    def _decode_tick(self) -> None:
        sched = self._sched
        # Cache-full truncation: a sequence whose next write would land
        # past max_len completes now (its table would outgrow the width
        # ladder's top bucket).
        full = [s for s in sched.running if s.pos + 1 > self.max_len]
        if full:
            self._drain()
            for s in full:
                sched.retire(s)
                self._complete(s.req)
            self._composition_dirty = True
            self._report_metric()
            if not sched.running:
                return
        # Capacity: a block grant does not change composition, so the
        # cheap path needs no drain; only a shortfall (preemption) or a
        # finished/joined sequence forces one.
        needy = [s for s in sched.running if not s.blocks.ensure(s.pos + 1)]
        if needy:
            self._grant_capacity(1)
            if not sched.running:
                return
        sig = tuple(len(s.blocks.blocks) for s in self._run_order)
        if self._composition_dirty:
            self._recompose()
        elif sig != self._tables_sig:
            self._refresh_tables()
        if not sched.running:
            return
        B, W = self._cur_shape
        self._cow_guard(self._run_order)
        fn = self._get_step(B, W)
        x = self.xprof
        sampled = x is not None and x.should_sample()
        if sampled:
            mark = self._tic()
        fn()
        if sampled:
            self._toc(mark, "sample" if self._sampling else "step",
                      tokens=len(self._run_order))
        # Each pending window keeps its own token copy (the next step
        # overwrites the static buffer) and its composition, so joins and
        # leaves between windows need no drain.
        self._pending.append((self._tok_buf[:B].clone(), self._run_order))
        self.steps += 1
        for seq in self._run_order:
            if seq.req.done:
                continue
            seq.pos += 1
            seq.n_generated += 1
            if seq.finished() and seq in sched.running:
                # Count-based completion: blocks free now; the window's
                # tokens drain into req.generated later.
                sched.retire(seq)
                self._finishing.append(seq)
                self._composition_dirty = True
        if len(self._pending) >= self.host_sync_interval:
            self._drain()

    def _spec_tick(self) -> None:
        """The speculative decode tick: one spec step advances every
        running sequence by 1..spec_k + 1 tokens. The committed count
        stays on the device until the window drains, so the host's
        bookkeeping here is conservative: ``seq.inflight`` grows by the
        whole span per dispatch (a bound on the device's length), the
        capacity and full checks use ``pos + inflight``, and ``_drain``
        folds the true counts into ``pos``. No device sync on this path."""
        sched = self._sched
        span = self.spec_k + 1
        # Cache-full: if the next dispatch could write past max_len for a
        # sequence (its device length may be pos + inflight already), drain
        # to learn the real positions and retire the truly full. The rest
        # re-enter with exact positions, and the limits clamp their commits
        # at max_len: the plain engine's one token at the edge.
        if any(s.pos + s.inflight + span > self.max_len
               for s in sched.running):
            self._drain()
            full = [s for s in sched.running if s.pos + 1 > self.max_len]
            for s in full:
                sched.retire(s)
                self._complete(s.req)
            if full:
                self._composition_dirty = True
                self._report_metric()
            if not sched.running:
                return
        # Capacity: room for a whole span past each row's bound, capped at
        # max_len (the limit truncates the commit of a row near the edge
        # instead of growing its table past the width ladder). A shortfall
        # falls back to one token's grant before it preempts.
        needy = [s for s in sched.running
                 if not s.blocks.ensure(min(s.pos + s.inflight + span,
                                            self.max_len))]
        if needy:
            self._grant_capacity(span)
            if not sched.running:
                return
        sig = tuple(len(s.blocks.blocks) for s in self._run_order)
        if self._composition_dirty:
            self._recompose()
        elif sig != self._tables_sig:
            self._refresh_tables()
        if not sched.running:
            return
        B, W = self._cur_shape
        self._cow_guard(self._run_order, span=span)
        fn = self._get_spec(B, W)
        x = self.xprof
        sampled = x is not None and x.should_sample()
        if sampled:
            mark = self._tic()
        fn()
        if sampled:
            self._toc(mark, "step", tokens=len(self._run_order))
        # Each pending window keeps its own copy of the committed tokens
        # (the next dispatch overwrites the static buffer).
        self._pending.append((self._out_buf[:B].clone(), self._run_order,
                              (B, W)))
        self.steps += 1
        for seq in self._run_order:
            if not seq.req.done:
                seq.inflight += span
        if len(self._pending) >= self.host_sync_interval:
            self._drain()

    def _grant_capacity(self, span: int) -> None:
        """A running sequence lacks room for its next dispatch: drain, then
        grant every running sequence room for ``span`` more tokens
        (preempting newest-first on shortfall; a span falls back to one
        token before it preempts). A sequence still without room for one
        token reclaims blocks from the prefill queue, and failing that is
        truncated rather than left to livelock."""
        sched = self._sched
        self._drain()
        if sched.ensure_decode_capacity(tokens_per_tick=span):
            self._composition_dirty = True
            self._report_metric()
        for s in [s for s in sched.running if s.blocks.capacity < s.pos + 1]:
            while s.blocks.capacity < s.pos + 1:
                victim = sched.evict_newest_prefilling()
                if victim is None:
                    break
                self._requeue_prefill_victim(victim)
                s.blocks.ensure(s.pos + 1)
            if s.blocks.capacity >= s.pos + 1:
                continue
            sched.retire(s)
            self._complete(s.req)
            self._composition_dirty = True

    def _recompose(self) -> None:
        """Rebuild the decode inputs after sequences joined or left: drain
        pending windows (their tokens carry the survivors' current tokens
        to the host), compact the running set into slots [0, n), and copy
        tokens, lengths and tables into the static buffers at the new
        buckets."""
        self._drain()
        running = self._sched.running
        self._run_order = tuple(running)
        self._composition_dirty = False
        if not running:
            self._cur_shape = None
            self._tables_sig = ()
            return
        B, W = self._sched.decode_shape()
        self._cur_shape = (B, W)
        toks = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, s in enumerate(running):
            toks[i] = s.last_token
            lens[i] = s.pos
        self._upload(self._tok_buf[:B], toks)
        self._upload(self._len_buf[:B], lens)
        self._push_tables(B, W)

    def _refresh_tables(self) -> None:
        """A running sequence grew a block (same composition): only the
        tables are stale, and the width bucket may step up; tokens and
        lengths stay on the device."""
        B = self._cur_shape[0]
        W = pick_bucket(
            max(len(s.blocks.blocks) for s in self._run_order),
            self._sched.width_buckets)
        self._cur_shape = (B, W)
        self._push_tables(B, W)

    def _push_tables(self, B: int, W: int) -> None:
        """Upload the tables of the running set; a spec engine's per-row
        write caps go up with them, since they change only when a row's
        blocks do: what its blocks (and max_len) hold, 0 for padded rows
        (their writes all land in the null block)."""
        rows = pad_tables([s.blocks.blocks for s in self._run_order], W)
        full = np.full((B, W), NULL_BLOCK, np.int32)
        full[:len(self._run_order)] = rows
        self._upload(self._table_buf(W)[:B], full)
        self._tables_sig = tuple(len(s.blocks.blocks)
                                 for s in self._run_order)
        if self.spec_decode:
            limit = np.zeros((B,), np.int32)
            limit[:len(self._run_order)] = [
                min(self.max_len, n * self.block_size)
                for n in self._tables_sig]
            self._upload(self._limit_buf[:B], limit)

    def _drain(self) -> None:
        """Fold pending window tokens into their requests with one host
        fetch. Every pending step has the same batch bucket (it changes
        only in ``_recompose``, which drains first), so the window stacks
        into one [steps, B] tensor ([steps, B, spec_k + 1] for spec
        steps)."""
        if not self._pending:
            return
        x = self.xprof
        if x is not None:
            t0 = time.perf_counter()
        toks = torch.stack([e[0] for e in self._pending]).cpu().numpy()
        if x is not None:
            x.record("host_transfer", time.perf_counter() - t0)
        self._resolve_timings()
        entries = [e[1:] for e in self._pending]
        self._pending.clear()
        rt = self.reqtrace
        # Per-window acceptance decoration, thinned by the sampling gate
        # (aggregated per sequence over this drain's windows).
        spec_note = {} if rt is not None and rt.should_sample() else None
        spec_seqs: dict = {}   # insertion-ordered dedupe
        appended = accepted = drafted = 0
        for arr, entry in zip(toks, entries):
            if len(entry) == 1:
                for i, seq in enumerate(entry[0]):
                    req = seq.req
                    if req.done or len(req.generated) >= req.max_new_tokens:
                        continue
                    tok = int(arr[i])
                    req.generated.append(tok)
                    seq.last_token = tok
                    appended += 1
                continue
            counts = self._fold_spec(arr, *entry, spec_seqs, spec_note)
            appended += counts[0]
            accepted += counts[1]
            drafted += counts[2]
        if spec_seqs:
            if drafted:
                GLOBAL_METRICS.inc("grove_spec_accepted_tokens",
                                   float(accepted))
                GLOBAL_METRICS.inc("grove_spec_draft_tokens", float(drafted))
            retired = False
            for seq in spec_seqs.values():
                # A drain folds every pending window: pos is exact again.
                seq.inflight = 0
                if not seq.req.done and seq.finished() \
                        and seq in self._sched.running:
                    self._sched.retire(seq)
                    self._complete(seq.req)
                    self._composition_dirty = True
                    retired = True
            if retired:
                self._report_metric()
        if spec_note:
            for seq, acc, n_draft in spec_note.values():
                rt.note_spec_window(seq.req.rid, self.steps, acc, n_draft)
        if self.telemetry is not None:
            self.telemetry.add_tokens(appended)
        if self._finishing:
            for seq in self._finishing:
                self._complete(seq.req)
            self._finishing = []
            self._report_metric()

    def _fold_spec(self, arr: np.ndarray, order: tuple, bucket: tuple,
                   spec_seqs: dict, spec_note: dict | None
                   ) -> tuple[int, int, int]:
        """Fold one spec window ([B, spec_k + 1]: each row's committed
        tokens, then -1) into its sequences: the count advances ``pos``
        (the device's length), the tokens join ``generated`` up to
        max_new_tokens (an overshoot's rows are real K/V, but the request
        is done and its extra tokens drop), and the acceptance counters
        move (per sequence into ``spec_note`` too, when given). Returns
        the tokens appended, accepted and drafted."""
        appended = accepted = drafted = 0
        st = self._spec_stats
        pb = st["per_bucket"].setdefault(
            bucket, {"accepted_tokens": 0, "draft_tokens": 0,
                     "committed_tokens": 0, "dispatches": 0, "rows": 0})
        pb["dispatches"] += 1
        st["dispatches"] += 1
        for i, seq in enumerate(order):
            req = seq.req
            if req.done:
                continue
            row = arr[i]
            toks = row[row >= 0]
            n = len(toks)
            seq.pos += n
            spec_seqs[id(seq)] = seq
            for d in (pb, st):
                d["accepted_tokens"] += max(0, n - 1)
                d["draft_tokens"] += self.spec_k
                d["committed_tokens"] += n
                d["rows"] += 1
            accepted += max(0, n - 1)
            drafted += self.spec_k
            if spec_note is not None:
                agg = spec_note.setdefault(id(seq), [seq, 0, 0])
                agg[1] += max(0, n - 1)
                agg[2] += self.spec_k
            for t in toks:
                if len(req.generated) >= req.max_new_tokens:
                    break
                req.generated.append(int(t))
                appended += 1
            seq.n_generated = len(req.generated)
            if n:
                seq.last_token = int(toks[-1])
        return appended, accepted, drafted

    def spec_stats(self) -> dict:
        """Speculative acceptance gauges; an empty dict with spec off. The
        counters move at drains only, so they trail the device by at most
        one window. ``accepted_per_dispatch`` is the mean number of tokens
        committed per sequence per spec dispatch, the bonus included: 1.0
        is the plain engine's, spec_k + 1 the ceiling."""
        if not self.spec_decode:
            return {}
        st = self._spec_stats
        drafted, accepted = st["draft_tokens"], st["accepted_tokens"]
        rows = st["rows"]
        return {"spec_k": self.spec_k,
                "draft_tokens": drafted,
                "accepted_tokens": accepted,
                "committed_tokens": st["committed_tokens"],
                "dispatches": st["dispatches"],
                "rows": rows,
                "acceptance_rate":
                    accepted / drafted if drafted else 0.0,
                "accepted_per_dispatch":
                    st["committed_tokens"] / rows if rows else 0.0,
                "per_bucket": {
                    f"b{B},w{W}": dict(v)
                    for (B, W), v in st["per_bucket"].items()}}


class PrefillEngine(PagedDecodeEngine):
    """The prefill tier of disaggregated serving (GROVE_DISAGG=1): chunked
    prefill over its OWN block pool and bucket ladder, no decode leg at all.
    A finished prefill detaches from the scheduler with its blocks still
    live and lands in ``outbox`` as a ``HandoffPayload``; the facade pumps
    the outbox into the decode engine's ``adopt``. TTFT is stamped HERE, at
    the prefill completion that produces the handoff (the same
    token-emission moment the mono engine stamps).

    Requests whose ``max_new_tokens`` is 1 complete on this tier: the
    prefill-sampled token is their whole output, exactly where the mono
    engine completes them, so the facade merges both engines'
    ``completed`` lists."""

    def __init__(self, *args, **kwargs):
        # Speculation is a decode-tier concern: prefill drafts nothing.
        kwargs["spec_decode"] = False
        super().__init__(*args, **kwargs)
        self.outbox: deque[HandoffPayload] = deque()
        self.handoffs_produced = 0

    def idle(self) -> bool:
        """Idle, and no finished prefill waits in the outbox."""
        return super().idle() and not self.outbox

    @torch.no_grad()
    def step(self) -> None:
        """One prefill tick. No decode leg: this engine's running set is
        empty by construction (sequences detach at promotion time), so the
        decode tier's steps never wait on a prompt chunk."""
        if self._sched.has_prefill_work():
            self._prefill_tick()
        self.ticks += 1

    @torch.no_grad()
    def warmup(self, batches: list[int] | None = None,
               widths: list[int] | None = None,
               prefill_widths: list[int] | None = None) -> int:
        """Capture ONLY prefill chunks (``prefill_widths``, default
        ``widths``, else the width ladder): the base warmup reads a missing
        or empty ``batches`` as the whole decode ladder, whose graphs this
        tier never runs. ``batches`` is ignored."""
        self._cow_guard(())
        if prefill_widths is None:
            prefill_widths = widths or self._sched.width_buckets
        built = self._warmup_prefill(prefill_widths)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return built

    def _finish_prefill(self, seq, logits) -> None:
        """Prefill completion on the disaggregated tier: sample the first
        token and stamp exactly as the mono engine does, then detach the
        sequence WITHOUT freeing its blocks: ownership moves to the
        HandoffPayload until the decode side adopts (or this engine dies
        and the payload dies with its pool)."""
        tok = self._take_first(seq, logits)
        req = seq.req
        self._sched.detach_prefill_head(seq)
        if seq.finished():
            # One-token requests never reach the decode tier: the mono
            # engine completes them at _finish_prefill, and so does this.
            self._sched._release_seq(seq)
            self._complete(req)
            self._report_metric()
            return
        rt = self.reqtrace
        if rt is not None and not seq.recompute:
            # The prefill phase closes at detach; the handoff span runs from
            # the payload's created_ts to adoption on the decode tier (a
            # recompute replay closes its preempt window at adoption).
            rt.note_prefill_done(req.rid)
        self.outbox.append(HandoffPayload(
            rid=req.rid, req=req, tokens=seq.tokens, first_token=tok,
            blocks=list(seq.blocks.blocks), pos=seq.pos,
            n_generated=seq.n_generated, recompute=seq.recompute,
            source=self, block_bytes=self._block_bytes,
            trace=rt.live_trace(req.rid) if rt is not None else None))
        self.handoffs_produced += 1
        self._report_metric()

    def _release_handoff(self, payload: HandoffPayload) -> None:
        """Drop a payload's block references (``HandoffPayload.release``).
        The prompt's full blocks were registered into this tier's prefix
        tree at detach time, so the unref parks them cached: the producer
        keeps its warm prefix across handoffs."""
        self._alloc.free(payload.blocks)

    def accept_recompute(self, seq: PagedSeq) -> None:
        """Take a decode-tier preemption victim for re-prefill: in
        disaggregated mode ALL prefill, recompute included, runs on this
        tier, so the decode tick stays pure decode. The victim arrives
        without blocks (the decode scheduler released its table); a carrier
        sequence re-enters through the preempted queue, whose readmit path
        restores n_generated and preemptions from it."""
        assert not seq.blocks.blocks, "recompute victim still holds blocks"
        carrier = PagedSeq(req=seq.req, tokens=seq.tokens,
                           blocks=SeqBlocks(self._alloc), order=-1,
                           n_generated=seq.n_generated, recompute=True,
                           preemptions=seq.preemptions)
        self._sched.preempted.append(carrier)

    @property
    def queue_depth(self) -> int:
        """Queued + preempted + produced but not adopted: an outbox payload
        is this tier's until the decode side takes it."""
        return super().queue_depth + len(self.outbox)


class DisaggServing:
    """The GROVE_DISAGG=1 serving pair behind one engine interface: a
    ``PrefillEngine`` front door handing finished KV blocks to a
    ``PagedDecodeEngine`` through the serving/handoff.py protocol. Callers
    built for one engine work unchanged: ``submit`` routes to prefill,
    ``step`` runs a prefill tick, the outbox pump and a decode tick, and
    the liveness, queue and completion surfaces merge both tiers. On one
    card both tiers launch on the current stream, so each handoff copy
    reads the producer's pool after the chunk that wrote it."""

    def __init__(self, prefill: PrefillEngine,
                 decode: PagedDecodeEngine) -> None:
        assert prefill.kv_quant == decode.kv_quant, \
            "handoff cannot cross quant modes (no requantize by design)"
        assert prefill.block_size == decode.block_size, \
            "handoff is a block-id remap; block geometry must match"
        assert not decode.spec_decode, \
            "disagg + speculative decoding is not wired yet"
        self.prefill = prefill
        self.decode = decode
        self.telemetry = decode.telemetry
        # One recorder spans the seam (make_disagg hands both tiers the
        # same one); the decode tier's is the facade's.
        self.reqtrace = decode.reqtrace
        self.ticks = 0

    # ---- engine interface ----

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        return self.prefill.submit(prompt, max_new_tokens=max_new_tokens)

    def admit_from_queue(self, prefiller=None) -> int:
        """Decode-tier preemption victims re-prefill on the prefill tier
        (recompute is prefill work); then fresh admissions."""
        moved = 0
        victims = self.decode._sched.preempted
        while victims:
            self.prefill.accept_recompute(victims.popleft())
            moved += 1
        return self.prefill.admit_from_queue() + moved

    def step(self) -> None:
        self.prefill.step()
        self._pump()
        self.decode.step()
        self.ticks += 1
        if self.telemetry is not None:
            # Each tier's gauges see only its half: the combined load
            # signal exists only here.
            self.telemetry.sample_gauges(self.queue_depth,
                                         self.kv_lane_utilization)

    def _pump(self) -> None:
        """Move finished prefills into the decode tier, in order. A refused
        adoption (no slot, or allocator backpressure) leaves the payload at
        the outbox head for the next tick: its blocks stay owned by the
        payload, and nothing leaks on either side."""
        out = self.prefill.outbox
        while out:
            if not self.decode.adopt(out[0]):
                break
            out.popleft()

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()
        self.sync()

    def sync(self) -> None:
        self.prefill.sync()
        self.decode.sync()

    def warmup(self, batches: list[int] | None = None,
               widths: list[int] | None = None,
               prefill_widths: list[int] | None = None) -> int:
        """Build both tiers' ladders and the handoff copy: the prefill tier
        captures prefill chunks only, the decode tier decode steps only."""
        built = self.prefill.warmup(
            prefill_widths=(prefill_widths if prefill_widths is not None
                            else widths))
        built += self.decode.warmup(batches=batches, widths=widths,
                                    prefill_widths=[])
        built += self.decode.warmup_handoff(self.prefill)
        return built

    # ---- merged surfaces ----

    @property
    def completed(self) -> list:
        """Both tiers' completions (max_new_tokens == 1 requests finish on
        the prefill tier, everything else on decode)."""
        return self.prefill.completed + self.decode.completed

    @property
    def queue_depth(self) -> int:
        return self.prefill.queue_depth + self.decode.queue_depth

    @property
    def kv_lane_utilization(self) -> float:
        """The tighter pool is the backpressure signal."""
        return max(self.prefill.kv_lane_utilization,
                   self.decode.kv_lane_utilization)

    @property
    def _active(self) -> np.ndarray:
        n = (self.prefill._sched.live + len(self.prefill.outbox)
             + self.decode._sched.live)
        if n == 0 and (self.decode._pending or self.decode._finishing
                       or self.prefill._queue
                       or self.prefill._sched.preempted
                       or self.decode._sched.preempted):
            n = 1
        return np.ones((n,), bool)

    @property
    def xprof(self):
        """The decode tier's observatory (each tier keeps its own; the
        prefill tier's is ``self.prefill.xprof``)."""
        return self.decode.xprof

    @property
    def cache(self) -> PagedKV:
        return self.decode.kv

    @property
    def params(self):
        return self.decode.params

    def handoff_view(self) -> dict:
        return self.decode.handoff_view()

    def replace_prefill(self, prefill: PrefillEngine) -> int:
        """Disaster recovery (chaos: prefill-replica-kill): swap in a fresh
        prefill engine after the old tier died. Work not yet adopted
        (queued requests, sequences mid-prefill, outbox payloads whose
        blocks died with the old pool) re-enters the new tier's queue with
        rids intact; produced but unshipped first tokens are discarded so
        the replay regenerates them (greedy re-prefill is deterministic:
        the same tokens). Recompute work keeps its generated history and
        re-enters through the recompute path. Returns the requests rescued.
        The old engine's allocator is NOT consulted: a killed replica's
        cannot be."""
        old = self.prefill
        fresh: list[Request] = []
        carriers: list[PagedSeq] = []

        def carrier(req, tokens, n_generated, preemptions=0):
            carriers.append(PagedSeq(
                req=req, tokens=np.asarray(tokens, np.int32),
                blocks=SeqBlocks(prefill._alloc), order=-1,
                n_generated=n_generated, recompute=True,
                preemptions=preemptions))

        for p in old.outbox:
            if p.recompute:
                # The replay's decode history is REAL output (including the
                # unshipped token _finish_prefill appended): rebuild the
                # replay input from it.
                carrier(p.req, np.concatenate([
                    p.req.prompt[:p.req.prompt_len],
                    np.asarray(p.req.generated, np.int32)]),
                    len(p.req.generated))
            else:
                fresh.append(p.req)
        for s in old._sched.prefilling:
            if s.recompute:
                carrier(s.req, s.tokens, s.n_generated, s.preemptions)
            else:
                fresh.append(s.req)
        fresh.extend(old._queue)
        for req in fresh:
            # Replay from scratch: the stamps and first tokens belonged to
            # work the dead tier never shipped.
            req.generated = []
            req.done = False
            req.admit_ts = req.first_token_ts = req.done_ts = 0.0
            req.cached_tokens = 0
            prefill._queue.append(req)
        carriers.extend(old._sched.preempted)
        prefill._sched.preempted.extend(carriers)
        # Completions already made are history, not state: carry them.
        prefill.completed.extend(old.completed)
        prefill._next_rid = max(prefill._next_rid, old._next_rid)
        # Trace continuity across the swap: the replacement tier joins the
        # pair's recorder (rids persist, so rescued requests append to the
        # same traces). Off stays off on both tiers.
        if prefill.reqtrace is not self.reqtrace:
            prefill.reqtrace = self.reqtrace
            prefill._sched.reqtrace = self.reqtrace
        self.prefill = prefill
        self.decode.warmup_handoff(prefill)
        return len(fresh) + len(carriers)

    def payload(self) -> dict:
        return {"engine": "disagg", "ticks": self.ticks,
                "handoff": self.decode.handoff_view(),
                "outbox": len(self.prefill.outbox),
                "prefill": self.prefill.payload(),
                "decode": self.decode.payload()}


def engine_mode() -> str:
    """GROVE_ENGINE=paged|lanes (default paged)."""
    mode = os.environ.get("GROVE_ENGINE", "paged")
    if mode not in ("paged", "lanes"):
        raise ValueError(f"GROVE_ENGINE={mode!r} (expected paged|lanes)")
    return mode


def disagg_mode() -> bool:
    """GROVE_DISAGG=1 splits paged serving into a PrefillEngine ->
    PagedDecodeEngine pair over the block handoff (default 0: the mono
    PagedDecodeEngine). Only the paged engine disaggregates:
    GROVE_ENGINE=lanes ignores this."""
    return os.environ.get("GROVE_DISAGG", "0") == "1"


def make_disagg(cfg: LlamaConfig, key_or_params, *, batch: int = 8,
                mesh=None, prefill_slots: int | None = None,
                prefill_num_blocks: int | None = None,
                telemetry=None, xprof=None, reqtrace=None,
                quant: str | None = None,
                device: str | torch.device | None = None,
                **common) -> DisaggServing:
    """Build the disaggregated pair: the params are resolved (and, with
    ``quant="int8"``, quantized) ONCE and shared by both tiers, and each
    tier gets its OWN block pool. ``prefill_slots``/``prefill_num_blocks``
    size the prefill tier on its own (prompt-heavy tiers want deeper pools
    and fewer concurrent slots); both default to the decode tier's
    geometry. The speculative-decoding knobs are dropped: disaggregation
    with speculation is not wired (as in the JAX package). The telemetry
    and ONE request recorder are shared by both tiers, so SLO stamps and a
    request's trace span the seam; ``xprof`` goes to the decode tier, and
    the prefill tier makes its own observatory (unless GROVE_XPROF=0).
    Under ``mesh`` both tiers are ranks of the same tp group, and each
    rank's handoff copies its own heads from pool to pool."""
    dev = resolve_device(device)
    if isinstance(key_or_params, torch.Generator):
        key_or_params = llama.init_params(cfg, key_or_params,
                                          key_or_params.device)
    # quantize_params passes int8 leaves through, so each tier's own
    # _quantized keeps these tensors; under tp > 1 the rank's slices are
    # cut once too, and both tiers take them as they are.
    params = _sharded(mesh if mesh is not None else single_device_mesh(),
                      key_or_params, quant, dev)
    for knob in ("spec_decode", "spec_k", "draft_params"):
        common.pop(knob, None)
    if reqtrace is None:
        reqtrace = (reqtrace_mod.RequestObservatory()
                    if reqtrace_mod.enabled() else False)
    pre_kwargs = dict(common)
    if prefill_num_blocks is not None:
        pre_kwargs["num_blocks"] = prefill_num_blocks
    pre = PrefillEngine(cfg, params, batch=prefill_slots or batch,
                        mesh=mesh, telemetry=telemetry,
                        reqtrace=reqtrace, quant=quant, device=dev,
                        **pre_kwargs)
    dec = PagedDecodeEngine(cfg, params, batch=batch, mesh=mesh,
                            telemetry=telemetry, xprof=xprof,
                            reqtrace=reqtrace, quant=quant, device=dev,
                            **common)
    return DisaggServing(pre, dec)


def make_engine(cfg: LlamaConfig, key_or_params, *, batch: int = 8,
                max_len: int | None = None,
                host_sync_interval: int = 8,
                sampler: SamplerConfig | None = None,
                quant: str | None = None,
                metric_hook=None, telemetry=None, xprof=None,
                reqtrace=None, mesh=None, mode: str | None = None,
                device: str | torch.device | None = None,
                **paged_kwargs):
    """Engine factory honoring GROVE_ENGINE: the paged engine by default,
    ``mode="lanes"`` for the lanes ``DecodeEngine``. Paged-only knobs
    (block_size, num_blocks, prefill_chunk, prefix_cache, kv_quant,
    spec_decode, spec_k, draft_params, ...) pass through ``paged_kwargs``
    and are ignored by the lanes engine, as in the JAX package.
    GROVE_DISAGG=1 builds the disaggregated pair (``make_disagg``;
    ``prefill_slots`` and ``prefill_num_blocks`` size its prefill tier)."""
    mode = mode or engine_mode()
    common = dict(batch=batch, max_len=max_len,
                  host_sync_interval=host_sync_interval, sampler=sampler,
                  quant=quant, metric_hook=metric_hook,
                  telemetry=telemetry, xprof=xprof, reqtrace=reqtrace,
                  device=device)
    if mode == "lanes":
        # As in the JAX package, the lanes engine runs on one device and
        # ignores ``mesh``.
        return DecodeEngine(cfg, key_or_params, **common)
    if mode != "paged":
        raise ValueError(f"unknown engine mode {mode!r}")
    if disagg_mode():
        return make_disagg(cfg, key_or_params, mesh=mesh, **common,
                           **paged_kwargs)
    return PagedDecodeEngine(cfg, key_or_params, mesh=mesh, **common,
                             **paged_kwargs)
