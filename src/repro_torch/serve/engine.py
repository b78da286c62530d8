"""Serving engines, port of ``repro.serve.engine``:

  - :class:`ServeEngine` — transformer decode over a KV-cache slot pool
    (``TransformerLM``; prompts bucketed to powers of two, or prefilled
    at their exact length for SSM states): on the card a prompt's
    prefill is one K10 flash-attention launch an attention layer and one
    K12 SSD chunk-scan launch a Mamba layer, and a tick one K11
    decode-attention launch an attention layer;
  - :class:`VertexServeEngine` — the Cavs-native decode path for
    vertex-function sequence cells (LSTM/GRU): every engine tick is ONE
    batching task ``V_t`` over the slot pool, one megastep launch on the
    card (K3 for the LSTM, K4 for the GRU).  Slot occupancy, per-slot
    positions and retirement are pure data;
  - :class:`StructureServeEngine` — request/response serving of whole
    structures, below.

Request/response serving of WHOLE structures (trees/DAGs, e.g. a
sentiment service scoring parsed sentences), routed through the
schedule pipeline (``repro_torch.pipeline``): each dequeued batch is
fingerprinted, looked up in the schedule cache (repeated topologies skip
``pack_batch`` and the host→device copy), padded to bucket boundaries,
and executed as one fused batched forward — one hand-written megastep
launch per level on the card.

The engine shares the robustness layer (``serve/robustness.py``):
``submit`` validates at the door and REJECTS (terminal status, never an
exception) on garbage or a full queue; every request carries an optional
``ttl`` that becomes a hard deadline; every submitted request reaches
exactly one terminal status (``ok``/``timeout``/``rejected``/``failed``)
and lands in ``engine.finished``; ``engine.health()`` reports queue
depth, oldest wait, deadline misses, degradations and quarantines.  On
CPU tensors the fused forward degrades to the op-by-op oracle on
failure (a :class:`~repro_torch.serve.robustness.CircuitBreaker` pins
the oracle after ``breaker_threshold`` consecutive failures); every such
degradation is counted in ``health()["degradations"]`` and its cause
kept in ``last_degradation``.  On the card there is no such ladder: a
kernel that fails to build or launch fails the batch, so the plain
version never stands in for the kernel there.  Poisoned batches are
quarantined by bisection so one bad request never takes down its
co-batched peers.  :class:`VertexServeEngine` shares the lifecycle and,
on CPU tensors, the ladder; on the card a failed tick fails its
in-flight requests.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import (execute, readout_roots,
                                        resolve_fusion)
from repro_torch.core.structure import DeviceSchedule, InputGraph
from repro_torch.core.vertex import VertexIO
from repro_torch.dist.fault import chaos_fire
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace
from repro_torch.pipeline import (BucketPolicy, SchedulePipeline,
                                  graph_fingerprint)
from repro_torch.models.readout import _sample, step_generator
from repro_torch.serve.kv_cache import CacheSlots
from repro_torch.serve.robustness import (ACTIVE, CircuitBreaker,
                                          RequestLifecycle,
                                          quarantine_bisect,
                                          validate_prompt,
                                          validate_sequence,
                                          validate_structure)

Params = Any


class _EngineBase:
    """Lifecycle plumbing: ``queue`` and ``finished`` are views onto the
    :class:`RequestLifecycle` (so the bounded-queue/terminal-status
    invariants cannot be bypassed), and ``health()`` is the lifecycle's
    counters plus engine extras, the schedule-cache stats of an engine
    that owns a cache or a pipeline, and — when tracing is on — a
    summary of the most recent spans."""

    lifecycle: RequestLifecycle

    @property
    def queue(self) -> List[Any]:
        return self.lifecycle.queue

    @queue.setter
    def queue(self, reqs: List[Any]) -> None:
        self.lifecycle.queue = list(reqs)

    @property
    def finished(self) -> List[Any]:
        return self.lifecycle.finished

    def health(self) -> Dict[str, Any]:
        h = self.lifecycle.health(**self._health_extra())
        tiers = getattr(self, "cache", None)
        if tiers is None:       # not `or`: an empty cache is len()==0-falsy
            tiers = getattr(self, "pipeline", None)
        if tiers is not None:
            h["schedule_cache"] = tiers.stats()
        t = trace.get_tracer()
        if t is not None:
            h["recent_spans"] = t.summary(10)
        return h

    def _health_extra(self) -> Dict[str, Any]:
        return {}

    def _ladder(self, fused: Callable[[], Any], oracle: Callable[[], Any],
                on_card: bool, device: torch.device) -> Any:
        """One unit of work (a batch, a tick, a window) through the
        degradation ladder; returns what the rung that ran returns.

        On the card: the fused work (the op-by-op work when the engine
        does not fuse), synchronised so a fault surfaces here; a failure
        propagates, and the plain version never stands in for a kernel.
        On CPU tensors: the fused work first; on failure the op-by-op
        work for THIS unit (counted in ``degradations``, its cause kept
        in ``last_degradation``), and once the breaker trips, the
        op-by-op work without re-trying the fused one."""
        if on_card:
            if self.fused:
                chaos_fire("kernel")
                out = fused()
            else:
                out = oracle()
            torch.cuda.synchronize(device)
            return out
        if self.fused:
            try:
                chaos_fire("kernel")
                out = fused()
                self._breaker.record_success()
                return out
            except Exception as e:       # noqa: BLE001 — degrade, counted
                self._breaker.record_failure()
                self.lifecycle.degradations += 1
                self.last_degradation = repr(e)
        return oracle()


# ---------------------------------------------------------------------------
# Transformer decode over a KV-cache slot pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray               # [prompt_len] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    ttl: Optional[float] = None      # seconds from submit to deadline
    # -- filled by the engine ------------------------------------------
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "new"              # lifecycle: serve/robustness.py
    error: Optional[str] = None


class ServeEngine(_EngineBase):
    """Slot-pool continuous batching over a ``TransformerLM``.

    ``model`` exposes ``prefill(params, tokens)`` → ``(last_logits,
    cache)``, ``decode_step(params, cache, tokens, positions)`` →
    ``(logits, cache)`` and ``init_cache(batch, max_len, device=)``.  The
    engine runs on the device of ``params["embed"]``: on the card every
    prompt's prefill is one K10 launch an attention layer (K12 a Mamba
    layer) and every tick one K11 launch an attention layer, over all
    ``num_slots`` slots (inactive slots compute rows nobody reads, as in
    the reference).

    With ``pad_prompts`` (the default over attention), prompts are padded
    to a power-of-two bucket (at least 8 tokens): the pad goes on the
    right, the request is admitted at ``plen - 1`` and its last prompt
    token is replayed through the first decode step, whose fresh K/V
    overwrites the first pad row while ``kv_len`` masks the rest --
    attention stays exact.  Pads would roll into an SSM state, so over a model with Mamba
    layers (``model.cfg.mamba`` set) ``pad_prompts`` defaults to False
    and True raises: each prompt is prefilled at its exact length and its
    first token comes from the prefill logits (the reference's launcher
    sets the same rule by hand).  Greedy decoding
    takes the argmax; sampling draws each token on the CPU from a
    generator seeded by ``(seed, request_id, step)`` (``jax.random``
    cannot be reproduced here).  There is no degradation ladder, as in
    the reference: a kernel that fails fails the tick, and the error
    propagates out of :meth:`step`.
    """

    def __init__(self, model, params, *, num_slots: int, max_len: int,
                 greedy: bool = True, seed: int = 0,
                 pad_prompts: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        recurrent = getattr(getattr(model, "cfg", None), "mamba",
                            None) is not None
        if pad_prompts and recurrent:
            raise ValueError("ServeEngine: pad_prompts=True over Mamba "
                             "layers would roll the pads into the SSM "
                             "state")
        self.pad_prompts = (not recurrent if pad_prompts is None
                            else pad_prompts)
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.greedy = greedy
        self.seed = seed
        self.device = params["embed"].device
        cache = model.init_cache(num_slots, max_len, device=self.device)
        self.slots = CacheSlots.create(cache, num_slots)
        self.lifecycle = RequestLifecycle(max_queue=max_queue, clock=clock)
        self._last_token = np.zeros(num_slots, np.int64)
        self.ticks = 0
        self._live_requests: Dict[int, Request] = {}

    # -- ingress ------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Validate + enqueue; returns False (and routes ``req`` to the
        ``rejected`` terminal) on garbage input or a full queue.  Beyond
        the reference's checks, a token outside the padded vocab is
        rejected: on the card the embedding lookup would fault the
        device."""
        err = validate_prompt(req.prompt, self.max_len, req.max_new_tokens)
        vocab = self.params["embed"].shape[0]
        if err is None and int(np.max(req.prompt)) >= vocab:
            err = f"prompt contains token ids >= the vocab ({vocab})"
        return self.lifecycle.submit(req, err)

    # -- one engine tick -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        """Admit + decode one token for all active slots.  Returns the
        number of live requests after the tick."""
        self.lifecycle.sweep_deadlines()
        self._retire_expired()
        self._admit()
        if self.slots.num_active == 0:
            return len(self.queue)
        tokens = torch.from_numpy(self._last_token.copy()) \
            .to(self.device)[:, None]
        positions = self.slots.positions_device(self.device)
        with trace.span("serve.decode", active=int(self.slots.num_active)):
            logits, self.slots.cache = self.model.decode_step(
                self.params, self.slots.cache, tokens, positions)
            trace.maybe_block(logits)
        next_tok = self._sample(logits, [
            self.slots.request_of[s] if self.slots.active[s] else None
            for s in range(self.num_slots)])
        self.slots.advance()
        self.ticks += 1

        for slot in range(self.num_slots):
            if not self.slots.active[slot]:
                continue
            req = self._live_requests[self.slots.request_of[slot]]
            tok = int(next_tok[slot])
            req.output.append(tok)
            self._last_token[slot] = tok
            stop = (req.eos_id is not None and tok == req.eos_id) or \
                len(req.output) >= req.max_new_tokens or \
                int(self.slots.positions[slot]) >= self.max_len
            if stop:
                self._live_requests.pop(req.request_id, None)
                self.lifecycle.finish_ok(req)
                self.slots.retire(slot)
            elif self.lifecycle.expired(req):
                # In-flight deadline: retire with whatever decoded so far.
                self._live_requests.pop(req.request_id, None)
                self.lifecycle.finish_timeout(req)
                self.slots.retire(slot)
        return self.slots.num_active + len(self.queue)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drain the queue; returns finished requests."""
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return self.finished

    # -- internals -----------------------------------------------------------
    def _retire_expired(self) -> None:
        """Retire in-flight requests whose deadline passed between ticks
        (partial output stays on the request)."""
        for slot in range(self.num_slots):
            if not self.slots.active[slot]:
                continue
            req = self._live_requests[self.slots.request_of[slot]]
            if self.lifecycle.expired(req):
                self._live_requests.pop(req.request_id, None)
                self.lifecycle.finish_timeout(req)
                self.slots.retire(slot)

    def _admit(self) -> None:
        free = self.slots.free_slots()
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            req.status = ACTIVE
            with trace.correlate(request=req.request_id), \
                    trace.span("serve.prefill", slot=slot,
                               prompt_len=len(req.prompt)):
                self._admit_one(slot, req)

    def bucket(self, plen: int) -> int:
        """The prefill length of a prompt of ``plen`` tokens: a power of
        two of at least 8 with ``pad_prompts`` (exact for attention
        caches, which ``kv_len`` masks), else ``plen`` itself (an SSM
        state would take the pads in)."""
        if not self.pad_prompts:
            return plen
        return max(8, 1 << (plen - 1).bit_length())

    def _admit_one(self, slot: int, req: Request) -> None:
        plen = len(req.prompt)
        prompt = np.asarray(req.prompt, np.int64)
        bucket = self.bucket(plen)
        padded = np.concatenate([prompt, np.zeros(bucket - plen, np.int64)])
        logits, cache1 = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device)[None, :])
        if bucket == plen:
            # An exact prompt (a bucket's length, or pad_prompts=False):
            # the prefilled cache already holds the last token; the first
            # output token comes from the prefill logits.
            self.slots.admit(slot, req.request_id, cache1, prompt_len=plen)
            tok = int(self._sample(logits, [req.request_id])[0])
            req.output.append(tok)
            self._last_token[slot] = tok
        else:
            # Padded prompt: admit at plen - 1 and replay the final prompt
            # token through the decode step.
            self.slots.admit(slot, req.request_id, cache1,
                             prompt_len=plen - 1)
            self._last_token[slot] = int(prompt[-1])
        self._live_requests[req.request_id] = req

    def _sample(self, logits: torch.Tensor,
                request_ids: List[Optional[int]]) -> np.ndarray:
        """One token a row of ``logits`` ``[n, V]``: the argmax, or (not
        ``greedy``) a draw for row ``i`` of request ``request_ids[i]`` at
        its next step (rows of ``None`` get the argmax)."""
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        if not self.greedy:
            for i, rid in enumerate(request_ids):
                if rid is not None:
                    step = len(self._live_requests[rid].output) \
                        if rid in self._live_requests else 0
                    toks[i] = _sample(logits[i], step_generator(
                        (self.seed, rid), step))
        return toks

    def _health_extra(self) -> Dict[str, Any]:
        return {"active_slots": int(self.slots.num_active),
                "num_slots": self.num_slots, "ticks": self.ticks}


# ---------------------------------------------------------------------------
# Vertex-function serving (the Cavs decode path, fusion_mode-aware)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VertexRequest:
    """One streaming sequence for :class:`VertexServeEngine`.

    ``inputs``: ``[L, X_raw]`` external rows (tokens' embeddings,
    features, ...), consumed one per engine tick.  The engine fills
    ``final_state`` (``[S]``) when the sequence is exhausted.
    """

    request_id: int
    inputs: np.ndarray
    ttl: Optional[float] = None      # seconds from submit to deadline
    # -- filled by the engine ------------------------------------------
    final_state: Optional[np.ndarray] = None
    done: bool = False
    status: str = "new"              # lifecycle: serve/robustness.py
    error: Optional[str] = None

    @property
    def length(self) -> int:
        return int(self.inputs.shape[0])


class VertexServeEngine(_EngineBase):
    """Continuous batching for arity-1 vertex functions (LSTM/GRU).

    Each tick advances every active slot by one vertex: slot ``m``
    gathers its previous state, pulls its next external row, and writes
    the new state — one batching task ``V_t`` of width ``num_slots``.
    The state pool on ``device`` (default the card) is a ping-pong buffer
    ``[2*num_slots + 1, S]`` (last row = zero sentinel): tick parity
    ``p`` reads block ``p`` and writes block ``1-p``, so reads and writes
    never overlap — the non-overlap invariant that makes the megastep's
    in-place write sound.  Fresh slots point their gather at the
    sentinel (zero initial state), so admission and retirement are pure
    data.

    ``fusion_mode`` is resolved like the scheduler's (``REPRO_FUSION``
    included): when the cell declares a ``GateSpec`` the tick is ONE
    megastep (``ops.level_megastep``: K3 or K4 on the card); ``"none"``
    keeps the op-by-op gather → apply → write tick.  On CPU tensors a
    failed fused tick degrades to the op-by-op tick (counted; the breaker
    pins it after ``breaker_threshold`` consecutive failures).  On the
    card there is no such ladder: a failed tick fails its in-flight
    requests, and their slots' rows are zeroed.
    """

    def __init__(self, fn, params: Params, *, num_slots: int,
                 fusion_mode: str = "auto",
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 breaker_threshold: int = 3, device="cuda"):
        if getattr(fn, "arity", None) != 1:
            raise ValueError(
                f"VertexServeEngine decodes chains (arity-1 cells); "
                f"{type(fn).__name__} has arity {getattr(fn, 'arity', None)}")
        self.fn = fn
        self.params = params
        self.num_slots = num_slots
        self.device = torch.device(device)
        self.spec = resolve_fusion(fn, fusion_mode, sched_arity=1)
        self._buf = torch.zeros((2 * num_slots + 1, fn.state_dim),
                                dtype=torch.float32, device=self.device)
        #: slot m pulls row m of the tick's projected rows
        self._ext_ids = torch.arange(num_slots, dtype=torch.int32,
                                     device=self.device)
        self._parity = 0
        self._pos = np.zeros(num_slots, np.int64)
        self._slot_req: List[Optional[VertexRequest]] = [None] * num_slots
        self.lifecycle = RequestLifecycle(max_queue=max_queue, clock=clock)
        self._breaker = CircuitBreaker(breaker_threshold)
        self.ticks = 0
        self.last_degradation: Optional[str] = None
        self._tick = functools.partial(_vertex_tick, fn, self.spec)
        # The degradation rung: the same tick with spec=None is the
        # op-by-op tick (gather → apply → write, no megastep).
        self._tick_oracle = functools.partial(_vertex_tick, fn, None)

    @property
    def fused(self) -> bool:
        """True when ticks run as single megastep launches (False once
        the circuit breaker has pinned the op-by-op tick)."""
        return self.spec is not None and not self._breaker.open

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    # -- ingress ------------------------------------------------------------
    def submit(self, req: VertexRequest) -> bool:
        """Validate + enqueue; returns False (and routes ``req`` to the
        ``rejected`` terminal) on garbage input or a full queue."""
        err = validate_sequence(req.inputs, self.fn.input_dim)
        return self.lifecycle.submit(req, err)

    # -- one engine tick -----------------------------------------------------
    def step(self) -> int:
        """Admit + advance every active slot one vertex.  Returns live
        requests (active + queued) after the tick."""
        self.lifecycle.sweep_deadlines()
        expired_slots = []
        for m, req in enumerate(self._slot_req):
            if req is not None and self.lifecycle.expired(req):
                self.lifecycle.finish_timeout(req)
                self._slot_req[m] = None
                expired_slots.append(m)
        self._zero_slot_rows(expired_slots)
        for m in range(self.num_slots):
            if self._slot_req[m] is None and self.queue:
                req = self.queue.pop(0)
                req.status = ACTIVE
                self._slot_req[m] = req
                self._pos[m] = 0
        if self.num_active == 0:
            return len(self.queue)

        M = self.num_slots
        base, out_base = self._parity * M, (1 - self._parity) * M
        X = self.fn.input_dim
        child_ids = np.full((M, 1), 2 * M, np.int32)       # sentinel
        # One host buffer, one copy: ext rows | child mask | node mask.
        f = np.zeros(M * X + 2 * M, np.float32)
        ext_rows = f[:M * X].reshape(M, X)
        child_mask = f[M * X:M * X + M].reshape(M, 1)
        node_mask = f[M * X + M:]
        for m, req in enumerate(self._slot_req):
            if req is None:
                continue
            node_mask[m] = 1.0
            ext_rows[m] = req.inputs[self._pos[m]]
            if self._pos[m] > 0:
                child_ids[m, 0] = base + m
                child_mask[m, 0] = 1.0
        fd = torch.from_numpy(f).to(self.device)
        args = (self.params, self._buf,
                torch.from_numpy(child_ids).to(self.device),
                fd[M * X:M * X + M].view(M, 1), fd[:M * X].view(M, X),
                fd[M * X + M:], out_base, self._ext_ids)
        try:
            with trace.span("serve.tick", active=self.num_active,
                            fused=self.fused):
                self._run_tick(args)
        except Exception as e:           # noqa: BLE001 — the tick is lost
            # Every in-flight request reaches the ``failed`` terminal;
            # queued requests are untouched and admit next tick.
            failed_slots = []
            for m, req in enumerate(self._slot_req):
                if req is not None:
                    self.lifecycle.finish_failed(req, f"tick failed: {e}")
                    self._slot_req[m] = None
                    failed_slots.append(m)
            self._zero_slot_rows(failed_slots)
            return self.num_active + len(self.queue)
        self._parity = 1 - self._parity
        self.ticks += 1

        done_rows = None
        for m, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._pos[m] += 1
            if self._pos[m] >= req.length:
                if done_rows is None:
                    done_rows = self._buf[out_base:out_base + M].cpu() \
                        .numpy()
                req.final_state = done_rows[m].copy()
                self.lifecycle.finish_ok(req)
                self._slot_req[m] = None
        return self.num_active + len(self.queue)

    def _zero_slot_rows(self, slots: List[int]) -> None:
        """Re-zero BOTH ping-pong rows of slots freed by a timeout or a
        failed tick.  A fresh admission gathers the zero sentinel at
        position 0, so correctness never reads the stale rows — but a
        dead request's states must not linger in the pool."""
        if not slots:
            return
        M = self.num_slots
        rows = torch.tensor([r for s in slots for r in (s, M + s)],
                            dtype=torch.int64, device=self.device)
        self._buf.index_fill_(0, rows, 0.0)

    def _run_tick(self, args: Tuple) -> None:
        """One tick through :meth:`_EngineBase._ladder`."""
        self._ladder(lambda: self._tick(*args),
                     lambda: self._tick_oracle(*args), self._buf.is_cuda,
                     self.device)

    def run(self, max_ticks: int = 100_000) -> List[VertexRequest]:
        """Drain the queue; returns finished requests."""
        for _ in range(max_ticks):
            if self.step() == 0:
                break
        return self.finished

    def _health_extra(self) -> Dict[str, Any]:
        return {"active_slots": self.num_active, "ticks": self.ticks,
                "breaker_open": self._breaker.open,
                "breaker_trips": self._breaker.trips}


# ---------------------------------------------------------------------------
# Whole-structure serving (the schedule pipeline on the request path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StructureRequest:
    """One structure to score: the topology ``G`` plus its per-node
    external inputs ``[num_nodes, X_raw]``.  The engine fills
    ``root_state`` (``[S]``) — the batched readout of the root vertex."""

    request_id: int
    graph: InputGraph
    inputs: np.ndarray
    ttl: Optional[float] = None      # seconds from submit to deadline
    # -- filled by the engine ------------------------------------------
    root_state: Optional[np.ndarray] = None
    done: bool = False
    status: str = "new"              # lifecycle: serve/robustness.py
    error: Optional[str] = None


class StructureServeEngine(_EngineBase):
    """Batch scoring of queued structures through the schedule pipeline.

    Each :meth:`step` dequeues up to ``batch_size`` requests and runs
    ONE batched fused forward over them on ``device`` (default the card;
    pass ``device="cpu"`` for the plain versions).  Params must live on
    that device.

    ``compose=True`` (default) anchors each batch on the oldest pending
    request (no starvation) and fills it with every queued request
    sharing its topology fingerprint first — the batch most likely to be
    a schedule-cache hit — then tops it up FIFO.
    """

    def __init__(self, fn, params: Params, *, batch_size: int = 16,
                 pipeline: Optional[SchedulePipeline] = None,
                 fusion_mode: str = "auto", compose: bool = True,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 breaker_threshold: int = 3,
                 guard_nonfinite: bool = True,
                 device="cuda"):
        self.fn = fn
        self.params = params
        self.batch_size = batch_size
        self.compose = compose
        self.device = torch.device(device)
        self.pipeline = pipeline if pipeline is not None else \
            SchedulePipeline(fn.input_dim,
                             bucket_policy=BucketPolicy(mode="pow2"),
                             # forward-only consumer: pack without the
                             # backward's sorted-run arrays
                             with_runs=False, device=self.device)
        self.lifecycle = RequestLifecycle(max_queue=max_queue, clock=clock)
        self._breaker = CircuitBreaker(breaker_threshold)
        #: a request whose finite inputs still produced a non-finite
        #: root state fails ALONE — NaNs are block-diagonal in the
        #: batched forward, so attribution is direct.
        self.guard_nonfinite = guard_nonfinite
        self._fusion = fusion_mode
        self.batches = 0
        #: repr of the exception behind the latest fused → oracle
        #: degradation (``None`` while there has been none).
        self.last_degradation: Optional[str] = None

    # -- ingress ------------------------------------------------------------
    def submit(self, req: StructureRequest) -> bool:
        """Validate + enqueue; returns False (and routes ``req`` to the
        ``rejected`` terminal) on a malformed structure, non-finite
        inputs, a full queue, or a double-submitted request object."""
        err = validate_structure(req.graph, req.inputs, self.fn.input_dim)
        if err is not None:
            err = f"request {req.request_id}: {err}"
        return self.lifecycle.submit(req, err)

    @property
    def fused(self) -> bool:
        """True while batches attempt the fused forward (False once the
        circuit breaker has pinned the op-by-op oracle, which only the
        CPU ladder does)."""
        return self._fusion != "none" and not self._breaker.open

    # -- one engine batch ----------------------------------------------------
    def step(self) -> int:
        """Score one batch of queued requests.  Returns requests still
        queued after the batch."""
        self.lifecycle.sweep_deadlines()
        if not self.queue:
            return 0
        with trace.span("serve.flush"):
            reqs = (self._compose_flush() if self.compose
                    else self.queue[: self.batch_size])
        taken = set(id(r) for r in reqs)   # by identity: requests hold
        self.queue = [r for r in self.queue  # ndarrays, so == is unusable
                      if id(r) not in taken]
        for r in reqs:
            r.status = ACTIVE

        poisoned = [False]

        def run_fn(batch_reqs):
            try:
                return self._run_batch(batch_reqs)
            except Exception:
                poisoned[0] = True
                raise

        def on_fail(req, exc):
            self.lifecycle.finish_failed(
                req, f"batch execution failed: {exc}")

        with trace.span("serve.batch", size=len(reqs)):
            pairs = quarantine_bisect(list(reqs), run_fn, on_fail)
        if poisoned[0]:
            self.lifecycle.quarantines += 1
        self.batches += 1
        for req, root in pairs:
            if self.guard_nonfinite and not np.isfinite(root).all():
                self.lifecycle.finish_failed(req, "non-finite root state")
                continue
            req.root_state = root.copy()
            self.lifecycle.finish_ok(req)
        return len(self.queue)

    def run(self, max_batches: int = 10_000) -> List[StructureRequest]:
        """Drain the queue; returns finished requests."""
        for _ in range(max_batches):
            if self.step() == 0:
                break
        return self.finished

    # -- internals ----------------------------------------------------------
    def _compose_flush(self) -> List[StructureRequest]:
        """The batch to flush: anchored on the OLDEST pending request,
        filled with same-fingerprint peers from anywhere in the queue,
        topped up FIFO when the group runs short."""
        anchor_fp = graph_fingerprint(self.queue[0].graph)
        batch = [r for r in self.queue
                 if graph_fingerprint(r.graph) == anchor_fp]
        batch = batch[: self.batch_size]
        if len(batch) < self.batch_size:
            chosen = set(id(r) for r in batch)
            for r in self.queue:
                if len(batch) >= self.batch_size:
                    break
                if id(r) not in chosen:
                    batch.append(r)
        return batch

    def _run_batch(self, reqs: List[StructureRequest]) -> List[np.ndarray]:
        """Pack + score one (sub-)batch; per-request root-state rows.
        Raises on pack or kernel failure — the quarantine bisect above
        narrows the blast radius to the poisoned request."""
        batch = self.pipeline.pack([r.graph for r in reqs],
                                   [np.asarray(r.inputs, np.float32)
                                    for r in reqs])
        with trace.span("serve.score", size=len(reqs), fused=self.fused):
            roots = self._score(batch.dev, batch.ext).cpu().numpy()
        return [roots[k] for k in range(len(reqs))]

    def _score(self, dev: DeviceSchedule, ext: torch.Tensor) -> torch.Tensor:
        """The fused forward through :meth:`_EngineBase._ladder`: on the
        card a failure propagates (the quarantine bisect then fails the
        batch); on CPU tensors it degrades to the op-by-op oracle."""
        return self._ladder(
            lambda: _structure_batch(self.fn, self._fusion, self.params,
                                     dev, ext),
            lambda: _structure_batch(self.fn, "none", self.params, dev, ext),
            ext.is_cuda, ext.device)

    def _health_extra(self) -> Dict[str, Any]:
        return {"batches": self.batches,
                "breaker_open": self._breaker.open,
                "breaker_trips": self._breaker.trips}


def _structure_batch(fn, fusion_mode: str, params: Params,
                     dev: DeviceSchedule, ext: torch.Tensor) -> torch.Tensor:
    """One batched forward over a packed request batch → ``[K, S]``
    root states."""
    with torch.inference_mode():
        buf = execute(fn, params, dev, ext, fusion_mode=fusion_mode).buf
        return readout_roots(buf, dev)


def _vertex_tick(fn, spec, params: Params, buf: torch.Tensor,
                 child_ids: torch.Tensor, child_mask: torch.Tensor,
                 ext_rows: torch.Tensor, node_mask: torch.Tensor,
                 offset: int, ext_ids: torch.Tensor) -> torch.Tensor:
    """One decode batching task over the slot pool, IN PLACE on ``buf``
    (slot occupancy, positions and the ping-pong offset are all data).
    Slot ``m`` pulls row ``m`` of the projected rows (``ext_ids`` is
    ``arange(M)``; inactive slots carry zero rows)."""
    M = child_ids.shape[0]
    with torch.no_grad():
        ext = fn.project_inputs(params, ext_rows)      # hoisted eager prefix
        if spec is not None:
            return kops.level_megastep(spec.kind, buf, child_ids, child_mask,
                                       ext_ids, node_mask, offset, ext,
                                       spec.weights(params))
        S = buf.shape[1]
        ch = buf.index_select(0, child_ids.reshape(-1)).reshape(M, 1, S)
        io = VertexIO(child_states=ch, child_mask=child_mask,
                      external=ext.index_select(0, ext_ids),
                      node_mask=node_mask)
        out = fn.apply(params, io)
        buf[offset:offset + M] = out.state * node_mask[:, None]
        return buf
