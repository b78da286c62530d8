"""The trainer: accumulation, int8+EF compression, checkpoints, failure
recovery, the non-finite guard (port of ``repro.train.trainer``, one
process on one card).

One class owns the loop:

  - microbatch gradient accumulation (``optim.accum``);
  - optional int8 + error-feedback gradient compression
    (``dist.compress.ef_apply``), the EF residual carried in
    :class:`TrainState` and never checkpointed;
  - async keep-k checkpoints (``checkpoint.manager``) and auto-resume
    (crash → restart → :meth:`Trainer.maybe_restore` → the same
    trajectory);
  - failure injection hooks (``dist.fault.FaultInjector``) so the
    recovery path runs in tests, not just in the docs;
  - ``fit(compose=, pipeline=)``: epoch corpora composed by a
    ``BatchComposer`` and packed on ``SchedulePipeline.prefetch``'s
    background thread.

Unlike the JAX trainer, whose jitted step returns a new state, the step
here updates the params, the AdamW moments and the step counter IN PLACE
(``optim.adamw.adamw_update``), so the Tree-LSTM's packed recurrent
views stay views.  The non-finite guard is therefore decided before any
write: a step whose loss or gradient norm is not finite leaves params,
moments and the EF residual as they were and only advances the step
counter.  That read of one flag a step is the host read the JAX trainer
makes of its ``skipped`` metric.

Data-parallel training over a mesh (``mesh=``, ``policy=``,
``TrainConfig.dp_shard``) waits for the port's mesh: ROADMAP.md queue 1,
item 4.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.dist.compress import ef_apply
from repro_torch.dist.fault import SimulatedFailure
from repro_torch.interop import pack_recurrent
from repro_torch.obs import trace
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               global_norm, microbatch_grads, warmup_cosine)
from repro_torch.optim.adamw import tree_map
from repro_torch.train.metrics import MetricLogger

Params = Any
Batch = Dict[str, Any]

_NO_MESH = ("data-parallel training over a mesh is not ported yet "
            "(the reference's repro/train/trainer.py _build_sharded_step "
            "and _sharded_stream; ROADMAP.md queue 1, item 4)")


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Params
    opt: OptState
    #: error-feedback residual for int8 gradient compression — a tree
    #: congruent with ``params``, ``None`` when compression is off.
    #: NEVER checkpointed (stripped on save, zero-re-initialized after
    #: restore).
    ef: Optional[Any] = None

    @property
    def step(self) -> int:
        return self.opt.step


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    n_micro: int = 1                  # gradient-accumulation microbatches
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_keep: int = 3
    log_every: int = 10
    compress_grads: bool = False      # int8+EF on the gradients
    #: data-parallel sharded training over graphs: not ported yet
    #: (``True`` raises NotImplementedError).
    dp_shard: bool = False
    #: non-finite-gradient guard: a step whose loss or global grad norm
    #: is NaN/Inf is SKIPPED (params and moments kept, step counter
    #: advanced — the poisoned batch is dropped) …
    skip_nonfinite: bool = True
    #: … up to this many CONSECUTIVE skips; one more aborts the run
    #: (persistent divergence is a bug, not weather).
    max_skip_steps: int = 10


class Trainer:
    """``loss_fn(params, batch) -> (loss, metrics)`` is differentiated
    on detached leaves that share storage with the params;
    ``init_params_fn(generator)`` makes the params from a
    ``torch.Generator``.  Everything runs on ``device``, the card unless
    the caller asks for the CPU."""

    def __init__(self, loss_fn: Callable[[Params, Batch],
                                         Tuple[torch.Tensor, Dict]],
                 init_params_fn: Callable[[torch.Generator], Params],
                 cfg: TrainConfig, *, mesh=None, policy=None,
                 device="cuda"):
        if mesh is not None or policy is not None or cfg.dp_shard:
            raise NotImplementedError(_NO_MESH)
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.cfg = cfg
        self.device = torch.device(device)
        self.schedule = warmup_cosine(cfg.lr, cfg.warmup_steps,
                                      cfg.total_steps)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep,
                                       save_interval_steps=cfg.ckpt_every)
                     if cfg.ckpt_dir else None)
        #: the init generator's (device, state), recorded by init_state
        #: for a re-init after a crash before the first commit
        self._init_seed: Optional[Tuple[torch.device, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # State init / restore
    # ------------------------------------------------------------------
    def _fresh_ef(self, params: Params) -> Optional[Any]:
        """Zeroed error-feedback residual, ``None`` when compression is
        off."""
        if not self.cfg.compress_grads:
            return None
        return tree_map(torch.zeros_like, params)

    def _placed(self, params: Params) -> Params:
        """The state's own copy of ``params`` on the trainer's device,
        every Tree-LSTM recurrent weight a view of one packed tensor."""
        return _packed(tree_map(
            lambda p: p.detach().to(self.device, copy=True), params))

    def init_state(self, seed: Union[int, torch.Generator]) -> TrainState:
        """Params from ``init_params_fn`` on a generator seeded with
        ``seed`` (or ``seed`` itself, a ``torch.Generator``), whose seed
        or state is recorded for a re-init after a crash before the first
        checkpoint."""
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        self._init_seed = (gen.device, gen.get_state())
        p = self._placed(self.init_params_fn(gen))
        return TrainState(params=p, opt=adamw_init(p), ef=self._fresh_ef(p))

    def _init_generator(self) -> torch.Generator:
        """A generator in the state ``init_state`` recorded (seed 0 if
        it was never called)."""
        if self._init_seed is None:
            return torch.Generator().manual_seed(0)
        device, gstate = self._init_seed
        gen = torch.Generator(device=device)
        gen.set_state(gstate)
        return gen

    def maybe_restore(self, state: TrainState) -> Tuple[TrainState, int]:
        """Resume from the newest committed checkpoint, onto the
        trainer's device, the recurrent weights packed again.

        Checkpoints never carry the EF residual, so it is stripped before
        matching the manifest and re-initialized to zeros — EF restarts
        cold, which only forfeits at most one step's quantization
        error."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, 0
        restored, step = self.ckpt.restore(
            dataclasses.replace(state, ef=None), device=self.device)
        params = _packed(restored.params)
        return dataclasses.replace(restored, params=params,
                                   ef=self._fresh_ef(params)), step

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    def _step(self, state: TrainState, batch: Batch
              ) -> Tuple[TrainState, Dict[str, Any]]:
        cfg = self.cfg
        loss, grads, metrics = microbatch_grads(
            self.loss_fn, state.params, batch, cfg.n_micro)
        new_ef = state.ef
        if cfg.compress_grads:
            # Error-feedback quantization, residual in the train state:
            # emit Q(g + e), carry e' = g + e - Q(g + e).
            grads, new_ef = ef_apply(grads, state.ef)
        lr = self.schedule(state.opt.step)
        metrics = dict(metrics)
        ok = True
        if cfg.skip_nonfinite:
            gnorm = global_norm(grads)
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            metrics["skipped"] = 0.0 if ok else 1.0
        if ok:
            _, _, opt_metrics = adamw_update(
                state.params, grads, state.opt, lr=lr, b1=cfg.b1, b2=cfg.b2,
                weight_decay=cfg.weight_decay,
                max_grad_norm=cfg.max_grad_norm)
            state = dataclasses.replace(state, ef=new_ef)
        else:
            # Nothing written: params, moments and the EF residual keep
            # their bits (a skipped step emitted nothing, so folding the
            # poisoned accumulator into the residual would leak the
            # dropped batch into the next emission); the step counter
            # advances, so the lr schedule and the checkpoint cadence
            # move on.
            state.opt.step += 1
            opt_metrics = {"grad_norm": gnorm, "lr": torch.tensor(
                float(lr), dtype=torch.float32)}
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    def _on_device(self, v: Any) -> Any:
        """A batch value on the trainer's device: tensors moved, numeric
        arrays made tensors, anything else (a ``DeviceSchedule``) as it
        is."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return v

    # ------------------------------------------------------------------
    # The loop
    # ------------------------------------------------------------------
    def fit(self, state: TrainState, batches, *,
            steps: Optional[int] = None,
            logger: Optional[MetricLogger] = None,
            fault_injector=None,
            compose=None,
            pipeline=None) -> Tuple[TrainState, MetricLogger]:
        """Run optimizer steps until the state's step is ``steps`` (or
        cfg.total_steps).

        ``fault_injector`` (``dist.fault.FaultInjector``) may raise a
        simulated node failure; the loop recovers by restoring the last
        committed checkpoint (or, before the first commit, re-initializing
        from the recorded seed).

        ``batches`` yields dicts; values may be tensors, arrays or a
        ``DeviceSchedule``.  A closable source (``AsyncPacker``) has its
        background producer shut down when the loop exits; a plain
        generator is never closed (the caller may keep consuming it
        across ``fit()`` calls).

        ``compose=`` (a ``repro_torch.pipeline.BatchComposer``, with
        ``pipeline=`` a ``SchedulePipeline``): ``batches`` yields EPOCH
        corpora — ``(graphs, inputs)`` or ``(graphs, inputs, aux)`` —
        each re-composed into cache-friendly minibatches and packed on
        the pipeline's background thread.  Composition REORDERS samples
        within an epoch (losslessly); aux riders (labels) move in lockstep
        and every batch dict carries ``sample_ids`` (original corpus
        indices).  Batch dicts are ``{"dev": DeviceSchedule, "ext":
        tensor, **aux, "sample_ids"}``.
        """
        cfg = self.cfg
        steps = steps if steps is not None else cfg.total_steps
        logger = logger or MetricLogger()
        source = batches        # the caller's object owns any close()
        if compose is not None and compose is not False:
            # (False is accepted as the natural opt-out spelling)
            if not callable(getattr(compose, "compose", None)):
                raise ValueError(
                    f"compose= takes a repro_torch.pipeline.BatchComposer "
                    f"(or False to opt out), got {compose!r}")
            if pipeline is None:
                raise ValueError("compose= requires pipeline= "
                                 "(a SchedulePipeline to pack through)")
            batches = _composed_stream(batches, compose, pipeline)
        try:
            return self._fit(state, iter(batches), steps, logger,
                             fault_injector)
        finally:
            if batches is not source:
                batches.close()           # stops the composed stream's packer
            close = getattr(source, "close", None)
            if callable(close) and not isinstance(source,
                                                  types.GeneratorType):
                close()

    def _fit(self, state: TrainState, batches: Iterator[Batch], steps: int,
             logger: MetricLogger, fault_injector
             ) -> Tuple[TrainState, MetricLogger]:
        cfg = self.cfg
        if cfg.compress_grads and state.ef is None:
            # States built before compression was enabled (or restored
            # from an EF-free checkpoint) start with a cold residual.
            state = dataclasses.replace(
                state, ef=self._fresh_ef(state.params))
        done = int(state.step)
        skips_in_row = 0
        while done < steps:
            with trace.correlate(step=done), \
                    trace.span("train.step", step=done):
                state, done, skips_in_row = self._fit_one(
                    state, batches, done, steps, skips_in_row, logger,
                    fault_injector)
        if self.ckpt is not None:
            self.ckpt.save(_ckpt_view(state), done, blocking=True)
        return state, logger

    def _fit_one(self, state, batches, done, steps, skips_in_row,
                 logger, fault_injector):
        """One iteration of the fit loop (the whole body under one
        ``train.step`` span).  Returns ``(state, done, skips_in_row)``; a
        fault recovery leaves ``done`` rewound instead of advanced."""
        cfg = self.cfg
        batch = next(batches)
        with trace.span("train.h2d"):
            batch = {k: self._on_device(v) for k, v in batch.items()}
        t0 = time.perf_counter()
        try:
            if fault_injector is not None:
                fault_injector.tick(done)
            with trace.span("train.fwd_bwd"):
                state, metrics = self._step(state, batch)
                trace.maybe_block(metrics["loss"])
        except _FAULTS as e:
            if self.ckpt is None:
                raise
            # Node failure: restore the last commit and continue.
            trace.instant("train.fault", step=done, error=repr(e))
            with trace.span("train.restore"):
                self.ckpt.wait()
                if self.ckpt.latest_step() is None:
                    # Crashed before the FIRST commit: nothing to
                    # restore, so re-init from the recorded seed.
                    return (self.init_state(self._init_generator()), 0,
                            skips_in_row)
                state, done = self.maybe_restore(state)
            return state, done, skips_in_row
        if cfg.skip_nonfinite:
            if metrics["skipped"] > 0:
                skips_in_row += 1
                logger.count("nonfinite_skips")
                if skips_in_row > cfg.max_skip_steps:
                    raise RuntimeError(
                        f"aborting at step {done}: "
                        f"{skips_in_row} consecutive non-finite "
                        f"steps (max_skip_steps="
                        f"{cfg.max_skip_steps}) — the model has "
                        f"diverged, skipping batches cannot "
                        f"save it")
            else:
                skips_in_row = 0
        logger.train_tick(time.perf_counter() - t0)
        done += 1
        if done % cfg.log_every == 0 or done == steps:
            with trace.span("train.log"):
                logger.log(done, metrics)
        if self.ckpt is not None and self.ckpt.should_save(done):
            with trace.span("train.checkpoint", step=done):
                self.ckpt.save(_ckpt_view(state), done)
        return state, done, skips_in_row


def _packed(tree: Params) -> Params:
    """``tree`` with every dict that holds the Tree-LSTM recurrent
    weights packed (``interop.pack_recurrent``), as the fused kernels
    take them."""
    if isinstance(tree, dict):
        return pack_recurrent({k: _packed(v) for k, v in tree.items()})
    return tree


def _ckpt_view(state: TrainState) -> TrainState:
    """What checkpoints carry: the state WITHOUT the EF residual (restore
    re-initializes it to zeros), the step as the JAX package's 0-d int32
    (either package restores the other's checkpoints)."""
    return TrainState(params=state.params,
                      opt=dataclasses.replace(
                          state.opt, step=np.asarray(state.opt.step,
                                                     np.int32)),
                      ef=None)


def _composed_stream(epochs, composer, pipeline):
    """Turn a stream of epoch corpora into composed, packed batch dicts
    (the ``compose=`` leg of :meth:`Trainer.fit`).

    Each epoch tuple is ``(graphs, inputs)`` or ``(graphs, inputs,
    aux)``; the composer reorders it into same-fingerprint groups +
    greedy leftover fills, the pipeline packs each composed batch on its
    ASYNC prefetch stage (host packing overlaps device compute), and the
    batch dict carries the aux riders and ``sample_ids`` realigned to the
    composed order."""

    def items():
        for epoch in epochs:
            graphs, inputs = epoch[0], epoch[1]
            aux = epoch[2] if len(epoch) > 2 else None
            for name in ("dev", "ext"):
                if aux and name in aux:
                    raise ValueError(
                        f"aux rider name {name!r} is reserved — "
                        f"composed batch dicts carry the "
                        f"DeviceSchedule/external matrix under that key")
            batches, _ = composer.compose(graphs, inputs, aux)
            for cb in batches:
                yield cb.as_item()

    packer = pipeline.prefetch(items(), depth=2)
    try:
        for pb in packer:
            batch = {"dev": pb.dev, "ext": pb.ext}
            for name, vals in pb.aux.items():
                batch[name] = np.asarray(vals)
            yield batch
    finally:
        packer.close()


_FAULTS = (SimulatedFailure,)
