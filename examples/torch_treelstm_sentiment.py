"""Tree-LSTM sentiment classifier on SST-like data (paper §5 model (d)),
trained with the PyTorch port on one NVIDIA GPU.

The port of ``examples/treelstm_sentiment.py``: dataset → batch composer
(``ComposedBatchSource``, labels riding along as aux) → schedule pipeline
(topology-fingerprint cache + per-graph splice tier + pow2 shape buckets,
packed with the backward's sorted runs) on a background thread
(``SchedulePipeline.prefetch``, two batches ahead) → batched scheduling
of F over G (``execute_lazy``: one fused megastep per level forward, one
reverse megastep per level backward) → classification head on root
states → AdamW with a warmup-cosine schedule.

SST-like random binary parses are nearly all distinct topologies, so the
composer's wins on this corpus are depth-sorted bucket occupancy and
deterministic epoch replay (from epoch 2 on, every batch is a
schedule-cache hit).  ``--no-compose`` slices FIFO epochs instead.

Run:  PYTHONPATH=src python3 examples/torch_treelstm_sentiment.py [--steps 150]
      PYTHONPATH=src python3 examples/torch_treelstm_sentiment.py \\
          --device cpu --hidden 16 --steps 20
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import execute_lazy, readout_roots
from repro_torch.data import ComposedBatchSource
from repro_torch.data.trees import TreeDataset, sst_like_dataset
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.adamw import OptState, Params, tree_map
from repro_torch.pipeline import BucketPolicy, PackedBatch, SchedulePipeline


def init_params(fn: TreeLSTMVertex, seed: int, device) -> Params:
    """Random cell weights (recurrent weights packed for the kernels) and
    a ``[hidden, 2]`` head, from ``torch.Generator`` seed ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    cell = fn.init(gen, device=device)
    head = torch.randn((fn.hidden, 2), generator=gen) * 0.1
    return {"cell": cell, "head": head.to(device)}


def fifo_batches(ds: TreeDataset, batch: int, rng: np.random.Generator
                 ) -> Iterator[Tuple[list, list, np.ndarray]]:
    """Epoch-cycled fixed partition: from epoch 2 on, every batch
    topology has been seen, so the schedule cache serves them all."""
    order = rng.permutation(len(ds))
    parts = [order[i: i + batch]
             for i in range(0, len(ds) - batch + 1, batch)]
    while True:
        for idx in parts:
            yield ds.batch(idx)


def composed_source(ds: TreeDataset, pipe: SchedulePipeline, batch: int
                    ) -> ComposedBatchSource:
    """Pipeline-aware batch formation over ``ds``: same-fingerprint
    samples grouped into whole batches, leftovers filling buckets by
    depth, the deterministic plan replayed every epoch.  Labels ride
    through the reordering as aux; each item is ``(graphs, inputs, aux,
    pads)`` with ``aux["sample_ids"]`` the corpus indices."""
    return ComposedBatchSource(ds.graphs, ds.inputs,
                               {"labels": list(ds.labels)},
                               composer=pipe.composer(batch))


def labels_of(b: PackedBatch, device) -> torch.Tensor:
    """The batch's labels (its ``labels`` aux rider) on ``device``."""
    return torch.from_numpy(
        np.asarray(b.aux["labels"]).astype(np.int64)).to(device)


def loss_and_acc(fn: TreeLSTMVertex, params: Params, ext: torch.Tensor,
                 dev, labels: torch.Tensor, fusion_mode: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy of the head on the root ``h`` states of the
    batch packed as ``ext``/``dev``, and its accuracy; differentiable in
    ``params`` and ``ext``."""
    buf = execute_lazy(fn, params["cell"], ext, dev, fusion_mode)
    root_h = readout_roots(buf, dev)[:, fn.hidden:]
    logits = root_h @ params["head"]
    nll = torch.logsumexp(logits, -1) \
        - logits.gather(1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return torch.mean(nll), acc


def loss_and_grads(fn: TreeLSTMVertex, params: Params, b: PackedBatch,
                   labels: torch.Tensor, fusion_mode: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """:func:`loss_and_acc` and the loss's gradients w.r.t. every param.
    Gradients are taken w.r.t. detached copies that share storage with
    ``params``, so the packed recurrent views stay views."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, acc = loss_and_acc(fn, leaves, b.ext, b.dev, labels, fusion_mode)
    loss.backward()
    return loss.detach(), acc, tree_map(lambda p: p.grad, leaves)


def train_step(fn: TreeLSTMVertex, params: Params, opt: OptState,
               b: PackedBatch, labels: torch.Tensor, lr: float,
               fusion_mode: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step (no weight decay, as in the reference loop), params
    and moments updated in place.  Returns (loss, accuracy) as tensors on
    the params' device, unsynchronised."""
    loss, acc, grads = loss_and_grads(fn, params, b, labels, fusion_mode)
    adamw_update(params, grads, opt, lr=lr, weight_decay=0.0)
    return loss, acc


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--input-dim", type=int, default=32)
    ap.add_argument("--no-compose", action="store_true",
                    help="FIFO epoch slicing instead of the composer")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Train; returns the loss of every step."""
    args = parse_args(argv)
    ds = sst_like_dataset(512, input_dim=args.input_dim, seed=0)
    fn = TreeLSTMVertex(input_dim=args.input_dim, hidden=args.hidden,
                        arity=2)
    pipe = SchedulePipeline(args.input_dim,
                            bucket_policy=BucketPolicy(mode="pow2"),
                            with_runs=True, device=args.device)
    params = init_params(fn, 0, args.device)
    opt = adamw_init(params)
    sched_fn = warmup_cosine(3e-3, 20, args.steps)
    if args.no_compose:
        source = ((g, x, {"labels": y}) for g, x, y in
                  fifo_batches(ds, args.batch, np.random.default_rng(0)))
    else:
        source = composed_source(ds, pipe, args.batch)
    batches = pipe.prefetch(source, depth=2)
    losses = []
    try:
        for step in range(1, args.steps + 1):
            b = next(batches)
            loss, acc = train_step(fn, params, opt, b,
                                   labels_of(b, args.device),
                                   sched_fn(opt.step))
            losses.append(float(loss))
            if step % 25 == 0 or step == 1:
                print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                      f"acc {float(acc):.2f}")
    finally:
        batches.close()
    s = pipe.stats()
    print(f"done — schedule pipeline: {s['hit_rate']:.0%} cache hit rate, "
          f"{s['compiled_shapes']} padded shape(s) over {s['batches']} "
          f"batches (async-packed; {s['packs']} cold packs)")
    if not args.no_compose and source.stats is not None:
        cs = source.stats
        print(f"composer: {cs.num_groups} topology groups → "
              f"{cs.group_batches} whole-group + {cs.leftover_batches} "
              f"leftover batches/epoch, predicted epoch-1 hit rate "
              f"{cs.hit_rate:.0%}, mean occupancy {cs.mean_occupancy:.0%}")
    return losses


if __name__ == "__main__":
    main()
