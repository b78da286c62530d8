"""Quickstart: the Cavs vertex-centric API in ~30 lines of user code,
with the PyTorch port on one NVIDIA GPU.

The port of ``examples/quickstart.py``: declares an N-ary child-sum
Tree-LSTM as a vertex function F (the paper's Fig. 4), packs a batch of
random parse trees G, runs batched training steps — no per-sample graph
construction anywhere — and composes a corpus with repeated topologies
into batches that hit the schedule cache.

The reference's ``REPRO_TRACE=trace.json`` timeline export is not ported
yet (the port's tracer has no Chrome-trace writer or environment gate);
the step below still opens the same ``trace.span``/``trace.correlate``
sites, which cost one ``is None`` check each with no tracer installed,
and ``trace.maybe_block`` synchronises the card only under a tracer.

Run:  PYTHONPATH=src python3 examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scheduler import execute_lazy, readout_roots
from repro_torch.core.structure import random_binary_tree
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.obs import trace
from repro_torch.pipeline import SchedulePipeline

INPUT_DIM, HIDDEN = 32, 64


def train_step(fn, params, b, step: int) -> float:
    """``mean(root_h ** 2)`` and one SGD step (lr 0.1, in place, so the
    packed recurrent views stay views)."""
    with trace.correlate(step=step), trace.span("train.step", step=step):
        with trace.span("train.fwd_bwd"):
            leaves = {k: v.detach().requires_grad_() for k, v in
                      params.items()}
            buf = execute_lazy(fn, leaves, b.ext, b.dev)   # Alg. 1 + §3.5
            root_h = readout_roots(buf, b.dev)[:, fn.hidden:]  # [K, hidden]
            loss = torch.mean(root_h ** 2)
            loss.backward()
            trace.maybe_block(loss)
        with trace.span("train.reduce"):
            with torch.no_grad():
                for k, v in params.items():
                    v.sub_(0.1 * leaves[k].grad)
            trace.maybe_block(loss)
    return float(loss.detach())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device

    # --- 1. declare F once (the static vertex function) ------------------
    fn = TreeLSTMVertex(input_dim=INPUT_DIM, hidden=HIDDEN, arity=2)
    params = fn.init(torch.Generator().manual_seed(0), device=device)

    # --- 2. per-sample input graphs G arrive as DATA (read "through I/O")
    rng = np.random.default_rng(0)
    graphs = [random_binary_tree(int(rng.integers(4, 20)), rng)
              for _ in range(8)]
    inputs = [rng.standard_normal((g.num_nodes, INPUT_DIM))
              .astype(np.float32) * 0.1 for g in graphs]

    # --- 3. the schedule pipeline packs the minibatch (host-side, NumPy):
    # topology-fingerprint cache + shape buckets, so repeated topologies
    # skip packing and near-miss batches reuse one launch shape.
    pipe = SchedulePipeline(ext_dim=INPUT_DIM, device=device)
    batch = pipe.pack(graphs, inputs)
    print(f"packed {len(graphs)} trees: {batch.sched.T} levels × "
          f"{batch.sched.M} slots, occupancy {batch.sched.occupancy:.0%}")

    # --- 4. batched training step: schedule F over G, lazy-batched grads -
    loss = train_step(fn, params, batch, step=0)
    print(f"one batched step OK — loss {loss:.5f}")
    print("the SAME kernels serve any other batch of trees:")
    graphs2 = [random_binary_tree(int(rng.integers(4, 20)), rng)
               for _ in range(8)]
    inputs2 = [rng.standard_normal((g.num_nodes, INPUT_DIM))
               .astype(np.float32) * 0.1 for g in graphs2]
    batch2 = pipe.pack(graphs2, inputs2)     # same bucket → same shape
    loss2 = train_step(fn, params, batch2, step=1)
    print(f"second batch, zero graph-construction overhead — "
          f"loss {loss2:.5f}")
    print(f"pipeline stats: {pipe.stats()}")

    # --- 5. pipeline-aware batch formation: COMPOSE batches for hits -----
    # A corpus with repeated topologies (the real-world case).  FIFO
    # slicing interleaves them — distinct batch fingerprints, no hits; the
    # composer groups same-fingerprint samples into whole batches, so
    # every batch after a group's first is a schedule-cache hit.
    corpus = [graphs[i % 4] for i in range(64)]          # heavy repetition
    corpus_in = [inputs[i % 4] for i in range(64)]
    composed, stats = pipe.compose(corpus, corpus_in, batch_size=8)
    for cb in composed:
        pipe.pack(*cb.as_item())             # sample_ids ride in aux
    print(f"composed {stats.num_batches} batches from {stats.num_groups} "
          f"topology groups: predicted hit rate {stats.hit_rate:.0%}, "
          f"measured {pipe.cache.hit_rate:.0%} overall, occupancy "
          f"{stats.mean_occupancy:.0%}")
    print("(set REPRO_SCHED_PERSIST=<dir> and re-run: the warm restart "
          "packs zero schedules — they load from the on-disk store)")
    return {"loss": loss, "loss2": loss2,
            "predicted_hit_rate": stats.hit_rate,
            "hit_rate": pipe.cache.hit_rate}


if __name__ == "__main__":
    main()
