"""Tree datasets for the paper's dynamic-NN experiments (the port of
``repro.data.trees``):

 - :func:`tree_fc_dataset` — complete binary trees (the Fold loom
   synthetic benchmark: 256 leaves → 511 vertices);
 - :func:`sst_like_dataset` — random binary parses with SST-like length
   statistics (≤ 54 words) + binary sentiment labels;
 - :func:`var_len_chains` — PTB-like variable-length chains.

NumPy only; the same seed gives the same data as the JAX package."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.structure import (InputGraph, balanced_binary_tree,
                                        chain, random_binary_tree)


@dataclasses.dataclass
class TreeDataset:
    graphs: List[InputGraph]
    inputs: List[np.ndarray]              # per sample [num_nodes, X]
    labels: Optional[np.ndarray] = None   # [K] int labels (classification)

    def __len__(self) -> int:
        return len(self.graphs)

    def batch(self, idx: Sequence[int]
              ) -> Tuple[List[InputGraph], List[np.ndarray],
                         Optional[np.ndarray]]:
        g = [self.graphs[i] for i in idx]
        x = [self.inputs[i] for i in idx]
        y = None if self.labels is None else self.labels[np.asarray(idx)]
        return g, x, y


def _leaf_inputs(g: InputGraph, dim: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """Random embeddings at leaves, zeros at internal nodes (the usual
    Tree-RNN convention: internal vertices pull nothing)."""
    x = np.zeros((g.num_nodes, dim), np.float32)
    for v in range(g.num_nodes):
        if not g.children[v]:
            x[v] = rng.standard_normal(dim).astype(np.float32) * 0.1
    return x


def tree_fc_dataset(n: int, leaves: int = 256, input_dim: int = 256,
                    seed: int = 0) -> TreeDataset:
    rng = np.random.default_rng(seed)
    graphs = [balanced_binary_tree(leaves) for _ in range(n)]
    inputs = [_leaf_inputs(g, input_dim, rng) for g in graphs]
    return TreeDataset(graphs=graphs, inputs=inputs)


def sst_like_dataset(n: int, max_leaves: int = 54, min_leaves: int = 2,
                     input_dim: int = 256, seed: int = 0) -> TreeDataset:
    """Random binary parses, SST length stats, binary sentiment labels."""
    rng = np.random.default_rng(seed)
    graphs, inputs = [], []
    for _ in range(n):
        # SST sentence lengths: roughly lognormal, clipped at 54.
        leaves = int(np.clip(rng.lognormal(2.7, 0.6), min_leaves, max_leaves))
        g = random_binary_tree(leaves, rng)
        graphs.append(g)
        inputs.append(_leaf_inputs(g, input_dim, rng))
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    return TreeDataset(graphs=graphs, inputs=inputs, labels=labels)


def var_len_chains(n: int, max_len: int = 64, min_len: int = 4,
                   input_dim: int = 256, seed: int = 0) -> TreeDataset:
    rng = np.random.default_rng(seed)
    graphs, inputs = [], []
    for _ in range(n):
        L = int(np.clip(rng.lognormal(3.0, 0.5), min_len, max_len))
        g = chain(L)
        graphs.append(g)
        inputs.append(rng.standard_normal((L, input_dim)).astype(np.float32)
                      * 0.1)
    return TreeDataset(graphs=graphs, inputs=inputs)
