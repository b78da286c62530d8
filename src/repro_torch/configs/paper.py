"""The paper's tree-structured models (§5 "Models and dataset"), the
part of ``repro.configs.paper`` this package serves:

  - ``tree_lstm``:  binary child-sum Tree-LSTM sentiment classifier
                    (SST-like random binary parses, ≤54 words);
  - ``graph_rnn``:  N-ary child-sum cell over random DAGs with
                    multi-parent fan-out (paper Fig. 2d).

Each entry is a factory that builds the vertex function + matching
graph generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np

from repro_torch.core.structure import (InputGraph, random_binary_tree,
                                        random_dag)
from repro_torch.models.treelstm import TreeLSTMVertex


@dataclasses.dataclass(frozen=True)
class PaperModelCfg:
    name: str
    make_vertex: Callable[..., Any]       # (hidden, input_dim) -> F
    make_graphs: Callable[..., List[InputGraph]]
    input_dim: int = 256
    hidden: int = 512
    notes: str = ""


def _tree_lstm_graphs(n: int, max_leaves: int = 54, min_leaves: int = 2,
                      rng: np.random.Generator | None = None
                      ) -> List[InputGraph]:
    rng = rng or np.random.default_rng(0)
    out = []
    for _ in range(n):
        leaves = int(rng.integers(min_leaves, max_leaves + 1))
        out.append(random_binary_tree(leaves, rng))
    return out


def _graph_rnn_graphs(n: int, max_nodes: int = 24, min_nodes: int = 3,
                      rng: np.random.Generator | None = None
                      ) -> List[InputGraph]:
    """Random DAGs (paper Fig. 2d — graph-structured RNNs)."""
    rng = rng or np.random.default_rng(0)
    return [random_dag(int(rng.integers(min_nodes, max_nodes + 1)), rng)
            for _ in range(n)]


PAPER_MODELS: Dict[str, PaperModelCfg] = {
    "graph_rnn": PaperModelCfg(
        name="graph_rnn",
        make_vertex=lambda hidden=512, input_dim=256:
            TreeLSTMVertex(input_dim=input_dim, hidden=hidden, arity=3),
        make_graphs=_graph_rnn_graphs,
        notes="paper Fig. 2(d): N-ary child-sum cell over random DAGs "
              "with multi-parent fan-out"),
    "tree_lstm": PaperModelCfg(
        name="tree_lstm",
        make_vertex=lambda hidden=512, input_dim=256:
            TreeLSTMVertex(input_dim=input_dim, hidden=hidden, arity=2),
        make_graphs=_tree_lstm_graphs,
        notes="paper §5.1 binary child-sum Tree-LSTM on SST-like parses"),
}


def get_paper_model(name: str) -> PaperModelCfg:
    return PAPER_MODELS[name]
