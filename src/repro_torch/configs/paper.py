"""The paper's own model zoo (§5 "Models and dataset"), port of
``repro.configs.paper``:

  - ``fixed_lstm``: 64-step sequence LSTM LM (PTB-like synthetic corpus);
  - ``var_lstm``:   variable-length sequence LSTM LM;
  - ``tree_fc``:    the Fold loom benchmark cell over complete binary
                    trees (256 leaves → 511 vertices);
  - ``graph_rnn``:  N-ary child-sum cell over random DAGs with
                    multi-parent fan-out (paper Fig. 2d);
  - ``tree_lstm``:  binary child-sum Tree-LSTM sentiment classifier
                    (SST-like random binary parses, ≤54 words).

Each entry is a factory that builds the vertex function + matching
graph generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np

from repro_torch.core.structure import (InputGraph, balanced_binary_tree,
                                        chain, random_binary_tree,
                                        random_dag)
from repro_torch.models.rnn import LSTMVertex
from repro_torch.models.treelstm import TreeFCVertex, TreeLSTMVertex


@dataclasses.dataclass(frozen=True)
class PaperModelCfg:
    name: str
    make_vertex: Callable[..., Any]       # (hidden, input_dim[, impl]) -> F
    make_graphs: Callable[..., List[InputGraph]]
    input_dim: int = 256
    hidden: int = 512
    notes: str = ""


def _fixed_lstm_graphs(n: int, steps: int = 64,
                       rng: np.random.Generator | None = None
                       ) -> List[InputGraph]:
    return [chain(steps) for _ in range(n)]


def _var_lstm_graphs(n: int, max_len: int = 64, min_len: int = 4,
                     rng: np.random.Generator | None = None
                     ) -> List[InputGraph]:
    rng = rng or np.random.default_rng(0)
    # PTB-like length distribution: clipped lognormal.
    lens = np.clip(rng.lognormal(3.0, 0.5, n).astype(int), min_len, max_len)
    return [chain(int(length)) for length in lens]


def _tree_fc_graphs(n: int, leaves: int = 256,
                    rng: np.random.Generator | None = None
                    ) -> List[InputGraph]:
    return [balanced_binary_tree(leaves) for _ in range(n)]


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
    "fixed_lstm": PaperModelCfg(
        name="fixed_lstm",
        make_vertex=lambda hidden=512, input_dim=256, impl="jnp":
            LSTMVertex(input_dim=input_dim, hidden=hidden, cell_impl=impl),
        make_graphs=_fixed_lstm_graphs,
        notes="paper §5.1 Fixed-LSTM LM, 64 steps"),
    "var_lstm": PaperModelCfg(
        name="var_lstm",
        make_vertex=lambda hidden=512, input_dim=256, impl="jnp":
            LSTMVertex(input_dim=input_dim, hidden=hidden, cell_impl=impl),
        make_graphs=_var_lstm_graphs,
        notes="paper §5.1 Var-LSTM LM, variable-length chains"),
    "tree_fc": PaperModelCfg(
        name="tree_fc",
        # Tree-FC has no gate chain: ``impl`` is taken and ignored, as in
        # the reference.
        make_vertex=lambda hidden=512, input_dim=256, impl="jnp":
            TreeFCVertex(input_dim=input_dim, hidden=hidden),
        make_graphs=_tree_fc_graphs,
        notes="paper §5.1 Tree-FC (Fold loom benchmark), 256-leaf trees"),
    "graph_rnn": PaperModelCfg(
        name="graph_rnn",
        make_vertex=lambda hidden=512, input_dim=256, impl="jnp":
            TreeLSTMVertex(input_dim=input_dim, hidden=hidden, arity=3,
                           cell_impl=impl),
        make_graphs=_graph_rnn_graphs,
        notes="paper Fig. 2(d): N-ary child-sum cell over random DAGs "
              "with multi-parent fan-out"),
    "tree_lstm": PaperModelCfg(
        name="tree_lstm",
        make_vertex=lambda hidden=512, input_dim=256, impl="jnp":
            TreeLSTMVertex(input_dim=input_dim, hidden=hidden, arity=2,
                           cell_impl=impl),
        make_graphs=_tree_lstm_graphs,
        notes="paper §5.1 binary child-sum Tree-LSTM on SST-like parses"),
}


def get_paper_model(name: str) -> PaperModelCfg:
    return PAPER_MODELS[name]
