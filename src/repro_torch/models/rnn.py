"""Sequence-RNN vertex functions (LSTM, GRU) — Cavs Fig. 2(b), PyTorch
port of ``repro.models.rnn``.

A sequence RNN is the chain special case of ``(F, G)``: vertex ``t``
gathers from vertex ``t-1``.  The scattered state is ``concat([c, h])``
(LSTM) or ``h`` (GRU), exactly the paper's convention (Fig. 4 L18).

Both cells declare their *eager prefix* (``W·x`` input projections) via
``project_inputs`` so the scheduler can hoist it: one
``[num_nodes, X] @ [X, G·H]`` matmul replaces per-level projections —
the streaming optimization of §3.5.  Both declare a ``GateSpec``, so the
scheduler's fused path runs each level as one megastep kernel
(``kernels/level_megastep.py``: K3 for the LSTM, K4 for the GRU).

``cell_impl`` selects the LSTM's gate math in :meth:`LSTMVertex.apply`,
the kernel-fusion axis of the paper's Fig. 10 ablation: ``"jnp"`` (the
reference's name for its plain gate math, here plain PyTorch),
``"pallas"`` (the recurrent product in PyTorch, then the gate chain in
one kernel, ``ops.lstm_gates``: K8a) or ``"fused"`` (product and gates in
one kernel, ``ops.lstm_level_fused``: K9).  They matter on the op-by-op
leg only (``fusion_mode="none"``, ``hoist=False``, ``collect_push=True``
or a non-f32 buffer); the fused leg runs the K3 megastep whatever the
``cell_impl``.  On the card K8a and K9 run forward only, as in the
reference, whose Pallas kernels have no VJP.

A bf16 node buffer meets float32 params as in the JAX package: the
products promote to float32 (:func:`~repro_torch.models.layers.matmul`),
the gate math runs in float32, and the scheduler casts the state back.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vertex import GateSpec, Params, VertexIO, VertexOutput
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, matmul


@dataclasses.dataclass(frozen=True)
class LSTMVertex:
    """Standard LSTM cell as a vertex function (arity 1).

    State layout: ``[c | h]`` (width ``2*hidden``); external: raw ``x``
    rows of width ``input_dim`` (projected to ``4*hidden`` eagerly).
    Param keys match the JAX package: ``wx``, ``wh``, ``b``.
    """

    input_dim: int
    hidden: int
    cell_impl: str = "jnp"

    arity: int = 1

    @property
    def state_dim(self) -> int:
        return 2 * self.hidden

    @property
    def ext_dim(self) -> int:
        return 4 * self.hidden  # post-projection width seen by apply()

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``); the bias is zero, as in the reference."""
        params = {
            "wx": dense_init(generator, self.input_dim, 4 * self.hidden),
            "wh": dense_init(generator, self.hidden, 4 * self.hidden),
            "b": torch.zeros((4 * self.hidden,), dtype=torch.float32),
        }
        return {k: v.to(device) for k, v in params.items()}

    def project_inputs(self, params: Params,
                       raw: torch.Tensor) -> torch.Tensor:
        """Eager prefix (Cavs Def. 1): depends on no other vertex."""
        return raw @ params["wx"]

    def gate_spec(self) -> GateSpec:
        """Fusable-gate declaration: lets the scheduler run each batching
        task as ONE fused megastep launch (gather + recurrent matmul +
        gates + block write, K3)."""
        return GateSpec(kind="lstm", hidden=self.hidden,
                        weight_names=("wh", "b"))

    def apply(self, params: Params, io: VertexIO) -> VertexOutput:
        h = self.hidden
        prev = io.gather(0)                      # [M, 2H] (zeros at t=0)
        c_prev, h_prev = prev[:, :h], prev[:, h:]
        if self.cell_impl == "fused":
            # The fully fused level step: recurrent product + gates in one
            # launch (K9).
            c, hy = kops.lstm_level_fused(h_prev, c_prev, io.pull(),
                                          params["wh"], params["b"])
            return VertexOutput(state=torch.cat([c, hy], dim=-1))
        gates = io.pull() + matmul(h_prev, params["wh"]) + params["b"]
        if self.cell_impl == "pallas":
            c, hy = kops.lstm_gates(gates, c_prev)           # K8a
        else:
            i, f, o, u = torch.split(gates, h, dim=-1)
            i, f, o = (torch.sigmoid(i), torch.sigmoid(f + 1.0),
                       torch.sigmoid(o))
            c = f * c_prev + i * torch.tanh(u)
            hy = o * torch.tanh(c)
        return VertexOutput(state=torch.cat([c, hy], dim=-1))


@dataclasses.dataclass(frozen=True)
class GRUVertex:
    """GRU cell as a vertex function (arity 1); state = ``h``.  Param keys
    match the JAX package: ``wx``, ``wh``, ``b``."""

    input_dim: int
    hidden: int

    arity: int = 1

    @property
    def state_dim(self) -> int:
        return self.hidden

    @property
    def ext_dim(self) -> int:
        return 3 * self.hidden

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``); the bias is zero, as in the reference."""
        params = {
            "wx": dense_init(generator, self.input_dim, 3 * self.hidden),
            "wh": dense_init(generator, self.hidden, 3 * self.hidden),
            "b": torch.zeros((3 * self.hidden,), dtype=torch.float32),
        }
        return {k: v.to(device) for k, v in params.items()}

    def project_inputs(self, params: Params,
                       raw: torch.Tensor) -> torch.Tensor:
        return raw @ params["wx"]

    def gate_spec(self) -> GateSpec:
        """Fusable-gate declaration (kind "gru"): one fused megastep
        launch per batching task (K4) — the 3 gate lanes (``z|r|n``,
        reset gate applied inside the candidate tanh) never leave the
        kernel."""
        return GateSpec(kind="gru", hidden=self.hidden,
                        weight_names=("wh", "b"))

    def apply(self, params: Params, io: VertexIO) -> VertexOutput:
        h = self.hidden
        h_prev = io.gather(0)
        xz, xr, xn = torch.split(io.pull(), h, dim=-1)
        hz, hr, hn = torch.split(matmul(h_prev, params["wh"]) + params["b"],
                                 h, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        hy = (1.0 - z) * n + z * h_prev
        return VertexOutput(state=hy)
