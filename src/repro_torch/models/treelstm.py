"""Tree-structured vertex functions, PyTorch port of
``repro.models.treelstm``: the N-ary child-sum Tree-LSTM (paper Fig. 4)
and the Tree-FC benchmark cell (paper §5, from the Fold loom
benchmarks).

The Tree-LSTM follows Tai et al. exactly as transcribed in the paper's
Fig. 4: per-child forget gates against the *individual* child hidden
states, remaining gates against the child-sum.  The scattered state is
``concat([c, h])`` (Fig. 4 L18).  ``cell_impl="pallas"`` runs its gate
chain in one kernel (``ops.treelstm_gates``: K8b, forward only on the
card, as in the reference) on the op-by-op leg; the fused leg runs the K1
megastep whatever the ``cell_impl``.

A bf16 node buffer meets float32 params as in the JAX package: the
masked child states and their sum stay bf16, each product promotes to
float32 (:func:`~repro_torch.models.layers.matmul`), and the gate math
runs in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vertex import GateSpec, Params, VertexIO, VertexOutput
from repro_torch.interop import pack_recurrent
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, matmul


@dataclasses.dataclass(frozen=True)
class TreeLSTMVertex:
    """N-ary child-sum Tree-LSTM (Cavs Fig. 4), arity ``N``.

    State: ``[c | h]`` (width ``2*hidden``); external: token embedding
    rows of width ``input_dim``, eagerly projected to the 4 gate lanes.
    Param keys match the JAX package: ``wx``, ``ui``, ``uf``, ``uo``,
    ``uu``, ``b``.  ``cell_impl``: ``"jnp"`` (plain gate math) or
    ``"pallas"`` (the K8b gate kernel).
    """

    input_dim: int
    hidden: int
    arity: int = 2
    cell_impl: str = "jnp"

    @property
    def state_dim(self) -> int:
        return 2 * self.hidden

    @property
    def ext_dim(self) -> int:
        return 4 * self.hidden

    def init(self, generator: torch.Generator,
             device="cuda") -> Params:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``), with the recurrent weights packed for the fused
        kernel (:func:`repro_torch.interop.pack_recurrent`)."""
        h = self.hidden
        params = {
            # W^(i)|W^(f)|W^(o)|W^(u) stacked: one eager matmul for all gates.
            "wx": dense_init(generator, self.input_dim, 4 * h),
            "ui": dense_init(generator, h, h),
            "uf": dense_init(generator, h, h),
            "uo": dense_init(generator, h, h),
            "uu": dense_init(generator, h, h),
            "b": torch.zeros((4 * h,), dtype=torch.float32),
        }
        return pack_recurrent({k: v.to(device) for k, v in params.items()})

    def project_inputs(self, params: Params,
                       raw: torch.Tensor) -> torch.Tensor:
        """Eager prefix: ``x @ [W_i W_f W_o W_u]`` — Fig. 7's `pull` branch."""
        return raw @ params["wx"]

    def gate_spec(self) -> GateSpec:
        """Fusable-gate declaration: each batching task runs as ONE
        fused megastep launch (``kernels/level_megastep.py``)."""
        return GateSpec(kind="treelstm", hidden=self.hidden,
                        weight_names=("ui", "uf", "uo", "uu", "b"))

    def apply(self, params: Params, io: VertexIO) -> VertexOutput:
        h = self.hidden
        xi, xf, xo, xu = torch.split(io.pull(), h, dim=-1)
        bi, bf, bo, bu = torch.split(params["b"], h)

        # Fig. 4 L2-6: gather children, split into (c_k, h_k), child-sum h.
        M, A = io.num_slots, io.arity
        cs = io.child_states * io.child_mask[..., None]       # [M, A, 2H]
        c_k, h_k = cs[..., :h], cs[..., h:]
        h_sum = torch.sum(h_k, dim=1)                         # Σ_k h_k
        rec_f = matmul(h_k.reshape(M * A, h), params["uf"]).reshape(M, A, h)

        if self.cell_impl == "pallas":
            c, hy = kops.treelstm_gates(                       # K8b
                xi + matmul(h_sum, params["ui"]) + bi,
                # per-child forget pre-activations [M, A, H]:
                xf[:, None, :] + rec_f + bf,
                xo + matmul(h_sum, params["uo"]) + bo,
                xu + matmul(h_sum, params["uu"]) + bu,
                c_k, io.child_mask)
            return VertexOutput(state=torch.cat([c, hy], dim=-1))
        i = torch.sigmoid(xi + matmul(h_sum, params["ui"]) + bi)
        # Fig. 4 L9-11: one forget gate per child against h_k.
        f = torch.sigmoid(xf[:, None, :] + rec_f + bf)
        o = torch.sigmoid(xo + matmul(h_sum, params["uo"]) + bo)
        u = torch.tanh(xu + matmul(h_sum, params["uu"]) + bu)
        c = i * u + torch.sum(f * c_k * io.child_mask[..., None], dim=1)
        hy = o * torch.tanh(c)
        return VertexOutput(state=torch.cat([c, hy], dim=-1))


@dataclasses.dataclass(frozen=True)
class TreeFCVertex:
    """The Tree-FC benchmark cell (paper §5 'Models'): a single
    fully-connected layer over the concatenated child states, plus the
    leaf embedding path.  Binary trees (arity 2).  Param keys match the
    JAX package: ``wx``, ``wc``, ``b``."""

    input_dim: int
    hidden: int
    arity: int = 2

    @property
    def state_dim(self) -> int:
        return self.hidden

    @property
    def ext_dim(self) -> int:
        return self.hidden

    def init(self, generator: torch.Generator,
             device="cuda") -> Params:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``); the bias is zero, as in the reference."""
        params = {
            "wx": dense_init(generator, self.input_dim, self.hidden),
            "wc": dense_init(generator, self.arity * self.hidden,
                             self.hidden),
            "b": torch.zeros((self.hidden,), dtype=torch.float32),
        }
        return {k: v.to(device) for k, v in params.items()}

    def project_inputs(self, params: Params,
                       raw: torch.Tensor) -> torch.Tensor:
        return raw @ params["wx"]

    def gate_spec(self) -> GateSpec:
        """Fusable-gate declaration (kind "treefc", K5).  The concat
        weight fixes the gather arity, so the fused path only engages
        when the packed schedule's ``A`` equals ``self.arity`` (the
        scheduler keeps the op-by-op path otherwise under
        ``fusion_mode="auto"`` and raises under ``"megastep"``)."""
        return GateSpec(kind="treefc", hidden=self.hidden,
                        weight_names=("wc", "b"), arity=self.arity)

    def apply(self, params: Params, io: VertexIO) -> VertexOutput:
        M = io.num_slots
        cs = (io.child_states * io.child_mask[..., None]).reshape(M, -1)
        hy = torch.tanh(matmul(cs, params["wc"]) + io.pull() + params["b"])
        return VertexOutput(state=hy)
