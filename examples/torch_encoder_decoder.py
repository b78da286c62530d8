"""Encoder-decoder via push/pull composition (paper §3.1: "declare
multiple vertex functions ... and connect them appropriately"), with the
PyTorch port on one NVIDIA GPU.

The port of ``examples/encoder_decoder.py``.  Two (F, G) structures: an
encoder LSTM over the source chains and a decoder LSTM over the target
chains.  The decoder PULLS the encoder's final state (the cross-structure
external data path): the encoder's root state is fed into the decoder's
external-input rows.  Both run through ``execute``: on the card one LSTM
forward megastep (K3) a level.

Run:  PYTHONPATH=src python3 examples/torch_encoder_decoder.py \\
          [--device cpu] [--hidden 24] [--input-dim 16] [--batch 4]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scheduler import execute, readout_nodes, readout_roots
from repro_torch.core.structure import chain, pack_batch, pack_external
from repro_torch.models.rnn import LSTMVertex

SRC_LEN, TGT_LEN = 10, 7


def make_model(input_dim: int, hidden: int, device):
    """The encoder, the decoder (pulling ``[token | encoder context]`` at
    every step) and their params, from ``torch.Generator`` seeds 0/1."""
    enc = LSTMVertex(input_dim=input_dim, hidden=hidden)
    dec = LSTMVertex(input_dim=input_dim + 2 * hidden, hidden=hidden)
    params = {"enc": enc.init(torch.Generator().manual_seed(0),
                              device=device),
              "dec": dec.init(torch.Generator().manual_seed(1),
                              device=device)}
    return enc, dec, params


def make_data(batch: int, input_dim: int, seed: int = 0):
    """Source inputs ``[SRC_LEN, D]`` and target token embeddings
    ``[TGT_LEN, D]`` per sample, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    src = [rng.standard_normal((SRC_LEN, input_dim)).astype(np.float32)
           * 0.1 for _ in range(batch)]
    tgt = [rng.standard_normal((TGT_LEN, input_dim)).astype(np.float32)
           * 0.1 for _ in range(batch)]
    return src, tgt


def encode_decode(enc, dec, params, src_inputs, tgt_tokens, device,
                  fusion_mode: str = "auto") -> Dict[str, torch.Tensor]:
    """Encoder over the source chains, its root states (the PUSH) pulled
    into every decoder step; returns ``context`` ``[B, 2H]`` and the
    decoder's per-node hidden states ``outs`` ``[B, TGT_LEN, H]``."""
    D, H = enc.input_dim, enc.hidden
    B = len(src_inputs)
    enc_sched = pack_batch([chain(len(x)) for x in src_inputs])
    enc_dev = enc_sched.to_device(device)
    enc_ext = torch.from_numpy(
        pack_external(src_inputs, enc_sched, D)).to(device)
    enc_buf = execute(enc, params["enc"], enc_dev, enc_ext,
                      fusion_mode=fusion_mode).buf
    context = readout_roots(enc_buf, enc_dev)                # [B, 2H]
    ctx = context.cpu().numpy()
    dec_sched = pack_batch([chain(len(t)) for t in tgt_tokens])
    dec_dev = dec_sched.to_device(device)
    dec_inputs = [np.concatenate(
        [tgt_tokens[k], np.repeat(ctx[k][None], len(tgt_tokens[k]), 0)],
        axis=1) for k in range(B)]
    dec_ext = torch.from_numpy(
        pack_external(dec_inputs, dec_sched, D + 2 * H)).to(device)
    dec_buf = execute(dec, params["dec"], dec_dev, dec_ext,
                      fusion_mode=fusion_mode).buf
    outs = readout_nodes(dec_buf, dec_dev)[:, :, H:]         # [B, T, H]
    return {"context": context, "outs": outs}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=24)
    ap.add_argument("--input-dim", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    enc, dec, params = make_model(args.input_dim, args.hidden, args.device)
    src, tgt = make_data(args.batch, args.input_dim)
    out = encode_decode(enc, dec, params, src, tgt, args.device)
    outs = out["outs"]
    print(f"encoder chains {SRC_LEN} steps → context "
          f"[B, {2 * args.hidden}]")
    print(f"decoder chains {TGT_LEN} steps pulling context → outputs "
          f"{tuple(outs.shape)}")
    if not bool(torch.isfinite(outs).all()):
        raise RuntimeError("non-finite decoder outputs")
    print("enc-dec composition OK (two F's, push/pull connected)")
    return out


if __name__ == "__main__":
    main()
