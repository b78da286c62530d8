"""End-to-end LM training on the port (``examples/train_lm.py`` in
PyTorch): a ~100M-parameter transformer trained for a few hundred steps
with the full stack -- synthetic corpus, ``AsyncPacker`` staging batches
onto the device, AdamW + warmup-cosine, gradient accumulation, async
checkpointing, metric logging, auto-resume.  On the card every attention
layer runs K10 forward and K10's hand-written backward (f32).

Run:  PYTHONPATH=src python examples/torch_train_lm.py \\
          [--steps 300] [--ckpt /tmp/lm_ckpt] [--device cpu]

``main(argv)`` is importable and returns ``(state, logger)``;
``model_config()`` is the model it trains.
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import reduced
from repro_torch.data import lm_batches, synthetic_corpus
from repro_torch.models.transformer import TransformerLM
from repro_torch.pipeline import AsyncPacker
from repro_torch.train import MetricLogger, TrainConfig, Trainer


def model_config():
    """~100M params: the reduced granite config widened (8 layers,
    d_model 512, 8/4 heads of 64, d_ff 1,536, vocab 8,192, f32)."""
    return dataclasses.replace(
        reduced(get_config("granite-3-8b")),
        name="granite-100m", num_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=8192, head_dim=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_config()
    lm = TransformerLM(cfg)
    n_params = cfg.param_count()
    print(f"arch={cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={args.batch}×{args.seq} tokens, "
          f"n_micro={args.n_micro}")

    trainer = Trainer(
        lm.loss, lambda g: lm.init(g, device=args.device),
        TrainConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps,
                    n_micro=args.n_micro, ckpt_dir=args.ckpt,
                    ckpt_every=100, log_every=args.log_every),
        device=args.device)
    state = trainer.init_state(0)
    state, start = trainer.maybe_restore(state)
    if start:
        print(f"resumed from checkpoint at step {start}")

    corpus = synthetic_corpus(3_000_000, cfg.vocab, seed=0)
    # The schedule pipeline's async packing stage doubles as a device
    # stager for plain token batches: host batch assembly and the copy to
    # the device overlap the previous step's compute (Trainer.fit closes
    # the background producer when the loop exits).
    batches = AsyncPacker(
        lm_batches(corpus, args.batch, args.seq, seed=0),
        lambda b: {k: torch.from_numpy(v).to(args.device)
                   for k, v in b.items()},
        depth=2)
    logger = MetricLogger(tokens_per_step=args.batch * args.seq)
    state, logger = trainer.fit(state, batches, steps=args.steps,
                                logger=logger)
    first = next(r for r in logger.history if "loss" in r)
    last = logger.history[-1]
    print(f"loss {first['loss']:.3f} → {last['loss']:.3f} over "
          f"{state.step} steps "
          f"({last.get('tokens_per_sec', 0):.0f} tok/s)")
    assert last["loss"] < first["loss"], "training must make progress"
    return state, logger


if __name__ == "__main__":
    main()
