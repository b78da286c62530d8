"""Training launcher (port of ``repro.launch.train``): an arch's LM trained
on a synthetic corpus through ``Trainer``, the training-side end-to-end
entry point.

  - ``--smoke``, or ``--device cpu``: the arch's ``reduced()`` config, as
    the reference reduces it under ``--smoke`` or on a CPU backend;
  - a full config on the card: the reference builds the production mesh
    and the sharded train step here, which the port does not have yet, so
    it raises ``NotImplementedError`` (ROADMAP.md queue 1, item 4).

Runs on the card unless ``--device cpu``.  ``main(argv)`` is importable
and returns ``(state, logger)``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --smoke --steps 200 --batch 8 --seq 128 [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED, reduced
from repro_torch.data import lm_batches, synthetic_corpus
from repro_torch.models.transformer import TransformerLM
from repro_torch.train import MetricLogger, TrainConfig, Trainer

FULL_CONFIG = ("a full config trains over the production mesh and its "
               "sharded train step (the reference's launch/train.py), which "
               "the port does not have yet: ROADMAP.md queue 1, item 4; "
               "pass --smoke")


def make_batches(cfg, batch: int, seq: int, seed: int = 0):
    """Endless ``{tokens, labels}`` batches of a 2,000,000-token synthetic
    corpus.  The reference adds zero image or frame embeddings for vlm and
    enc-dec archs; the port raises on those archs when it builds the model
    (their blocks are ROADMAP.md queue 1's), so it has no frontend stub."""
    yield from lm_batches(synthetic_corpus(2_000_000, cfg.vocab, seed=seed),
                          batch, seq, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ASSIGNED, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (also with --device "
                         "cpu)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not (args.smoke or args.device == "cpu"):
        raise NotImplementedError(f"{cfg.name}: {FULL_CONFIG}")
    cfg = reduced(cfg)
    lm = TransformerLM(cfg)

    tcfg = TrainConfig(lr=args.lr, warmup_steps=min(50, args.steps // 4),
                       total_steps=args.steps, n_micro=args.n_micro,
                       ckpt_dir=args.ckpt_dir, log_every=args.log_every)
    trainer = Trainer(lm.loss, lambda g: lm.init(g, device=args.device),
                      tcfg, device=args.device)
    state = trainer.init_state(0)
    state, _ = trainer.maybe_restore(state)
    logger = MetricLogger(tokens_per_step=args.batch * args.seq)
    state, logger = trainer.fit(
        state, make_batches(cfg, args.batch, args.seq), steps=args.steps,
        logger=logger)
    final = logger.history[-1] if logger.history else {}
    print(f"done: arch={cfg.name} step={state.step} "
          f"loss={final.get('loss', float('nan')):.4f} "
          f"tokens/s={final.get('tokens_per_sec', 0):.0f}")
    return state, logger


if __name__ == "__main__":
    main()
