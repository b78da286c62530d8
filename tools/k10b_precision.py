#!/usr/bin/env python3
"""How far two formulations of the attention backward land from a float64
evaluation on trained activations: the measurement behind the design of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` (PERF.md, PR 36).

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/k10b_precision.py

It trains ``examples/torch_train_lm.py``'s model for ``chip_smoke.py``'s
30 steps (phase 22's arguments), keeps every K10-backward call's inputs,
and on each computes dQ, dK and dV

  - by the kernel (``flash_attention.flash_attention_bwd``);
  - by autograd of ``ref.mha`` at f32 (the plain version);
  - "from_o": the usual flash backward, P = exp(S - lse) as it stands and
    Delta = rowsum(dO o O) from the forward kernel's output;
  - "renorm": P normalised by its own row sum and Delta = rowsum(P o dP),
    what the kernel and ``ref.mha_bwd`` compute;

the last two in f32 with plain products and with each product as the
kernel's three TF32 products (x = big + small, small.big + big.small +
big.big; the tensor core's truncating sum not modelled).  One JSON line
gives, for each, the largest max |err| / max |f64| over the calls and
the three gradients, and the calls over 1e-5 against the f64 evaluation
and against autograd of ``ref.mha``.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.argv = [sys.argv[0]]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def tf32_split(x: torch.Tensor):
    """x = big + small, each rounded to TF32 as the kernels' ``split``."""
    big = ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    small = x - big
    small = ((small.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return big, small


def product(eq: str, a: torch.Tensor, b: torch.Tensor, tf32x3: bool):
    if not tf32x3:
        return torch.einsum(eq, a, b)
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)) \
        + torch.einsum(eq, ab, bb)


def formulation(args, kw, o, renorm: bool, tf32x3: bool):
    q, k, v, lse, do = args
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5
    valid = ref.mha_valid(Sq, Sk, kw["causal"], kw["window"], q.device)
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = product("bhqd,bhkd->bhqk", q, kk, tf32x3) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = product("bhqd,bhkd->bhqk", do, vv, tf32x3)
    if renorm:
        p = p / p.sum(-1, keepdim=True)
        delta = (p * dp).sum(-1, keepdim=True)
    else:
        delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = product("bhqk,bhkd->bhqd", ds, kk, tf32x3) * scale
    dk = product("bhqk,bhqd->bhkd", ds, q, tf32x3) * scale
    dv = product("bhqk,bhqd->bhkd", p, do, tf32x3)
    return (dq, dk.view(B, Hkv, g, Sk, D).sum(2),
            dv.view(B, Hkv, g, Sk, D).sum(2))


def rel(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()
                     / w.double().abs().max()) for g, w in zip(got, want))


def main() -> None:
    cs._build.build_all(["flash_attention_bwd", "flash_attention_tf32"])
    ex = cs.load_example("torch_train_lm")
    with cs.BwdTap() as tap:
        ex.main(cs.LM_TRAIN_ARGS)
    names = ("kernel", "autograd_f32", "from_o_f32", "from_o_tf32x3",
             "renorm_f32", "renorm_tf32x3")
    worst = {n: 0.0 for n in names}
    over64 = {n: 0 for n in names}
    over_plain = {n: 0 for n in names}
    with torch.no_grad():
        for args, kw in tap.calls:
            q, k, v, lse, do = args
            o = fa.flash_attention(q, k, v, **kw)
            truth = cs.k10b_f64(args, kw)
            plain = cs.k10b_plain(args, kw)
            got = {"kernel": fa.flash_attention_bwd(*args, **kw),
                   "autograd_f32": plain}
            for renorm in (False, True):
                for x3 in (False, True):
                    name = (f"{'renorm' if renorm else 'from_o'}_"
                            f"{'tf32x3' if x3 else 'f32'}")
                    got[name] = formulation(args, kw, o, renorm, x3)
            for name, g in got.items():
                r = rel(g, truth)
                worst[name] = max(worst[name], r)
                over64[name] += r > 1e-5
                over_plain[name] += rel(g, plain) > 1e-5
    print(json.dumps({"calls": len(tap.calls),
                      "card": torch.cuda.get_device_name(0),
                      "max_rel_err_vs_f64": worst,
                      "calls_over_1e-5_vs_f64": over64,
                      "calls_over_1e-5_vs_autograd_f32": over_plain}))


if __name__ == "__main__":
    main()
