"""End-to-end driver of the PyTorch port: train a llama-family model on the
synthetic LM stream with Byzantine workers and Bulyan(Krum), with
checkpointing (the counterpart of ``examples/train_llm.py``, same flags).

    PYTHONPATH=src python examples/train_llm_torch.py --steps 200
    PYTHONPATH=src python examples/train_llm_torch.py --device cpu \\
        --d-model 384 --layers 2 --steps 6 --seq 64 --ckpt /tmp/llm_ckpt

One step is the production path of ``repro_torch.dist.train``: per-worker
gradients (``vmap(grad)``) -> the omniscient attack on the gradient tree
-> tree-aware Bulyan (``distributed_aggregate`` on the ``fused``
backend: K1 per leaf for the distances, the selection kernel once, K4
per leaf) -> AdamW.  It runs on the card unless ``--device cpu`` is
given.  Checkpoints use the reference's format, so either package can
resume the other's.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.dist.train import (DistByzantineSpec,  # noqa: E402
                                    init_agg_state, make_train_step)
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m", arch_type="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab_size=32768, head_dim=64,
        ffn_act="swiglu", layer_pattern=("attn",),
        tie_embeddings=True, param_dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--workers", type=int, default=7)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--gar", default="bulyan-krum")
    ap.add_argument("--stream-vocab", type=int, default=2048,
                    help="vocab of the synthetic Markov stream (smaller "
                         "than the model's 32768 so a few hundred steps "
                         "visibly reduce loss)")
    ap.add_argument("--attack", default="omniscient_linf")
    ap.add_argument("--ckpt", default="artifacts/llm_ckpt_torch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(model_100m(), d_model=args.d_model,
                              n_layers=args.layers,
                              n_heads=args.d_model // 64,
                              n_kv_heads=max(2, args.d_model // 192))
    params = init_model(0, cfg, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params; "
          f"n={args.workers} workers (f={args.f}), gar={args.gar}, "
          f"attack={args.attack}, device={device}")

    opt = get_optimizer("adamw", 3e-4, weight_decay=0.01)
    start = 0
    if args.resume and os.path.exists(os.path.join(args.ckpt,
                                                   "manifest.json")):
        params, start = load_checkpoint(args.ckpt, params)
        params = tree_map(lambda p: p.to(device), params)
        print(f"resumed from step {start}")
    state = opt.init(params)

    spec = DistByzantineSpec(f=args.f, gar=args.gar, attack=args.attack,
                             distance_backend="fused")
    step = make_train_step(cfg, spec, opt)
    # stateful GARs (buffered-*, reputation-*, ...) carry an AggState
    agg_state = init_agg_state(spec, params, args.workers)

    n, b, s = args.workers, args.batch, args.seq
    t0 = time.time()
    for t in range(start, start + args.steps):
        toks, labs = [], []
        for w in range(n):
            x, y = lm_batches(args.stream_vocab, b, s, t * n + w, seed=7)
            toks.append(x)
            labs.append(y)
        batch = {"tokens": np.stack(toks), "labels": np.stack(labs)}
        if agg_state is not None:
            params, state, m, agg_state = step(params, state, batch,
                                               agg_state)
        else:
            params, state, m = step(params, state, batch)
        if t % 10 == 0 or t == start + args.steps - 1:
            dt = time.time() - t0
            tok_s = (t - start + 1) * n * b * s / max(dt, 1e-9)
            print(f"step {t:4d}  loss {float(m['loss']):.4f}  "
                  f"|g| {float(m['grad_norm']):.3f}  "
                  f"byz_w {float(m.get('byz_weight', 0)):.1f}  "
                  f"{tok_s:,.0f} tok/s", flush=True)
    save_checkpoint(args.ckpt, params, step=start + args.steps)
    print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
