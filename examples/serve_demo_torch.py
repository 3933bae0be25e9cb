"""Batched serving demo of the PyTorch port: continuous batching,
optionally Byzantine-robust (the counterpart of
``examples/serve_demo.py``, same flags plus ``--device``).

Default mode runs the continuous-batching engine over a small
llama-family model with staggered requests:

    PYTHONPATH=src python examples/serve_demo_torch.py

Ensemble mode serves an ensemble of replicas of which the last
``--serve-f`` are poisoned (their parameters rewritten by the training
side's attacks), and compares greedy decode under plain averaging with
the requested robust rule:

    PYTHONPATH=src python examples/serve_demo_torch.py \\
        --ensemble 8 --serve-f 2 --serve-gar bulyan

The poisoned replica flips the argmax stream under ``average``; under
Krum / Bulyan the ensemble's output matches the attack-free run token
for token.  An ensemble below the rule's quorum (Bulyan needs n >= 4f +
3) is raised to the minimum, with a note.  The aggregation runs on the
``fused`` distance backend (the port's aggregation kernels); the demo
runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.agg import AggSpec, quorum  # noqa: E402
from repro_torch.dist.serve_robust import (poison_replicas,  # noqa: E402
                                           replicate_params)
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

#: the ensemble's aggregation runs on the port's fused kernels
DISTANCE_BACKEND = "fused"


def small_model() -> ModelConfig:
    return ModelConfig(
        name="llama-serve-demo", arch_type="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=4096, head_dim=32,
        ffn_act="swiglu", layer_pattern=("attn",),
        tie_embeddings=True, param_dtype="float32",
    )


def make_requests(cfg, n=7):
    rng = np.random.default_rng(0)
    return [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=5 + 3 * i)
                .astype(np.int32), max_new_tokens=8 + 2 * i)
        for i in range(n)
    ]


def main_plain(args):
    cfg = small_model()
    params = init_model(0, cfg, device=args.device)
    engine = ServingEngine(params, cfg, n_slots=4, cache_len=128)
    requests = make_requests(cfg)
    t0 = time.time()
    results = engine.run(requests, max_steps=200)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {total_tokens} tokens in "
          f"{dt:.1f}s with 4 slots")
    for rid in sorted(results):
        print(f"  req {rid}: {len(results[rid])} tokens -> "
              f"{results[rid][:8]}{'...' if len(results[rid]) > 8 else ''}")


def main_ensemble(args):
    cfg = small_model()
    params = init_model(0, cfg, device=args.device)
    n, f = args.ensemble, args.serve_f
    need = quorum(args.serve_gar, f)
    if n < need:
        print(f"note: {args.serve_gar} needs n >= {need} for f={f}; "
              f"raising ensemble from {n} to {need}")
        n = need

    honest = replicate_params(params, n, jitter=args.jitter,
                              generator=torch.Generator().manual_seed(1))
    poisoned = poison_replicas(honest, f, args.poison,
                               scale=args.poison_scale)
    requests = make_requests(cfg, n=4)

    def serve(stacked, gar):
        spec = AggSpec(f=f, gar=gar, distance_backend=DISTANCE_BACKEND)
        eng = ServingEngine(stacked, cfg, n_slots=4, cache_len=128,
                            ensemble=spec)
        reqs = [Request(rid=r.rid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens) for r in requests]
        t0 = time.time()
        out = eng.run(reqs, max_steps=200)
        return out, time.time() - t0

    print(f"ensemble of {n} replicas, last {f} poisoned "
          f"({args.poison}, scale={args.poison_scale}), "
          f"gar={args.serve_gar}")
    clean, dt_c = serve(honest, args.serve_gar)
    att_gar, dt_g = serve(poisoned, args.serve_gar)
    att_avg, dt_a = serve(poisoned, "average")
    toks = sum(len(v) for v in clean.values())
    print(f"  {toks} tokens/run in {dt_c:.1f}s (clean) / {dt_g:.1f}s "
          f"({args.serve_gar} under attack) / {dt_a:.1f}s (average)")
    robust_ok = all(att_gar[r] == clean[r] for r in clean)
    avg_flipped = any(att_avg[r] != clean[r] for r in clean)
    for rid in sorted(clean):
        mark_g = "==" if att_gar[rid] == clean[rid] else "!="
        mark_a = "==" if att_avg[rid] == clean[rid] else "!="
        print(f"  req {rid}: no-attack {clean[rid][:6]}... | "
              f"{args.serve_gar} {mark_g} no-attack | average {mark_a} "
              f"no-attack")
    print(f"{args.serve_gar} rejects the poisoned replica: "
          f"{'YES' if robust_ok else 'NO'}")
    print(f"average is steered by the poisoned replica: "
          f"{'YES' if avg_flipped else 'NO'}")
    if not (robust_ok and avg_flipped):
        raise SystemExit("demo expectation failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ensemble", type=int, default=0,
                    help="ensemble size (0 = plain single-model demo)")
    ap.add_argument("--serve-f", type=int, default=2,
                    help="number of poisoned replicas / declared bound")
    ap.add_argument("--serve-gar", default="bulyan",
                    help="robust aggregation rule (any repro_torch.agg name)")
    ap.add_argument("--poison", default="signflip",
                    help="parameter attack on the last f replicas")
    ap.add_argument("--poison-scale", type=float, default=10.0)
    ap.add_argument("--jitter", type=float, default=1e-3,
                    help="honest replica jitter (independent fine-tunes)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.ensemble > 0:
        main_ensemble(args)
    else:
        main_plain(args)


if __name__ == "__main__":
    main()
