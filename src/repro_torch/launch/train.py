"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant training loop (``repro_torch.train``) on one
device, with reduced or full configs, as the JAX package's
``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --steps 3 --seq-len 512 --global-batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --reduced --device cpu --steps 50 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.train import OptConfig, TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.arch_names())
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = (cfg.reduced(n_layers=4, attn_every=4)
               if cfg.family == "hybrid" else cfg.reduced())
        cfg = cfg.replace(dtype="float32")
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={args.device}")

    tc = TrainConfig(steps=args.steps, seed=args.seed, seq_len=args.seq_len,
                     global_batch=args.global_batch,
                     opt=OptConfig(lr=args.lr, warmup_steps=10),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    h = train(cfg, tc, device=args.device)
    print(f"steps={args.steps} resumed_at={h['resumed_at']} "
          f"restarts={h['restarts']} "
          f"loss {h['loss'][0]:.4f} -> {h['final_loss']:.4f}")
    return h


if __name__ == "__main__":
    main()
