"""End-to-end training on the PyTorch port: data pipeline -> train loop
-> checkpoints, with fault tolerance on; the counterpart of
``examples/train_lm.py``.

Presets:
  smoke  —   ~6M-param model,  60 steps: seconds on the card, minutes on
             a CPU;
  100m   — ~100M-param dense model, 300 steps (the loop and checkpoint
             logic are the smoke preset's, only the config differs).

    PYTHONPATH=src python examples/train_lm_torch.py --preset smoke
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3

The starting weights are an argument of :func:`run` (default: drawn from
the run's seed), so a caller can pass any tree of the preset's config.
"""
import argparse
import math
import os
import tempfile

from repro_torch.models import ArchConfig, abstract_model
from repro_torch.train import OptConfig, TrainConfig, train

PRESETS = {
    "smoke": dict(
        cfg=ArchConfig(name="lm-smoke", family="dense", n_layers=4,
                       d_model=128, n_heads=8, n_kv_heads=4, d_ff=512,
                       vocab=2048, vocab_pad_to=8, dtype="float32"),
        steps=60, seq_len=128, global_batch=8, lr=1e-3),
    "100m": dict(
        cfg=ArchConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                       vocab=32768, vocab_pad_to=128, dtype="float32"),
        steps=300, seq_len=512, global_batch=16, lr=6e-4),
}


def run(preset="smoke", steps=None, ckpt_dir=None, device="cuda",
        params=None) -> dict:
    """Train ``preset`` for ``steps`` (default: the preset's) on
    ``device`` from ``params`` (default: drawn from seed 0), committing
    checkpoints under ``ckpt_dir`` (default: the temporary directory).
    Returns the loop's history."""
    p = PRESETS[preset]
    cfg = p["cfg"]
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_train_lm_torch")
    n_params = sum(math.prod(t.shape) for t in _leaves(abstract_model(cfg)))
    tc = TrainConfig(
        steps=steps or p["steps"], seq_len=p["seq_len"],
        global_batch=p["global_batch"],
        opt=OptConfig(lr=p["lr"], warmup_steps=20),
        ckpt_dir=f"{ckpt_dir}/{cfg.name}", ckpt_every=50, log_every=10)

    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{tc.steps} steps, batch {tc.global_batch}x{tc.seq_len}, "
          f"device {device}")
    hist = train(cfg, tc, device=device, params=params, resume=False)
    losses = hist["loss"]
    print(f"resumed_at={hist['resumed_at']} restarts={hist['restarts']} "
          f"stragglers={hist['straggler_steps']}")
    k = min(5, len(losses))
    print(f"loss: first{k}={sum(losses[:k])/k:.4f} "
          f"last{k}={sum(losses[-k:])/k:.4f} final={hist['final_loss']:.4f}")
    assert all(math.isfinite(x) for x in losses), "loss should be finite"
    assert losses[-1] < losses[0], "loss should decrease"
    print("checkpoints committed under", ckpt_dir)
    return hist


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    a = ap.parse_args()
    run(a.preset, a.steps, a.ckpt_dir, a.device)
