"""Batched serving on the PyTorch port: prefill a prompt batch, decode with
KV caches, report per-phase throughput; then use the simulator to predict
pod-scale serving under stragglers (the IOTSim methodology applied to
serving).  The counterpart of ``examples/serve_batch.py``; the weights are
an argument of :func:`serve`, so a caller can pass any tree of the config
(e.g. the JAX package's, through ``repro_torch.models.convert``).

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import ChipSpec, StepCost, workload
from repro_torch.models import ArchConfig, decode_step, init_model, prefill

CFG = ArchConfig(name="serve-demo", family="dense", n_layers=4,
                 d_model=128, n_heads=8, n_kv_heads=4, d_ff=512,
                 vocab=2048, vocab_pad_to=8, dtype="float32")
B, S, DEC = 8, 64, 32


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(params, prompts, device="cuda"):
    """Greedy continuation of ``prompts`` (B, S): prefill, then ``DEC``
    decode steps.  Returns ``(ids (B, DEC + 1) numpy, prefill s, decode
    s)``."""
    prompts = torch.as_tensor(prompts, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, state = prefill(params, CFG, prompts, S + DEC)
    toks = torch.argmax(logits, -1)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out = [toks]
    t0 = time.perf_counter()
    for t in range(S, S + DEC):
        logits, state = decode_step(params, CFG, toks, state, t)
        toks = torch.argmax(logits, -1)
        out.append(toks)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, 1).cpu().numpy(), t_prefill, t_decode


def pod_prediction() -> dict:
    """What the paper's methodology adds: pod-scale decode serving, one
    decode step as one simulated job."""
    chip = ChipSpec()
    cost = StepCost(flops=2e9, hbm_bytes=3e9, collective_bytes=2e8)
    return workload.simulate_training(
        cost, chip, n_devices=256, n_steps=1000, straggler_sigma=0.08,
        checkpoint_secs=0.0)                # serving: no checkpoints


def main(device="cuda", params=None, prompts=None):
    """Serve ``prompts`` with ``params`` (default: weights drawn by
    ``init_model`` from seed 0 on ``device``, prompts from seed 1)."""
    if params is None:
        params = init_model(CFG, torch.Generator(device).manual_seed(0),
                            device=device)
    if prompts is None:
        prompts = torch.randint(0, CFG.vocab, (B, S),
                                generator=torch.Generator().manual_seed(1))
    seqs, t_prefill, t_decode = serve(params, prompts, device)
    assert seqs.shape == (B, DEC + 1)
    assert ((seqs >= 0) & (seqs < CFG.vocab)).all()

    print(f"batch={B} prompt={S} decode={DEC}")
    print(f"prefill: {t_prefill*1e3:8.1f} ms  "
          f"({B*S/t_prefill:,.0f} tok/s, first call)")
    print(f"decode:  {t_decode*1e3:8.1f} ms  "
          f"({B*DEC/t_decode:,.0f} tok/s)")
    print(f"sample continuation ids: {seqs[0][:10].tolist()}")

    pred = pod_prediction()
    print(f"\npod-scale decode prediction (256 chips, lognormal "
          f"sigma=0.08 stragglers):")
    print(f"  ideal step {pred['ideal_step_seconds']*1e3:.2f} ms -> "
          f"straggled {pred['step_seconds']*1e3:.2f} ms "
          f"(x{pred['straggler_slowdown']:.3f}), goodput "
          f"{pred['goodput']:.1%}")
    return seqs, pred


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    main(ap.parse_args().device)
