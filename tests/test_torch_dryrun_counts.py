"""ROADMAP C14: the dry run's per-device FLOPs of a reduced rwkv6 cell and
a reduced MoE cell on a 2x2 mesh against the FLOPs of the reference's
compiled products on 4 host devices (one layer, global batch 8).

Equal where the port lays the products out as GSPMD does (rwkv6 at one
token: the ``embed x embed2`` gate's output and the decay LoRA's
contraction are split over ``model``, ``rules.split_over_model``).  Each
remaining gap is declared in ROADMAP C14 and pinned here to its formula:

* a ``lax.scan`` of T steps is one while loop whose body XLA counts once:
  the WKV recurrence's per-step product, 2 (B/2)(H/2) hs^2, counts once
  in the reference and T times in the port;
* rwkv6 decode: the reference splits the mix LoRA's down-projection
  contraction over ``model`` in a decode step (and not in prefill), the
  port keeps the prefill layout: 2 (B/2)(D/2)(5 mix_lora) more;
* MoE: the reference splits the router's expert dim over ``model`` and
  gathers the logits for the top-k; the port routes shard-locally with
  the router whole: 2 tokens (D)(E/2) more per device, tokens = (B/2) S.
"""
import pytest

from repro_torch import configs
from test_torch_dryrun_c15 import _PORT, _REF, _run


def _dims(arch):
    return configs.get(arch).reduced(n_layers=1)


def _gap(arch, shape, seq, batch):
    cfg = _dims(arch)
    b = batch // 2                       # the batch over data
    if arch == "rwkv6-3b":
        hs = cfg.rwkv.head_size
        h = cfg.d_model // hs
        step = 2 * b * (h // 2) * hs * hs
        if shape == "decode_32k":
            return 2 * b * (cfg.d_model // 2) * 5 * cfg.rwkv.mix_lora
        return (seq - 1) * step
    tokens = b * (1 if shape == "decode_32k" else seq)
    return 2 * tokens * cfg.d_model * cfg.moe.n_experts // 2


# (arch, shape, seq): one layer, global batch 8, a 2x2 mesh
CELLS = [
    ("rwkv6-3b", "prefill_32k", 1),      # every loop one trip: equal
    ("rwkv6-3b", "prefill_32k", 64),     # the WKV loop counted once
    ("rwkv6-3b", "decode_32k", 64),      # the mix LoRA in decode
    ("mixtral-8x7b", "prefill_32k", 64),     # the router
    ("mixtral-8x7b", "decode_32k", 64),
]


@pytest.mark.parametrize("arch,shape,seq", CELLS)
def test_flops_per_device_against_reference(arch, shape, seq):
    args = (arch, shape, "2x2", seq, 8, 1)
    got = _run(_PORT, *args)["flops"]
    ref = _run(_REF, *args, jax_env=True)["dot_flops"]
    gap = _gap(arch, shape, seq, 8)
    assert got - ref == gap, (got, ref, gap)
    assert gap == 0 or got > ref
