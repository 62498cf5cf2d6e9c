"""ROADMAP C16: six AdamW steps of a reduced rwkv6 against the JAX package
at the hyper-parameters of the smoke's full-width training phase (lr 1e-3,
warmup 10, clip 1.0), with the reference's parameters and batches fed to
both (ROADMAP C13).

The port matches the reference step for step at C7's tolerances: losses
and grad norms at rtol 1e-5, parameters at atol 2e-5 / rtol 1e-5 with at
most 1 in 1000 beyond 1e-7; and every rise or fall of the loss from one
step to the next is the reference's.  A loss that rises in the early steps
of this schedule is then the reference's own conditioning, not a fault of
the port."""
import jax
import numpy as np
import pytest
import torch

from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro.train import trainer as jax_trainer
from repro_torch.models.layers import tree_items
from repro_torch.train import OptConfig, make_train_step, optimizer
from test_torch_train import STEP_TOL, _cfgs, _flat, _params

STEPS = 6
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=STEPS, clip_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_six_adamw_steps_match_the_reference():
    jcfg, cfg = _cfgs("rwkv6-3b")
    jp, tp = _params(jcfg, seed=18)
    jstep = jax_trainer.make_train_step(jcfg, jax_opt.OptConfig(**OPT),
                                        donate=False)
    tstep = make_train_step(cfg, OptConfig(**OPT), device="cpu")
    js, ts = jax_opt.init(jp), optimizer.init(tp)
    dcfg = jax_data.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                               seed=18)
    jl, tl = [], []
    for s in range(STEPS):
        jb = jax_data.batch_at(dcfg, s)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(np.array(v))
                                    for k, v in jb.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} {s}")
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert np.array_equal(np.sign(np.diff(tl)), np.sign(np.diff(jl))), \
        (tl, jl)
    want = _flat(jp)
    beyond = total = 0
    for path, leaf in tree_items(tp):
        np.testing.assert_allclose(leaf.numpy(), want[path],
                                   err_msg=str(path), **STEP_TOL)
        beyond += int((np.abs(leaf.numpy() - want[path]) > 1e-7).sum())
        total += leaf.numel()
    assert beyond <= total // 1000, (beyond, total)
    print("losses", tl, "reference", jl)
