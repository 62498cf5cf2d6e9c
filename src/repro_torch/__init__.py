"""IOTSim on PyTorch and CUDA: the port of the JAX package ``repro``.

The sweep path runs end to end, open loop and closed loop (failures,
autoscale, deadlines, preemption): ``core.sweep.SweepPlan.run`` encodes a
grid into a ``ScenarioArrays`` batch, steps it through the hand-written
``mr_epoch`` CUDA kernels on the card (their plain PyTorch version on the
CPU) and reduces it into a labelled ``SweepResult``.  Traced, the same
kernels record each lane's per-epoch time series and event log
(``core.telemetry``); ``kernels.mr_sched.ops.schedule`` runs the
fixed-epoch ``mr_schedule`` kernel.  ``models`` and ``configs`` serve
every family of the LM substrate (``prefill``, ``decode_step``), attention
through the hand-written ``flash_attention`` kernel and RWKV6 through
``wkv6``; ``models.loss_fn`` and ``train`` train them (AdamW, data,
checkpoints, the fault-tolerant loop; ``launch.train``), RWKV6's gradient
through the hand-written ``wkv6_bwd`` kernel.  Entry points take
``device=`` and default to ``"cuda"``.
"""
__version__ = "0.1.0"
