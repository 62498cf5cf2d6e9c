"""Kernels written by hand for NVIDIA Hopper (``sm_90a``), each beside its
plain PyTorch version:

* mr_sched — the batched IOTSim event loop (the paper's hot path)
"""
