"""Kernels written by hand for NVIDIA Hopper (``sm_90a``), each beside its
plain PyTorch version:

* mr_sched — the batched IOTSim event loop (the paper's hot path)
* flash_attention — GQA attention with an online softmax (LM prefill)
* rwkv6 — the RWKV6 WKV recurrence (LM prefill and decode)
"""
