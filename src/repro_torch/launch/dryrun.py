"""Multi-pod dry run: build and run every (arch × shape × mesh) cell on
fake tensors laid out by the sharding rules, allocating nothing.

The counterpart of the JAX package's ``repro/launch/dryrun.py``.  Per cell
the dry run:

1. builds the abstract inputs (``configs.input_specs``, meta tensors) and
   resolves their placements on the production mesh
   (``repro_torch.sharding.rules``);
2. makes each one a ``DTensor`` of fake local shards (``FakeTensorMode``)
   on that mesh, whose ``fake`` process group records collectives and
   sends none, and runs the cell's step once, eagerly:
     train_*   → microbatched loss + grad + AdamW update (in place),
     prefill_* → prefill forward (logits + materialized KV/SSM state),
     decode_*  → one-token ``decode_step`` against the full-length state;
   attention runs ``attn_impl="chunked"`` as the reference lowers it;
3. counts what device rank 0 does on its local shards under a dispatch
   mode: ``flops`` (matrix products, ``FlopCounterMode``'s formulas),
   ``bytes_accessed`` (each non-view op's operand and result bytes,
   unfused), the peak of live local bytes beyond the arguments
   (``memory.temp_bytes``), and every collective (``comm_stats``);
4. appends the record to a JSON results file (incremental: re-runs skip
   completed cells) with the reference's keys.

Eager execution runs every layer and every microbatch, so the counts need
no depth or trip-count correction; ``--variants`` still writes the
1-period / 0-period records (``--depth L1`` / ``L0`` writes only that
one).  ``memory.code_bytes`` is ``null``: eager torch generates no code.

An op ``DTensor`` has no sharding strategy for fails its cell: nothing is
re-laid out behind the model's back.  The model code lays out explicitly
what GSPMD partitions on its own in the reference:

* a product's input is gathered to its batch shards first
  (``sharding.batch_only``: the sequence-parallel residual's SP→TP
  all-gather), and the gradient of a product that joins the residual is
  laid out so too (``batch_only_grad``);
* chunked attention runs per (batch, query-head) shard, or per (batch,
  query-row) shard where the heads do not divide the ``model`` axis
  (``attention.sharded_chunked_sdpa``), each shard taking the kv heads it
  reads;
* the cross-entropy keeps the vocab split: max and sum-exp reduced across
  the shards, each shard picking the labels it holds
  (``sharding.take_last``); the embedding lookup is row-parallel
  (``gather_rows``);
* regions run on local shards (``sharding.shard_local``): MoE's routing,
  sort, gather and scatter per dispatch group; the Mamba time loop per
  (batch, inner-channel) shard; the WKV6 loop per (batch, head) shard, per
  batch shard only where the heads do not divide ``model`` (rwkv6-3b's 40
  heads on 16); the RWKV token shift per batch shard; the decode cache
  writes go to the shard holding the slot (``write_index``).

The production mesh opens a 512-rank ``fake`` default process group in
this process, so run the dry run in a process of its own.

Usage:
  python -m repro_torch.launch.dryrun --all --variants --out dryrun.json
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multi-pod
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs, loops
from ..models import abstract_model, loss_fn, model_axes
from ..models.layers import tree_items, tree_map
from ..models.model import decode_step, prefill
from ..models.stacks import _pattern_period
from ..sharding import rules
from ..train import optimizer
from . import comm_stats
from .mesh import make_production_mesh

F32 = torch.float32

# Perf toggles of the reference (its EXPERIMENTS.md §Perf), same defaults.
PERF = {
    "bf16_params": True,     # bf16 compute-params: halve weight-gather wire
    "kv_seq_shard": True,    # flash-decoding cache layout
    "serve_no_fsdp": True,   # serving weights not data-sharded
    "fsdp2": False,          # train: pure-FSDP weights, no activation TP
}


def _cast_params(params):
    if not PERF["bf16_params"]:
        return params
    return tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == F32
                    else p, params)


def _serve_weight_rules(cfg, global_batch: int = 1 << 30):
    """Serving weights: replicating over `data` kills the per-step weight
    all-gathers — but only when it fits and amortizes.  Keep FSDP when
    (a) the batch doesn't occupy the data axis (long_500k: streaming the
    replicated weights per token costs more than gathering shards), or
    (b) the arch is MoE (total expert params de-replicated over data are
    what keeps 50-100B-total models inside 16 GiB; only top-k experts
    activate per token, so gathers stay proportional to *active* use)."""
    if not PERF["serve_no_fsdp"] or global_batch < 16 or cfg.moe is not None:
        return rules.WEIGHT_RULES
    r = dict(rules.WEIGHT_RULES)
    r.pop("embed", None)     # no optimizer in serving: replicate over data
    r.pop("embed2", None)
    return r


def _param_shardings(mesh, cfg, *, serve: bool = False,
                     global_batch: int = 1 << 30):
    """(meta parameter tree, placements tree)."""
    sds = abstract_model(cfg)
    if serve and PERF["bf16_params"]:
        # serving keeps weights in bf16 (no optimizer): reading the f32
        # master + converting per step costs 3x the HBM traffic
        sds = tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == F32
                       else a, sds)
    rl = _serve_weight_rules(cfg, global_batch) if serve else (
        rules.WEIGHT_RULES_FSDP2 if PERF["fsdp2"] else rules.WEIGHT_RULES)
    return sds, rules.tree_shardings(mesh, model_axes(cfg), sds, rules=rl)


def _batch_axes_for(mesh):
    """Under FSDP2 the batch is data-parallel over every mesh axis."""
    if PERF["fsdp2"]:
        return tuple(rules.as_mesh(mesh).axis_names)
    return rules.batch_axes(mesh)


def _batch_placements(mesh, shape):
    ba = _batch_axes_for(mesh)
    spec = ((ba,) if shape and shape[0] % _prod(mesh, ba) == 0
            else (None,)) + (None,) * (len(shape) - 1)
    return rules.placements(mesh, spec if shape else ())


def _batch_shardings(mesh, batch_sds):
    if isinstance(batch_sds, dict):
        return {k: _batch_shardings(mesh, v) for k, v in batch_sds.items()}
    return _batch_placements(mesh, tuple(batch_sds.shape))


def _prod(mesh, axes):
    shape = rules.as_mesh(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def microbatches(cfg, spec, batch_shards: int = 16) -> int:
    """Gradient-accumulation depth per train step (memory knob: jamba's
    heterogeneous 8-block period holds the most live state).  Capped so
    each microbatch stays divisible by the (pod x data) shard extent —
    an indivisible microbatch would silently replicate activations."""
    if spec.kind != "train":
        return 1
    if cfg.family == "hybrid":
        n = 16
    elif cfg.moe is not None:
        n = 4
    else:
        n = 2
    return max(1, min(n, spec.global_batch // batch_shards))


def _replicated(mesh, shape):
    return rules.placements(mesh, (None,) * len(shape))


def build_cell(cfg, shape_name: str, mesh):
    """Returns (fn, args, placements, donate) for one cell: ``args`` are
    meta-tensor trees, ``placements`` their layouts on ``mesh``."""
    spec = configs.SHAPES[shape_name]
    ins = configs.input_specs(cfg, shape_name)

    if spec.kind == "train":
        params_sds, psh = _param_shardings(mesh, cfg)
        step = torch.empty((), dtype=torch.int32, device="meta")
        opt_sds = optimizer.OptState(step=step, m=params_sds, v=params_sds)
        osh = optimizer.OptState(step=_replicated(mesh, ()), m=psh, v=psh)
        bsh = _batch_shardings(mesh, ins["batch"])
        opt_cfg = optimizer.OptConfig(total_steps=10_000)
        n_micro = microbatches(cfg, spec, _prod(mesh, _batch_axes_for(mesh)))
        act_rules = rules.ACT_RULES_FSDP2 if PERF["fsdp2"] else None

        def train_step(params, opt_state, batch):
            # gradient accumulation as a loop (the reference scans it):
            # microbatch i takes every n_micro-th row, so each device's
            # rows stay its own (no collective), and every microbatch is
            # counted (``loops.scan``: the dry run runs two and counts the
            # second for the rest).  Activation memory is bounded at one
            # microbatch.
            with rules.mesh_ctx(mesh, act_rules,
                                batch=spec.global_batch // n_micro):
                params_c = _cast_params(params)
                leaves = [(path, p.detach().requires_grad_())
                          for path, p in tree_items(params_c)]
                tree = dict(leaves)
                params_c = _rebuild(params_c, tree)
                grads = {path: torch.zeros_like(p, dtype=F32)
                         for path, p in tree_items(params)}
                placement = {path: p.placements
                             for path, p in tree_items(params)}

                def micro(loss, i):
                    mb = {k: a.unflatten(0, (-1, n_micro))[:, i]
                          for k, a in batch.items()}
                    li = loss_fn(params_c, cfg, mb, attn_impl="chunked")
                    gi = torch.autograd.grad(li, [p for _, p in leaves],
                                             allow_unused=True)
                    for (path, _), g in zip(leaves, gi):
                        if g is None:        # e.g. an encoder's embedding
                            continue
                        g = g.redistribute(g.device_mesh, placement[path])
                        grads[path] += g.to(F32)
                    return loss + li.detach(), None

                loss, _ = loops.scan(micro, torch.zeros((), dtype=F32),
                                     n_micro)
                scale = 1.0 / n_micro
                grads = _rebuild(params, {k: g * scale
                                          for k, g in grads.items()})
                params, opt_state, _ = optimizer.update(
                    opt_cfg, grads, opt_state, params)
            return params, opt_state, loss * scale

        return (train_step, (params_sds, opt_sds, ins["batch"]),
                (psh, osh, bsh), (0, 1))

    if spec.kind == "prefill":
        params_sds, psh = _param_shardings(mesh, cfg, serve=True,
                                           global_batch=spec.global_batch)
        bsh = _batch_shardings(mesh, ins["inputs"])
        cache_len = configs.decode_cache_len(cfg, spec.seq_len)

        def prefill_step(params, inputs):
            with rules.mesh_ctx(mesh, batch=spec.global_batch):
                return prefill(_cast_params(params), cfg, inputs,
                               cache_len, attn_impl="chunked")

        return prefill_step, (params_sds, ins["inputs"]), (psh, bsh), ()

    # decode
    params_sds, psh = _param_shardings(mesh, cfg, serve=True,
                                       global_batch=spec.global_batch)
    st_sds = ins["state"]
    st_rules = rules.STATE_RULES if PERF["kv_seq_shard"] else rules.ACT_RULES
    st_sh = rules.tree_shardings(mesh, rules.state_axes(st_sds), st_sds,
                                 rules=st_rules)
    tok_sh = _batch_shardings(mesh, ins["tokens"])
    t = spec.seq_len - 1        # the last position of the full-length state

    def serve_step(params, tokens, state):
        with rules.mesh_ctx(mesh, batch=spec.global_batch):
            return decode_step(_cast_params(params), cfg, tokens, state, t)

    return (serve_step, (params_sds, ins["tokens"], st_sds),
            (psh, tok_sh, st_sh), (2,))


def _rebuild(like, flat: dict):
    """``like``'s nested dicts with the leaves of ``flat`` (keyed by
    path)."""
    def go(node, prefix):
        return {k: go(v, prefix + (k,)) if isinstance(v, dict)
                else flat[prefix + (k,)] for k, v in node.items()}
    return go(like, ())


# ---------------------------------------------------------------------------
# Counting a cell
# ---------------------------------------------------------------------------

def _tensors(tree):
    """The tensor leaves of nested dicts / tuples / named tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, tuple):
        return tuple(_detach(t) for t in tree)
    return tree


def _node_mark() -> int:
    """The sequence number of an autograd node made now: every node made
    later has a larger one."""
    with torch.enable_grad():
        x = torch.empty(0, device="meta", requires_grad=True)
        return x.view(0).grad_fn._sequence_nr()


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _nbytes(x) -> int:
    x = _local(x)
    return x.numel() * x.element_size()


def _in_propagation() -> bool:
    """Whether the op being dispatched is ``DTensor``'s sharding
    propagation running it on global-shape fakes (to learn the output's
    shape), not a device's computation."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


_NO_ACCESS = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "lift_fresh"}


class Census(TorchDispatchMode):
    """Counts the local (per-device) work of the ops run under it:
    ``DTensor`` ops run through :meth:`_dtensor_op` (re-entering this
    mode returns ``NotImplemented`` to ``DTensor``), whose local ops are
    counted.  ``flops``: matrix products by ``FlopCounterMode``'s
    formulas; ``bytes_accessed``: operand + result bytes of each op that is
    no view and no bare allocation; ``records``: collectives
    (``comm_stats.Record``); ``peak``: the most live bytes of op outputs
    at once (storages freed when their last tensor goes)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.records: list = []
        self.live: dict[int, list] = {}     # storage -> [bytes, weight]
        self.cur = self.peak = 0
        self.mult = 1           # copies each op stands for (sampled loops)
        self._saved: list[int] = []
        self._hooked: set[int] = set()
        self._inner = False

    def _dtensor_op(self, func, args, kwargs):
        """A ``DTensor`` op, run here so that its local ops re-enter this
        mode and are counted.  An op ``DTensor`` has no sharding strategy
        for raises, and the cell fails: nothing is re-laid out behind the
        model's back (the regions that need it are shard-local in the
        model code, ``sharding.shard_local``)."""
        self._inner = True
        try:
            with self:
                return func(*args, **kwargs)
        finally:
            self._inner = False

    def sample(self, step, carry, n: int):
        """``loops.scan`` of ``n`` identical steps: step 0 runs and counts
        once, step 1 runs and counts as the other n - 1 (its ops, and its
        nodes' backward, ``mult`` times more; what it leaves alive weighs
        n - 1 times its bytes), and the outputs of steps 2.. are step 1's,
        detached (no gradient flows into copies)."""
        carry, y0 = step(carry, 0)
        k = n - 1
        start = _node_mark()
        before = set(self.live)
        prev, self.mult = self.mult, self.mult * k
        try:
            carry, y1 = step(carry, 1)
        finally:
            self.mult = prev
        # step 1's survivors stand for n - 1 steps' (its output, what the
        # backward keeps), but for a carry that nothing keeps: the next
        # step's replaces it
        held = {t.untyped_storage()._cdata for t in _tensors(carry)
                if not t.requires_grad}
        kept = {t.untyped_storage()._cdata for t in _tensors(y1)}
        for key in (self.live.keys() - before - held) | (
                kept & self.live.keys()):
            rec = self.live[key]
            self.cur += rec[0] * rec[1] * (k - 1)
            rec[1] *= k
        self.peak = max(self.peak, self.cur)
        self._scale_backward((carry, y1), start, prev * k, k)
        return carry, [y0, y1] + [_detach(y1)] * (n - 2)

    def _scale_backward(self, outs, start: int, mult: int, k: int):
        """Count the backward of each autograd node made after ``start``
        (by one sampled step) ``mult`` times."""
        todo = [t.grad_fn for t in _tensors(outs) if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            nr = node._sequence_nr()
            if nr <= start or nr in seen:
                continue
            seen.add(nr)
            todo.extend(f for f, _ in node.next_functions if f is not None)
            if nr in self._hooked:     # an inner sampled loop's node
                continue
            self._hooked.add(nr)
            # edges out of the sampled steps: in the whole loop each
            # carries a gradient every step, which the engine adds into
            # its target's buffer (n - 1 adds where the sample makes 1)
            out = [i for i, (f, _) in enumerate(node.next_functions)
                   if f is not None and (type(f).__name__ == "AccumulateGrad"
                                         or f._sequence_nr() <= start)]

            def pre(grads, m=mult):
                self._saved.append(self.mult)
                self.mult = m

            def post(grads_in, grads_out, out=out, adds=mult - mult // k):
                self.mult = self._saved.pop()
                for i in out:
                    if grads_in[i] is not None:
                        self.bytes_accessed += 3 * adds * _nbytes(
                            grads_in[i])

            node.register_prehook(pre)
            node.register_hook(post)

    def _free(self, key):
        nbytes, weight = self.live.pop(key)
        self.cur -= nbytes * weight

    def _track(self, out):
        import weakref
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = [st.nbytes(), 1]
            self.cur += self.live[key][0]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._inner:
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        rec = comm_stats.record(func, args, out)
        if rec is not None:
            self.records.append(rec._replace(count=self.mult))
        else:
            packet = func._overloadpacket
            if packet in self._flops:
                self.flops += self.mult * self._flops[packet](
                    *args, **kwargs, out_val=out)
            if not func.is_view and packet.__name__ not in _NO_ACCESS:
                ins = list(_tensors((args, kwargs)))
                if ins:
                    self.bytes_accessed += self.mult * (
                        sum(map(_nbytes, ins))
                        + sum(map(_nbytes, _tensors(out))))
        if not func.is_view:
            self._track(out)
        return out


def _materialize(mesh, tree, placements):
    """Fake ``DTensor``s on ``mesh`` for a tree of meta tensors (under the
    active ``FakeTensorMode``): each device's local shard, nothing
    allocated."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(tree, torch.Tensor):
        shape = list(tree.shape)
        for size, p in zip(mesh.shape, placements):
            if isinstance(p, Shard):
                shape[p.dim] //= size
        local = torch.empty(shape, dtype=tree.dtype)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, dict):
        return {k: _materialize(mesh, v, placements[k]) for k, v in
                tree.items()}
    parts = [_materialize(mesh, v, p) for v, p in zip(tree, placements)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def count_cell(fn, args, placements, mesh) -> dict:
    """Run ``fn`` once on fake ``DTensor``s of ``args`` laid out by
    ``placements`` on ``mesh`` and count it (:class:`Census`).  The fakes
    are CPU tensors whatever the mesh's device (a CUDA mesh is described by
    a CPU mesh of the same ranks), so no kernel is launched.  Returns the
    record's count fields and the seconds the run took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    if mesh.device_type != "cpu":     # count on CPU fakes: no kernel runs
        mesh = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    with FakeTensorMode(allow_non_fake_inputs=True):
        dargs = _materialize(mesh, tuple(args), tuple(placements))
        arg_bytes = sum(map(_nbytes, _tensors(dargs)))
        census = Census()
        t0 = time.perf_counter()
        with implicit_replication(), census, loops.sampling(census.sample):
            out = fn(*dargs)
        run_s = time.perf_counter() - t0
        out_bytes = sum(map(_nbytes, _tensors(out)))
    colls = comm_stats.collective_stats(census.records)
    return {
        "flops": float(census.flops),
        "bytes_accessed": float(census.bytes_accessed),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": census.peak,
            "code_bytes": None,
        },
        "collectives": colls,
        **comm_stats.totals(colls),
        "run_s": run_s,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             cfg_override=None, tag: str = "", mesh=None) -> dict:
    cfg = cfg_override or configs.get(arch)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    t0 = time.perf_counter()
    fn, args, placements, _ = build_cell(cfg, shape_name, mesh)
    t_build = time.perf_counter() - t0
    counts = count_cell(fn, args, placements, mesh)
    period = _pattern_period(cfg) if cfg.n_layers else []
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "tag": tag,
        "n_layers": cfg.n_layers,
        "period_len": len(period) or 1,
        "n_periods": (cfg.n_layers // len(period)) if period else 0,
    }
    run_s = counts.pop("run_s")
    rec.update(counts)
    rec["lower_s"] = round(t_build, 2)
    rec["compile_s"] = round(run_s, 2)
    return rec


def depth_variants(cfg):
    """(tag, cfg) of 1 period and of 0 (the reference's roofline
    variants)."""
    period = len(_pattern_period(cfg))
    return [("L1", cfg.replace(n_layers=period)),
            ("L0", cfg.replace(n_layers=0))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="also run 1-period/0-period variants (roofline)")
    ap.add_argument("--depth", choices=("full", "L1", "L0"), default="full",
                    help="run only this depth: the full model, or its "
                         "1-period / 0-period variant")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = configs.all_cells()
    elif args.shape is None:        # every shape of one arch
        cells = [c for c in configs.all_cells() if c[0] == args.arch]
    else:
        cells = [(args.arch, args.shape)]
    if not cells:
        ap.error(f"no cell of arch {args.arch!r}")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    done: dict[str, dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            done = json.load(f)

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            jobs = [("full", None)]
            if args.variants and not mp:
                jobs += [(t, c) for t, c in
                         depth_variants(configs.get(arch))]
            if args.depth != "full":
                jobs = [(t, c) for t, c in depth_variants(configs.get(arch))
                        if t == args.depth]
            for tag, cfg_over in jobs:
                key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}|{tag}"
                if key in done:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   cfg_override=cfg_over, tag=tag)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    failures.append((key, str(e)[:500]))
                    continue
                if not args.quiet:
                    print(f"  flops={rec['flops']:.3e} "
                          f"bytes={rec['bytes_accessed']:.3e} "
                          f"coll_wire={rec['collective_wire_bytes']:.3e} "
                          f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
                          f"run={rec['compile_s']}s", flush=True)
                done[key] = rec
                with open(args.out, "w") as f:
                    json.dump(done, f, indent=1)

    print(f"[dryrun] completed {len(done)} records -> {args.out}")
    if failures:
        print("[dryrun] FAILURES:")
        for k, e in failures:
            print("  ", k, e)
        sys.exit(1)


if __name__ == "__main__":
    main()
