"""Divisibility-aware logical-axis sharding rules (FSDP × TP × SP).

The JAX package's ``repro/sharding/rules.py`` on ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.  Every tensor (params, activations, decode
states) carries *logical* axis names; this module resolves them to mesh
axes:

* weights: ``embed → data`` (FSDP: ZeRO-sharded storage, gathered at use),
  ``mlp/inner/heads/vocab → model`` (tensor parallel), with ``head_dim`` as
  the fallback when a head count doesn't divide the model axis (llama4's
  40 heads on a 16-way axis);
* activations: ``batch → (pod, data)``, ``seq → model`` between blocks
  (sequence parallelism);
* decode states: KV caches shard batch × (kv_heads | head_dim | seq).

Resolution is *greedy by priority with divisibility checks*: each
candidate (dim, mesh_axis) pair gets a priority; we sort and assign,
skipping any pair whose dim size isn't divisible by the mesh axis or
whose mesh axis / tensor dim is already taken.  Tensors that fit no rule
stay replicated: sharding never fails, it degrades.

A *mesh* here is anything with ``axis_names`` and ``shape`` (name →
size): :class:`MeshAxes` describes one without devices (the production
meshes' specs need none), and :func:`as_mesh` wraps a ``DeviceMesh``.
:func:`spec_for` returns a plain tuple with a JAX ``PartitionSpec``'s
entries (``None``, an axis name, or a tuple of names); :func:`placements`
turns it into ``Shard``/``Replicate`` per mesh dim for a ``DTensor``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# (mesh_axis, priority) candidates per logical axis; lower = stronger.
# "batch" expands to the (pod, data) super-axis at resolution time.
WEIGHT_RULES: dict[str, list[tuple[str, int]]] = {
    "vocab": [("model", 0)],
    "mlp": [("model", 1)],
    "inner": [("model", 1)],
    "heads": [("model", 2)],
    "kv_heads": [("model", 3)],
    "head_dim": [("model", 4)],
    "experts": [("model", 5)],          # engaged only if mlp/heads missed
    "embed": [("data", 6)],             # FSDP storage shard
    "embed2": [("data", 7)],
}

# decode/prefill state rules: cache *sequence* sharding beats head_dim —
# a head_dim-sharded cache forces an all-gather of the whole cache per
# step (the QK^T contraction is over head_dim); a seq-sharded cache only
# crosses shards in the tiny softmax reductions (flash-decoding layout).
STATE_RULES: dict[str, list[tuple[str, int]]] = {
    "batch": [("__batch__", 0)],
    "seq": [("model", 1)],
    "kv_heads": [("model", 2)],
    "head_dim": [("model", 3)],
    "heads": [("model", 2)],
    "inner": [("model", 2)],
    "embed": [("model", 9)],
}

# pure-FSDP training variant (§Perf): weights sharded over BOTH axes and
# gathered whole at use; activations batch-sharded only. Trades weight
# gathers (O(params)) for the TP activation gathers + dx all-reduces
# (O(tokens·d_model) per layer) — wins when tokens/device >> d_ff.
WEIGHT_RULES_FSDP2: dict[str, list[tuple[str, int]]] = {
    "embed": [(("data", "model"), 0)],
    "mlp": [(("data", "model"), 1)],
    "inner": [(("data", "model"), 1)],
    "vocab": [(("data", "model"), 2)],
    "experts": [(("data", "model"), 3)],
}

ACT_RULES_FSDP2: dict[str, list[tuple[str, int]]] = {
    "batch": [("__all__", 0)],     # DP over every mesh axis: the model
    "vocab": [("model", 1)],       # axis must not sit idle for compute
}

ACT_RULES: dict[str, list[tuple[str, int]]] = {
    "batch": [("__batch__", 0)],        # (pod, data) super-axis
    "heads": [("model", 1)],
    "kv_heads": [("model", 2)],
    "head_dim": [("model", 3)],
    "vocab": [("model", 1)],
    "mlp": [("model", 4)],
    "inner": [("model", 4)],
    "seq": [("model", 8)],              # SP: last resort for states,
    "embed": [("model", 9)],            # boundary constraint for resid
}


@dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names and sizes, without devices."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def as_mesh(mesh):
    """``mesh`` with ``axis_names`` and a name → size ``shape``: a
    ``DeviceMesh`` is described by its dim names and sizes; anything else
    is returned as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshAxes(tuple(names), tuple(mesh.shape))
    return mesh


def batch_axes(mesh) -> tuple[str, ...]:
    mesh = as_mesh(mesh)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(mesh, shape: tuple, axes: tuple,
             rules: dict[str, list[tuple[str, int]]]) -> tuple:
    """Resolve one tensor's logical axes to a spec: per tensor dim ``None``,
    a mesh axis name, or a tuple of names (a ``PartitionSpec``'s entries)."""
    mesh = as_mesh(mesh)
    if len(shape) != len(axes):
        raise ValueError(f"spec_for: shape {shape} and axes {axes} differ "
                         "in rank")
    cands = []
    for dim, name in enumerate(axes):
        if name is None:
            continue
        for mesh_axis, prio in rules.get(name, []):
            if mesh_axis == "__batch__":
                real = batch_axes(mesh)
            elif mesh_axis == "__all__":
                real = tuple(mesh.axis_names)
            else:
                real = mesh_axis
            if isinstance(real, str) and real not in mesh.axis_names:
                continue
            if not real:
                continue
            if isinstance(real, tuple) and len(real) == 1:
                real = real[0]      # 1-tuple != bare axis in PartitionSpec
            cands.append((prio, dim, real))
    cands.sort(key=lambda c: c[0])
    assignment: dict[int, object] = {}
    used: set[str] = set()
    for prio, dim, real in cands:
        flat = set(real) if isinstance(real, tuple) else {real}
        if dim in assignment or (flat & used):
            continue
        if shape[dim] % _axis_size(mesh, real) != 0:
            continue
        assignment[dim] = real
        used |= flat
    return tuple(assignment.get(d) for d in range(len(shape)))


def placements(mesh, spec: tuple) -> tuple:
    """A spec as ``DTensor`` placements, one per mesh dim: ``Shard(d)``
    where tensor dim ``d`` takes that mesh axis (a dim taken by a tuple of
    axes is sharded over each, in mesh order), else ``Replicate()`` (also
    on an axis of size 1, where the two hold the same)."""
    mesh = as_mesh(mesh)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner and mesh.shape[a] > 1
                 else Replicate() for a in mesh.axis_names)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(mesh, axes_tree, shape_tree, *, rules=None):
    """The placements of every leaf of ``shape_tree`` (anything with a
    ``shape``) from its logical axes in ``axes_tree`` (the same nested
    dicts, tuples of names at the leaves)."""
    rules = rules or WEIGHT_RULES
    if _is_axes(axes_tree):
        return placements(mesh, spec_for(mesh, tuple(shape_tree.shape),
                                         axes_tree, rules))
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(mesh, axes_tree[k], shape_tree[k],
                                  rules=rules) for k in axes_tree}
    return type(axes_tree)(tree_shardings(mesh, a, s, rules=rules)
                           for a, s in zip(axes_tree, shape_tree))


# ---------------------------------------------------------------------------
# Activation-constraint context (used inside model code; no-op off-mesh)
# ---------------------------------------------------------------------------

_CTX: dict | None = None


def set_mesh_ctx(mesh, rules=None, batch: int | None = None):
    global _CTX
    _CTX = None if mesh is None else {"mesh": mesh,
                                      "rules": rules or ACT_RULES,
                                      "unsplit": _unsplit(mesh, batch)}


def _unsplit(mesh, batch) -> bool:
    """Whether a global ``batch`` of several sequences is left unsplit on
    ``mesh``: it does not divide the (pod, data) extent, as
    :func:`spec_for` leaves such a dim whole.  A batch of one stays whole
    on every device anyway (``DTensor`` shards no dim shorter than its
    mesh axis), and its cells (``long_500k``) keep ``DTensor``'s own
    layouts."""
    if batch is None or batch < 2:
        return False
    names = batch_axes(as_mesh(mesh))
    return bool(names) and batch % _axis_size(as_mesh(mesh), names) != 0


class mesh_ctx:
    """``with mesh_ctx(mesh): ...`` enables activation constraints.

    ``batch``, the step's global batch, tells the context whether the
    batch is split over the (pod, data) axes.  When it is not (it does
    not divide their extent), products still contract over the weights'
    FSDP shards on those axes, and every partial sum they leave is
    reduced at once (:class:`_ReduceOverBatch`): the activations stay
    whole on the batch axes, as the reference's constraints on an unsplit
    batch keep them, and ``DTensor`` never reduce-scatters them into a
    split the rules do not give (an uneven batch, or the sequence over
    the batch axes, which a later row-merging view cannot take)."""

    def __init__(self, mesh, rules=None, *, batch: int | None = None):
        self.mesh, self.rules, self.batch = mesh, rules, batch

    def __enter__(self):
        self._prev = _CTX
        set_mesh_ctx(self.mesh, self.rules, self.batch)
        self._mode = _unsplit_mode()
        self._mode.__enter__()

    def __exit__(self, *exc):
        global _CTX
        self._mode.__exit__(*exc)
        _CTX = self._prev


class _ReduceOverBatch(torch.overrides.TorchFunctionMode):
    """Under an unsplit batch: each op's ``DTensor`` output that is a
    partial sum over a batch axis is reduced on it (all-reduce), and
    ``DTensor``'s sharding strategies take no uneven split (a partial mean
    it then resolves, e.g. a norm's over an embed split, is not turned
    into an uneven batch split; ``is_tensor_shardable`` of its strategy
    modules asks for even shards while the mode is on)."""

    def __enter__(self):
        from torch.distributed.tensor._ops import _matrix_ops, utils
        self._patched = [(m, m.is_tensor_shardable) for m in (utils,
                                                               _matrix_ops)
                         if hasattr(m, "is_tensor_shardable")]
        shardable = utils.is_tensor_shardable

        def even(shape, spec, *args, **kwargs):
            return shardable(shape, spec, *args, **kwargs) and \
                utils.is_tensor_evenly_shardable(shape, spec)
        for m, _ in self._patched:
            m.is_tensor_shardable = even
        return super().__enter__()

    def __exit__(self, *exc):
        for m, f in self._patched:
            m.is_tensor_shardable = f
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, DTensor) and _CTX is not None \
                and _CTX["unsplit"]:
            axes = as_mesh(out.device_mesh)
            names = batch_axes(axes)
            want = tuple(Replicate() if a in names and p.is_partial("sum")
                         else p for a, p in zip(axes.axis_names,
                                                out.placements))
            if want != tuple(out.placements):
                out = out.redistribute(out.device_mesh, want)
        return out


def _unsplit_mode():
    """The mode the mesh context runs in: the partial-sum reduction of an
    unsplit batch (:class:`mesh_ctx`), or nothing."""
    if _CTX is None or not _CTX["unsplit"]:
        return contextlib.nullcontext()
    return _ReduceOverBatch()


def remat_contexts():
    """``context_fn`` of the models' ``torch.utils.checkpoint`` calls: the
    forward runs in the caller's context, the recomputation (outside the
    forward's mode stack) in the mesh context's mode again."""
    return contextlib.nullcontext(), _unsplit_mode()


def axis_extent(name: str) -> int:
    """The size of the mesh context's axis ``name`` (1 without a mesh
    context or such an axis)."""
    if _CTX is None:
        return 1
    return as_mesh(_CTX["mesh"]).shape.get(name, 1)


def shard_act(x, axes: tuple):
    """Constrain an activation to its logical-axis sharding: a ``DTensor``
    is redistributed to the resolved placements (``with_sharding_constraint``
    of the reference); a plain tensor (no mesh context, or a one-device
    run) is returned unchanged."""
    if _CTX is None or not isinstance(x, DTensor):
        return x
    mesh = _CTX["mesh"]
    want = placements(mesh, spec_for(mesh, tuple(x.shape), axes,
                                     _CTX["rules"]))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_weights(tree, batch: int):
    """A block's parameters with their shards over the batch's mesh axes
    gathered (the (pod, data) axes; every axis under FSDP2's activation
    rules) when ``batch`` is split over them: FSDP's all-gather at use,
    explicit and differentiable, so the gradients come back
    reduce-scattered onto those shards.  Their tensor-parallel shards
    stay.  A batch too small to split (long_500k's one sequence) leaves
    the weights as they are, its products contracting over their shards.
    Plain tensors (no mesh context) are returned as they are."""
    if _CTX is None:
        return tree
    mesh = as_mesh(_CTX["mesh"])
    if _CTX["rules"].get("batch") == [("__all__", 0)]:
        axes = tuple(mesh.axis_names)
    else:
        axes = batch_axes(mesh)
    if not axes or batch % _axis_size(mesh, axes):
        return tree
    return _gather_over(tree, set(axes), mesh)


def _gather_over(tree, axes: set, mesh):
    if isinstance(tree, dict):
        return {k: _gather_over(v, axes, mesh) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    want = tuple(Replicate() if a in axes else p
                 for a, p in zip(mesh.axis_names, tree.placements))
    if want == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def batch_only(x):
    """``x`` with every shard off its batch dim (0) gathered and partial
    sums reduced: a product's input, as GSPMD all-gathers the
    sequence-parallel residual over ``model`` before a tensor-parallel
    product (``DTensor`` has no product strategy for rows sharded over two
    mesh axes).  A plain tensor is returned unchanged."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _BatchOnlyGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return batch_only(g)


def batch_only_grad(y):
    """``y``, with its gradient laid out by :func:`batch_only`: for the
    output of a product that joins the sequence-parallel residual, whose
    gradient arrives sequence-split (GSPMD's reduce-scatter into the
    residual has an all-gather for its backward, and the product's
    backward takes the batch-split rows its forward took).  A plain
    tensor, or one that needs no gradient, is returned unchanged."""
    if not (isinstance(y, DTensor) and y.requires_grad
            and torch.is_grad_enabled()):
        return y
    return _BatchOnlyGrad.apply(y)


def split_over_model(x, dim: int):
    """``x`` with ``dim`` split over the ``model`` axis where ``x`` is
    whole on it and the dim divides it: the layout GSPMD gives a product
    on a weight the rules leave whole over ``model`` (rwkv6's ``embed x
    embed2`` gate and the decay LoRA's input dim), so that each ``model``
    shard computes its share rather than the whole product.  A plain
    tensor, or one that cannot be so split, is returned unchanged."""
    if not isinstance(x, DTensor):
        return x
    names = as_mesh(x.device_mesh).axis_names
    if "model" not in names:
        return x
    i = names.index("model")
    m = x.device_mesh.shape[i]
    dim %= x.dim()
    if m == 1 or x.shape[dim] % m or not x.placements[i].is_replicate() \
            or dim in sharded_dims(x):
        return x
    want = list(x.placements)
    want[i] = Shard(dim)
    return x.redistribute(x.device_mesh, tuple(want))


def unsplit(x, dim: int):
    """``x`` with its shards along ``dim`` gathered (an explicit,
    differentiable redistribution: its gradient is split again).  A plain
    tensor is returned unchanged."""
    if not isinstance(x, DTensor) or dim % x.dim() not in sharded_dims(x):
        return x
    dim %= x.dim()
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def split_count(x, dim: int) -> int:
    """How many shards a ``DTensor`` is split into along ``dim`` (1 for a
    plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.dim()
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= size
    return n


def sharded_dims(x) -> set[int]:
    """The tensor dims a ``DTensor`` is sharded along (none for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return set()
    return {p.dim for p in x.placements if isinstance(p, Shard)}


def shard_local(fn, batch: int, in_dims: tuple, out_dims: tuple):
    """``fn`` run on each device's shard: the counterpart of the
    reference's regions that GSPMD keeps shard-local (MoE's group-local
    sort, gather and scatter; the Mamba and RWKV time loops, per batch
    shard and per channel or head shard), for ops ``DTensor`` has no
    sharding strategy for.

    ``in_dims[i]`` / ``out_dims[j]`` is the batch dim of ``fn``'s i-th
    argument / j-th output, or a pair ``(batch dim, dim split over
    model)`` (``None``: replicated, or not a tensor).  With a mesh context
    and ``DTensor`` arguments, each tensor argument is redistributed to
    its batch dim sharded over the (pod, data) axes (when ``batch`` divides
    by their extent, else replicated) and its model dim over ``model`` (a
    dim that does not divide by it raises), replicated over the rest;
    ``fn`` runs on the local tensors (a plain tensor argument is taken as
    replicated) and its outputs come back as ``DTensor``s so laid out.
    Otherwise ``fn(*args)``."""
    def run(*args):
        if _CTX is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
        axes = as_mesh(mesh)
        names = batch_axes(axes)
        split = bool(names) and batch % _axis_size(axes, names) == 0
        m = axes.shape.get("model", 1)

        def pl(dims):
            b, md = dims if isinstance(dims, tuple) else (dims, None)
            return tuple(
                Shard(b) if split and b is not None and a in names
                and axes.shape[a] > 1
                else Shard(md) if a == "model" and md is not None and m > 1
                else Replicate() for a in axes.axis_names)

        for a, d in zip(args, in_dims):
            md = d[1] if isinstance(d, tuple) else None
            if md is not None and isinstance(a, torch.Tensor) \
                    and a.shape[md] % m:
                raise ValueError(f"shard_local: dim {md} of {tuple(a.shape)}"
                                 f" does not divide the model axis ({m})")
        args = [DTensor.from_local(a, mesh, pl(None), run_check=False)
                if isinstance(a, torch.Tensor)
                and not isinstance(a, DTensor) else a for a in args]
        in_pl = tuple(pl(d) if isinstance(a, torch.Tensor) else None
                      for a, d in zip(args, in_dims))
        out_pl = tuple(pl(d) for d in out_dims)
        return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    return run


def _shard_span(mesh, pl, dim: int, length: int) -> tuple[int, int]:
    """(offset, size) along ``dim`` of this rank's shard of a tensor laid
    out by ``pl`` on ``mesh`` (even shards, split in mesh-dim order)."""
    size, off = length, 0
    for n, c, p in zip(mesh.shape, mesh.get_coordinate(), pl):
        if isinstance(p, Shard) and p.dim == dim:
            size //= n
            off += c * size
    return off, size


def gather_rows(table, idx):
    """``table[idx]``.  On a ``DTensor`` table the lookup is row-parallel,
    as GSPMD partitions a gather from a vocab-sharded embedding: each
    device looks up the rows it holds (its columns gathered first), zeros
    the others, and the result is a partial sum over the mesh axes that
    shard the rows; ``idx`` keeps its batch sharding."""
    if not isinstance(table, DTensor):
        return table[idx]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    tpl = tuple(Shard(0) if r else Replicate() for r in rows)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    ipl = tuple(Replicate() if r or not isinstance(p, Shard) else p
                for r, p in zip(rows, idx.placements))
    opl = tuple(Partial() if r else p for r, p in zip(rows, ipl))
    n_rows = table.shape[0]

    def local(t, i):
        off, size = _shard_span(mesh, tpl, 0, n_rows)
        j = i - off
        ok = (j >= 0) & (j < size)
        return t[torch.where(ok, j, 0)] * ok[..., None].to(t.dtype)
    return local_map(local, out_placements=(opl,), in_placements=(tpl, ipl),
                     device_mesh=mesh, redistribute_inputs=True)(table, idx)


def take_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]``.  On a ``DTensor``
    whose last dim is split (vocab-sharded logits) each device picks the
    indices it holds and zeros the others: a partial sum over the mesh axes
    that split it, as GSPMD partitions the gather; ``idx`` keeps its other
    shards."""
    last = x.dim() - 1
    if last not in sharded_dims(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    cols = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    xpl = tuple(p if isinstance(p, Shard) else Replicate()
                for p in x.placements)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    ipl = tuple(Replicate() if c else p for c, p in zip(cols, xpl))
    opl = tuple(Partial() if c else p for c, p in zip(cols, ipl))
    n_cols = x.shape[last]

    def local(t, i):
        off, size = _shard_span(mesh, xpl, last, n_cols)
        j = i - off
        ok = (j >= 0) & (j < size)
        got = torch.gather(t, -1, torch.where(ok, j, 0)[..., None])[..., 0]
        return got * ok.to(t.dtype)
    return local_map(local, out_placements=(opl,), in_placements=(xpl, ipl),
                     device_mesh=mesh, redistribute_inputs=True)(x, idx)


def write_index(buf, dim: int, index: int, val) -> None:
    """``buf[:, ..., index] = val`` along ``dim``, in place.  On a
    ``DTensor`` each device writes its local shard where ``index`` falls in
    it (``val`` redistributed to ``buf``'s layout less ``dim``), as the
    reference's ``dynamic_update_slice`` of a sharded cache does; a
    ``DTensor``'s own ``__setitem__`` on a sharded dim writes a copy."""
    at = (slice(None),) * dim + (index,)
    if not isinstance(buf, DTensor):
        buf[at] = val
        return
    mesh, pl = buf.device_mesh, buf.placements
    off, size = _shard_span(mesh, pl, dim, buf.shape[dim])
    if isinstance(val, DTensor):
        vpl = tuple(
            p if not isinstance(p, Shard)
            else Replicate() if p.dim == dim
            else Shard(p.dim - (p.dim > dim)) for p in pl)
        val = val.redistribute(mesh, vpl).to_local()
    i = index - off
    if 0 <= i < size:
        buf.to_local()[(slice(None),) * dim + (i,)] = val


# ---------------------------------------------------------------------------
# Decode-state logical axes (path-pattern based)
# ---------------------------------------------------------------------------

_STATE_PATTERNS = [
    # (suffix key name, rank) -> logical axes
    ("k", 4, ("batch", "seq", "kv_heads", "head_dim")),
    ("v", 4, ("batch", "seq", "kv_heads", "head_dim")),
    ("slot_pos", 1, ("seq",)),
    ("h", 3, ("batch", "inner", "state")),
    ("conv", 3, ("batch", None, "inner")),
    ("s", 4, ("batch", "heads", "head_dim", None)),
    ("x_tmix", 2, ("batch", "embed")),
    ("x_cmix", 2, ("batch", "embed")),
    ("mlp", 2, ("batch", "embed")),      # cmix token-shift state
]


def _leaf_axes(key, rank: int) -> tuple:
    for name, r, ax in _STATE_PATTERNS:
        if key == name and rank == r + 1:      # +1: stacked periods
            return ("layers",) + ax
        if key == name and rank == r:
            return ax
    return (None,) * rank


def state_axes(state_tree, key=None):
    """Logical axes for a decode-state tree (nested dicts of tensors; a
    leading 'layers' dim is added for the stacked-period dimension)."""
    if isinstance(state_tree, dict):
        return {k: state_axes(v, k) for k, v in state_tree.items()}
    return _leaf_axes(key, len(state_tree.shape))
